"""Compiled programs: the counterpart of ``jax.jit`` as the JAX package and
its callers use it, as captured CUDA graphs.

A ``Program`` wraps ``fn(*args)``, whose arguments are tensors or nests
(dicts, lists, tuples) of tensors, and whose result is a tensor or a nest
of them. On CUDA tensors:

* the first call allocates static input buffers of the arguments' shapes
  and dtypes, runs ``fn`` on them eagerly on a side stream (the warm-up,
  which fills every host-side cache: ``core/hoist.py``, the kernel
  library, the envmap's frozen tables; a gradient program runs it three
  times, so that the autograd engine has set up its device thread and
  streams), and captures ``fn`` on them into a ``torch.cuda.CUDAGraph``
  with its own memory pool: under ``torch.no_grad()``, or with
  ``grad=True`` under ``torch.enable_grad()``, where the body takes
  gradients itself (``value_and_grad``) and they live in the pool, at the
  same addresses on every replay. Then it replays, as every later call
  does;
* a call copies its arguments into the buffers, replays the graph and
  returns clones of the static outputs, detached, so a caller never holds
  a tensor that the next replay overwrites;
* a call whose arguments differ from the first call's in structure,
  shape, dtype or device raises; nothing captures again behind the
  caller's back. The one declared exception is ``retrace_on``, a function
  of no arguments whose value the capture records (a scene's
  ``accel_version``): where it has changed at a call, the program drops
  its graph and captures again, as JAX retraces a program whose static
  state changed (``psdr_tpu/scene/scene.py:266-272``), so that a replay
  never reads a tensor of a rebuilt BVH topology;
* a capture that fails raises, and so does every later call: a program
  never runs ``fn`` eagerly instead.

On CPU tensors, which have no graphs, a call runs ``fn`` under the same
grad mode and detaches its result: the only eager path, reached only by
asking for the CPU. The first call's signature binds there too.

``VJPProgram`` splits a differentiable function into two graphs around
what cannot be captured between its forward and its backward (a gloo
collective): the forward, whose saved tensors stay in the pool, and the
vector-Jacobian product fed a cotangent.

A replay launches the captured kernels without running the Python wrappers
that count them, so a program records what its capture added to
``accel.intersect.LAUNCHES``, takes it back (a capture launches nothing)
and adds it on every replay.

``capture_seconds``, ``nodes`` (the graph's node count) and
``pool_bytes`` (the device memory of its private pool) report on the
capture. Dropping a program frees its graph and its pool.

What a body reads outside its pool must live as long as the graph: a
program holds every cached tensor that its capture was handed
(``core/hoist.py`` ``holding``: the film's tables, a topology's uploads,
the envmap's frozen importance table), until it drops the graph, however
the caches evict them meanwhile. On the CPU it holds its last call's.
"""
from __future__ import annotations

import ctypes
import gc
import time

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from .accel.intersect import LAUNCHES
from .core.hoist import holding


def _signature(leaves, spec, name: str):
    for x in leaves:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name}: every argument is a tensor or a nest "
                            f"of tensors, got {type(x).__name__}")
    if not leaves:
        raise TypeError(f"{name} takes at least one tensor")
    devices = {x.device for x in leaves}
    if len(devices) != 1:
        raise ValueError(f"{name}: the arguments lie on "
                         f"{sorted(map(str, devices))}, not on one device")
    return spec, tuple((tuple(x.shape), x.dtype, x.device) for x in leaves)


def _graph_nodes(raw_graph: int) -> int:
    """The node count of a ``cudaGraph_t`` (``cuGraphGetNodes`` of
    ``libcuda``)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_size_t)]
    cuda.cuGraphGetNodes.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    err = cuda.cuGraphGetNodes(raw_graph, None, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes returned {err}")
    return n.value


def _grad_mode(grad: bool):
    return torch.enable_grad() if grad else torch.no_grad()


def _detached(out):
    leaves, spec = tree_flatten(out)
    return tree_unflatten([x.detach() if isinstance(x, torch.Tensor) else x
                           for x in leaves], spec)


def _tensor_leaves(out, name: str):
    leaves, spec = tree_flatten(out)
    if not all(isinstance(x, torch.Tensor) for x in leaves):
        raise TypeError(f"{name} returns tensors or nests of them")
    return [x.detach() for x in leaves], spec


def _warm_up(dev, body, times: int) -> None:
    """``body()`` ``times`` times on a side stream, eagerly."""
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(times):
            body()
    torch.cuda.current_stream(dev).wait_stream(side)


def _capture(dev, body, pool=None):
    """``body()`` captured into a new graph (in ``pool``, or a pool of its
    own) and instantiated: (graph, body's result, the launch counts the
    capture recorded, graph nodes). The counts are taken back from
    ``LAUNCHES`` whether or not the capture succeeds.

    Python's cyclic garbage is collected before the capture and not during
    it: a program caught in a reference cycle (an integrator and its
    program cache) frees its graph when the collector reaches it, and a
    graph freed while a stream captures invalidates that capture."""
    before = dict(LAUNCHES)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    gc.collect()
    gc_was_on = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.device(dev), torch.cuda.graph(graph, pool=pool):
            out = body()
        nodes = _graph_nodes(graph.raw_cuda_graph())
        graph.instantiate()
    finally:
        if gc_was_on:
            gc.enable()
        launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        LAUNCHES.update(before)
    return graph, out, launches, nodes


def _pool_bytes(graph) -> int:
    pool = tuple(graph.pool())
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == pool)


def value_and_grad(fn, argnums: int = 0):
    """``jax.value_and_grad(fn, argnums)``: ``f(*args) -> (value,
    grads)``, ``grads`` shaped as argument ``argnums`` (a tensor or a nest
    of float tensors), a leaf the value does not depend on getting zeros.
    The argument's leaves are detached and made to require grad inside, so
    ``Program(value_and_grad(loss), grad=True)`` is ``jax.jit(
    jax.value_and_grad(loss))``; ``value`` comes back detached."""
    def vg(*args):
        leaves, spec = tree_flatten(args[argnums])
        live = [x.detach().requires_grad_(True) for x in leaves]
        args = (args[:argnums] + (tree_unflatten(live, spec),)
                + args[argnums + 1:])
        value = fn(*args)
        grads = torch.autograd.grad(value, live, allow_unused=True)
        return value.detach(), tree_unflatten(
            [torch.zeros_like(x) if g is None else g
             for x, g in zip(live, grads)], spec)
    return vg


class Program:
    """``fn`` captured once as a CUDA graph and replayed (module
    docstring). ``grad=True`` captures under ``torch.enable_grad()``;
    ``retrace_on`` names the state whose change drops the graph."""

    def __init__(self, fn, name: str = "program", grad: bool = False,
                 retrace_on=None):
        self.fn = fn
        self.name = name
        self.grad = grad
        self.retrace_on = retrace_on
        self._stamp = None
        self._sig = None
        self._graph = None
        self._inputs = None
        self._outputs = None
        self._launches: dict = {}
        self._held: dict = {}             # hoist's tensors the graph reads
        self._error: BaseException | None = None
        self.captures = 0
        self.capture_seconds: float | None = None
        self.nodes: int | None = None
        self.pool_bytes: int | None = None

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def stale(self) -> bool:
        """Whether ``retrace_on`` has changed since the last call (the
        graph, if any, was captured at that call's value or before)."""
        return (self._sig is not None and self.retrace_on is not None
                and self.retrace_on() != self._stamp)

    def _bind(self, args):
        """Check ``args`` against the first call's signature and
        ``retrace_on`` (dropping a stale graph): (leaves, spec, device)."""
        leaves, spec = tree_flatten(args)
        sig = _signature(leaves, spec, self.name)
        if self._sig is None:
            self._sig = sig
        elif sig != self._sig:
            raise ValueError(f"{self.name} was built for arguments "
                             f"{self._sig[1]} and is called with {sig[1]}")
        if self.retrace_on is not None:
            stamp = self.retrace_on()
            if stamp != self._stamp:
                self._drop()
            self._stamp = stamp
        dev = leaves[0].device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"{self.name} runs on CUDA or CPU tensors, "
                             f"not {dev}")
        if dev.type == "cuda" and self._error is not None:
            raise RuntimeError(f"{self.name}: its capture failed; it does "
                               "not run eagerly") from self._error
        return leaves, spec, dev

    def _drop(self) -> None:
        """Free the graph, if any, so that the next call captures anew."""
        if self._graph is not None:
            self._graph.reset()
        self._graph = self._outputs = None
        self._held = {}

    def _load(self, leaves) -> None:
        """Copy the arguments into the static input buffers (made at the
        first call)."""
        with torch.no_grad():
            if self._inputs is None:
                self._inputs = [x.detach().clone() for x in leaves]
            else:
                for buf, x in zip(self._inputs, leaves):
                    buf.copy_(x)

    def _replay(self, graph, launches) -> None:
        graph.replay()
        for k, v in launches.items():
            LAUNCHES[k] += v

    def _capture_or_fail(self, dev, body, pool=None):
        """``_capture(dev, body, pool)``; a failure raises, for good."""
        try:
            with holding() as held:
                out = _capture(dev, body, pool)
            self._held.update(held)
            return out
        except Exception as e:
            self._error = e
            raise RuntimeError(f"the capture of {self.name} failed; it does "
                               "not run eagerly") from e

    def __call__(self, *args):
        leaves, spec, dev = self._bind(args)
        if dev.type == "cpu":
            with _grad_mode(self.grad), holding() as self._held:
                return _detached(self.fn(*args))
        self._load(leaves)
        if self._graph is None:
            self._capture(spec, dev)
        self._replay(self._graph, self._launches)
        out, out_spec = self._outputs
        return tree_unflatten([x.clone() for x in out], out_spec)

    def _body(self, spec):
        with _grad_mode(self.grad):
            return self.fn(*tree_unflatten(self._inputs, spec))

    def _capture(self, spec, dev) -> None:
        _warm_up(dev, lambda: self._body(spec), 3 if self.grad else 1)
        t0 = time.perf_counter()
        graph, out, self._launches, self.nodes = self._capture_or_fail(
            dev, lambda: _tensor_leaves(self._body(spec), self.name))
        torch.cuda.synchronize(dev)
        self.capture_seconds = time.perf_counter() - t0
        self.pool_bytes = _pool_bytes(graph)
        self.captures += 1
        self._graph, self._outputs = graph, out


class VJPProgram(Program):
    """``fn(x, *rest) -> y`` (a tensor) and its vector-Jacobian product in
    ``x`` (a tensor or a nest of float tensors) as two graphs in one pool:
    ``y = prog(x, *rest)`` replays the forward, which rewrites in place the
    tensors its backward saved; ``prog.vjp(cot)`` replays the backward on
    ``cot`` (shaped as y) and returns the gradient nest of x (zeros for a
    leaf y does not depend on). A ``vjp`` belongs to the forward before it.
    What runs between the two (a gloo all-reduce of y, which copies
    through the host) stays eager. The signature binds as a
    ``Program``'s; a failed capture raises for good. On CPU tensors both
    halves run eagerly under autograd. ``nodes`` and ``capture_seconds``
    count both graphs; ``retrace_on`` drops both as a ``Program``'s."""

    def __init__(self, fn, name: str = "vjp program", retrace_on=None):
        super().__init__(fn, name, retrace_on=retrace_on)
        self._cot = None                  # the backward's static cotangent
        self._bwd = None
        self._bwd_launches: dict = {}
        self._grads = None
        self._saved = None                # (y, live leaves, x's spec)

    @property
    def captured(self) -> bool:
        return self._bwd is not None

    def _drop(self) -> None:
        if self._bwd is not None:
            self._bwd.reset()
        super()._drop()
        self._bwd = self._saved = self._cot = self._grads = None

    def _forward(self, leaves, spec):
        x, *rest = tree_unflatten(leaves, spec)
        x_leaves, x_spec = tree_flatten(x)
        live = [v.detach().requires_grad_(True) for v in x_leaves]
        with torch.enable_grad():
            y = self.fn(tree_unflatten(live, x_spec), *rest)
        return y, live, x_spec

    @staticmethod
    def _backward(saved, cot, retain: bool):
        y, live, x_spec = saved
        grads = torch.autograd.grad(y, live, cot, allow_unused=True,
                                    retain_graph=retain)
        return tree_unflatten([torch.zeros_like(x) if g is None else g
                               for x, g in zip(live, grads)], x_spec)

    def __call__(self, *args):
        leaves, spec, dev = self._bind(args)
        if dev.type == "cpu":
            with holding() as self._held:
                self._saved = self._forward(leaves, spec)
            return self._saved[0].detach()
        self._load(leaves)
        if self._bwd is None:
            self._capture(spec, dev)
        self._replay(self._graph, self._launches)
        return self._saved[0].detach().clone()

    def vjp(self, cot: torch.Tensor):
        if self._saved is None:
            raise RuntimeError(f"{self.name}: vjp before a forward")
        if cot.device.type == "cpu":
            saved, self._saved = self._saved, None
            return self._backward(saved, cot, retain=False)
        self._cot.copy_(cot)
        self._replay(self._bwd, self._bwd_launches)
        grads, g_spec = self._grads
        return tree_unflatten([g.clone() for g in grads], g_spec)

    def _capture(self, spec, dev) -> None:
        def warm():
            saved = self._forward(self._inputs, spec)
            self._backward(saved, torch.ones_like(saved[0]), retain=False)
        _warm_up(dev, warm, 3)
        t0 = time.perf_counter()
        fgraph, saved, self._launches, nodes = self._capture_or_fail(
            dev, lambda: self._forward(self._inputs, spec))
        self._cot = torch.zeros_like(saved[0])
        bgraph, grads, launches, bnodes = self._capture_or_fail(
            dev, lambda: _tensor_leaves(
                self._backward(saved, self._cot, retain=True), self.name),
            pool=fgraph.pool())
        self._grads, self._bwd_launches = grads, launches
        torch.cuda.synchronize(dev)
        self.capture_seconds = time.perf_counter() - t0
        self.nodes = nodes + bnodes
        self.pool_bytes = _pool_bytes(fgraph)
        self.captures += 1
        self._graph, self._bwd, self._saved = fgraph, bgraph, saved
