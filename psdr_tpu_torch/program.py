"""Compiled programs: the counterpart of ``jax.jit`` as the JAX package and
its callers use it, as captured CUDA graphs.

A ``Program`` wraps ``fn(*args)``, whose arguments are tensors or nests
(dicts, lists, tuples) of tensors, and whose result is a tensor or a nest
of them. On CUDA tensors:

* the first call runs ``fn`` eagerly on a side stream (the warm-up, which
  fills every host-side cache: ``core/hoist.py``, the kernel library, the
  envmap's frozen tables), allocates static input buffers of the
  arguments' shapes and dtypes, and captures ``fn`` on them under
  ``torch.no_grad()`` into a ``torch.cuda.CUDAGraph`` with its own memory
  pool. Then it replays, as every later call does;
* a call copies its arguments into the buffers, replays the graph and
  returns clones of the static outputs, so a caller never holds a tensor
  that the next replay overwrites;
* a call whose arguments differ from the first call's in structure,
  shape, dtype or device raises; nothing captures again behind the
  caller's back;
* a capture that fails raises, and so does every later call: a program
  never runs ``fn`` eagerly instead.

On CPU tensors, which have no graphs, a call runs ``fn`` under
``torch.no_grad()``: the only eager path, reached only by asking for the
CPU. The first call's signature binds there too.

A replay launches the captured kernels without running the Python wrappers
that count them, so a program records what its capture added to
``accel.intersect.LAUNCHES``, takes it back (a capture launches nothing)
and adds it on every replay.

``capture_seconds``, ``nodes`` (the graph's node count) and
``pool_bytes`` (the device memory of its private pool) report on the
capture. Dropping a program frees its graph and its pool.
"""
from __future__ import annotations

import ctypes
import time

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from .accel.intersect import LAUNCHES


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


class Program:
    """``fn`` captured once as a CUDA graph and replayed (module
    docstring)."""

    def __init__(self, fn, name: str = "program"):
        self.fn = fn
        self.name = name
        self._sig = None
        self._graph = None
        self._inputs = None
        self._outputs = None
        self._launches: dict = {}
        self._error: BaseException | None = None
        self.capture_seconds: float | None = None
        self.nodes: int | None = None
        self.pool_bytes: int | None = None

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def __call__(self, *args):
        leaves, spec = tree_flatten(args)
        sig = _signature(leaves, spec, self.name)
        if self._sig is None:
            self._sig = sig
        elif sig != self._sig:
            raise ValueError(f"{self.name} was built for arguments "
                             f"{self._sig[1]} and is called with {sig[1]}")
        dev = leaves[0].device
        if dev.type == "cpu":
            with torch.no_grad():
                return self.fn(*args)
        if dev.type != "cuda":
            raise ValueError(f"{self.name} runs on CUDA or CPU tensors, "
                             f"not {dev}")
        if self._error is not None:
            raise RuntimeError(f"{self.name}: its capture failed; it does "
                               "not run eagerly") from self._error
        if self._graph is None:
            self._capture(leaves, spec, dev)
        for buf, x in zip(self._inputs, leaves):
            buf.copy_(x)
        self._graph.replay()
        for k, v in self._launches.items():
            LAUNCHES[k] += v
        out, out_spec = self._outputs
        return tree_unflatten([x.clone() for x in out], out_spec)

    def _capture(self, leaves, spec, dev) -> None:
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), torch.no_grad():
            self.fn(*tree_unflatten(leaves, spec))
        torch.cuda.current_stream(dev).wait_stream(side)
        inputs = [x.clone() for x in leaves]
        before = dict(LAUNCHES)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        try:
            with torch.cuda.device(dev), torch.cuda.graph(graph), \
                    torch.no_grad():
                out = self.fn(*tree_unflatten(inputs, spec))
            out_leaves, out_spec = tree_flatten(out)
            if not all(isinstance(x, torch.Tensor) for x in out_leaves):
                raise TypeError(f"{self.name} returns tensors or nests of "
                                "them")
            self.nodes = _graph_nodes(graph.raw_cuda_graph())
            graph.instantiate()
        except Exception as e:
            self._error = e
            raise RuntimeError(f"the capture of {self.name} failed; it does "
                               "not run eagerly") from e
        finally:
            self._launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            LAUNCHES.update(before)
        torch.cuda.synchronize(dev)
        self.capture_seconds = time.perf_counter() - t0
        pool = tuple(graph.pool())
        self.pool_bytes = sum(
            s["total_size"] for s in torch.cuda.memory_snapshot()
            if tuple(s.get("segment_pool_id", ())) == pool)
        self._graph, self._inputs = graph, inputs
        self._outputs = (out_leaves, out_spec)
