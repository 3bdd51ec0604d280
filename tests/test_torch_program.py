"""The compiled programs on the CPU (``psdr_tpu_torch/program.py``, the
integrators' program cache ``_jit_radiance_call``, ``grad_program``, the
optimizer's update, the guiding builds, the flagship's step and the
harness's derivative image).

* A capture rehearsal: a CUDA graph capture refuses every host read of a
  tensor and every tensor made from host data (the copy synchronizes).
  ``HostReadGuard`` fails on both, and ``HostSyncGuard`` on the ATen ops
  that read back (``_local_scalar_dense``, ``is_nonzero``, ``nonzero``)
  wherever they run, the backward that the autograd engine runs included,
  so a program body that passes under both (after one warm-up call that
  fills the caches, with its key in the tensor-word mode) is one the card
  can capture. The plain versions of the kernels run unguarded: on the
  card the kernels launch in their place. Bodies: the forward
  configurations of ``chip_smoke.py`` phase 28 (a-d, shrunk) and
  ``PathTracer(2, camera_depth=2)``'s renderD primal, each guarded image
  equal to the host-key render bit for bit; and the gradient programs of
  phase 29, forward and backward, each output equal to the host-key
  call's bit for bit; the same bodies on a scene whose queries run K1
  (``accel_mode="pallas"``, as "auto" on the card), so that the direction
  sort, the compacted sweeps and their residue sweeps are rehearsed; and
  the sharded and example programs: ``inverse_geometry``'s ``step_grad``,
  the sharded step whole, its split form's forward, backward and update,
  and the multi-view step's local program.
* A program keeps what its capture read from the host caches: the
  envmap's frozen table outlives the cache's eviction while the program
  lives.
* A rebuilt BVH topology makes a program over a scene build stale: its
  body then reads new host data (the guard fails) until the recapture's
  warm-up has run, after which it equals a fresh program's step.
* Parity of ``grad_program`` with ``jax.jit(jax.value_and_grad)`` of the
  same loss, leaf by leaf.
* Parity: renderC and renderD through the port's program cache against
  the JAX package's (through its own ``_jit_radiance_call``) at the same
  seed: at least 99% of pixels allclose (rtol 1e-4, atol 1e-5), means to
  1e-4, as tests/test_torch_render.py holds them.
* The cache keys as the JAX package's does, and a ``Program`` on CPU
  tensors runs eagerly and raises on arguments of another signature.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

import psdr_tpu as J
import psdr_tpu_torch as T
from psdr_tpu_torch.accel import intersect
from psdr_tpu_torch.convert import params_from_numpy
from psdr_tpu_torch.core import threefry
from psdr_tpu_torch.examples import flagship_recovery
from psdr_tpu_torch.opt import (Optimizer, adam, exponential_decay, masked,
                                sgd, tree_map)
from psdr_tpu_torch.parallel import (make_multiview_train_step,
                                     make_train_step)
from psdr_tpu_torch.program import Program, VJPProgram, value_and_grad
from psdr_tpu_torch.testing import harness, ranks
from psdr_tpu_torch.testing import scenes as t_scenes

from scenes import cbox_scene as j_cbox
from test_torch_envmap import _pair
from test_torch_grad import _assert_grads_match, _leaves

torch.set_num_threads(2)

CPU = dict(device="cpu")     # the port defaults to the card

_HOST_READS = {torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.__bool__,
               torch.Tensor.__int__, torch.Tensor.__float__,
               torch.Tensor.__index__, torch.Tensor.__array__,
               torch.Tensor.numpy, torch.Tensor.cpu, torch.Tensor.nonzero,
               torch.nonzero, torch.unique, torch.masked_select,
               torch.tensor}


class HostReadGuard(TorchFunctionMode):
    """Fails on a host read of a tensor (``item``, ``tolist``,
    ``__bool__``, ``__int__``, ``__float__``, ``__index__``, ``numpy``,
    ``cpu``, a boolean-mask index, ``nonzero``) and on a tensor made from
    host data (``torch.tensor``, ``as_tensor`` of non-tensor data; the
    rehearsal replaces ``torch.from_numpy``, which modes do not see)."""

    def __init__(self):
        super().__init__()
        self.paused = False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if not self.paused:
            bad = func in _HOST_READS
            if func is torch.as_tensor:
                bad = not isinstance(args[0], torch.Tensor)
            if func is torch.Tensor.__getitem__:
                idx = args[1] if isinstance(args[1], tuple) else (args[1],)
                bad = any(isinstance(i, torch.Tensor)
                          and i.dtype == torch.bool for i in idx)
            if bad:
                raise AssertionError("a host read or a tensor from host "
                                     f"data in a program body: {func}")
        return func(*args, **(kwargs or {}))


_HOST_OPS = {torch.ops.aten._local_scalar_dense, torch.ops.aten.is_nonzero,
             torch.ops.aten.nonzero}


class HostSyncGuard(TorchDispatchMode):
    """Fails on an ATen op that reads a tensor back to the host, seen
    where the autograd engine runs it too (a ``TorchFunctionMode`` sees
    only the Python calls); paused with ``guard``."""

    def __init__(self, guard: HostReadGuard):
        super().__init__()
        self.guard = guard

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.guard.paused and func.overloadpacket in _HOST_OPS:
            raise AssertionError(f"a host read in a program body: {func}")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def rehearsal(monkeypatch):
    """Tensor-word keys under ``HostReadGuard`` and ``HostSyncGuard``; the
    kernels' plain versions unguarded."""
    guard = HostReadGuard()

    def unguarded(fn):
        def run(*a, **k):
            guard.paused = True
            try:
                return fn(*a, **k)
            finally:
                guard.paused = False
        return run

    def from_numpy(*a, **k):
        raise AssertionError("torch.from_numpy in a program body")

    with monkeypatch.context() as m:
        for name in ("k1_plain", "brute_plain"):
            m.setattr(intersect, name, unguarded(getattr(intersect, name)))
        m.setattr(torch, "from_numpy", from_numpy)
        with threefry.tensor_words(), guard, HostSyncGuard(guard):
            yield


class _ReadsInBackward(torch.autograd.Function):
    """Doubles its input; its backward reads the cotangent's sum back."""

    @staticmethod
    def forward(ctx, x):
        return x * 2.0

    @staticmethod
    def backward(ctx, g):
        return g * (2.0 if g.sum().item() != 0.0 else 0.0)


def test_guard_fails_on_host_reads(monkeypatch):
    """The rehearsal is not vacuous: each kind of host access fails, a
    read inside a custom Function's backward and the ATen ops that read
    back among them."""
    x = torch.arange(4.0)
    w = torch.ones(4, requires_grad=True)
    cases = [lambda: x.sum().item(), lambda: bool(x[0] > 0),
             lambda: x[x > 1.0], lambda: x.tolist(),
             lambda: torch.tensor([1.0]), lambda: torch.as_tensor([1.0]),
             lambda: torch.from_numpy(np.zeros(2)),
             lambda: threefry.PRNGKey(0),
             lambda: torch.autograd.grad(_ReadsInBackward.apply(w).sum(), w),
             lambda: torch.ops.aten.nonzero(x),
             lambda: torch.ops.aten.is_nonzero(x[:1])]
    for case in cases:
        with rehearsal(monkeypatch), pytest.raises(AssertionError):
            case()
    with rehearsal(monkeypatch):     # device work on tensors passes
        assert (x * 2 + torch.as_tensor(x)).shape == (4,)
        (g,) = torch.autograd.grad((w * x).sum(), w)
        assert torch.equal(g, x)


def _cbox(size, mode="auto", **kw):
    sc = t_scenes.cbox_scene(size, size, occluder_subdiv=3, **kw, **CPU)
    sc.accel_mode = mode
    return sc


def _k1_mode(case, monkeypatch):
    """The accel_mode of a rehearsal ``case``: "pallas" (K1, the card's
    "auto") for a case named so, with visibility reuse on, whose second
    sweep is compacted to a quarter."""
    if not case.endswith("pallas"):
        return "auto"
    monkeypatch.setenv("PSDR_TPU_VIS_REUSE", "edge")
    return "pallas"


def _body(case, mode="auto"):
    """(the program of ``case`` after its first call, which is the warm-up
    that fills the caches, its argument tuple, that call's host-key
    image)."""
    key = threefry.PRNGKey(3)
    if case[0] in ("a", "b"):
        sc = _cbox(32 if case[0] == "a" else 16, mode, spp=2)
        integ = (T.DirectIntegrator(1, 1) if case[0] == "a"
                 else T.PathTracer(3))
        prog = integ.render_program(sc, with_boundary=False, detached=True)
        args = (params_from_numpy(sc.params(), **CPU), key)
        return prog, args, prog(*args)
    if case == "c":
        sc = t_scenes.env_bench_scene(16, 16, 4, sphere_subdiv=3,
                                      small_subdiv=2, env_size=(130, 258),
                                      tex_size=32, **CPU)
        integ = T.DirectIntegrator(1, 1)
        img = integ.renderC(sc, seed=3)
    else:
        sc = _cbox(16, mode, spp=4, sppe=2, sppse=4)
        integ = (T.DirectIntegrator(1, 1) if case[0] == "d"
                 else T.PathTracer(2, camera_depth=2))
        img = integ.renderD(sc, seed=3)
    (prog,) = integ._radiance_jits.values()
    return prog, (key,), img.reshape(-1, 3)


@pytest.mark.parametrize("case", ["a", "b", "c", "d", "path renderD",
                                  "a pallas", "b pallas", "d pallas",
                                  "path renderD pallas"])
def test_program_body_passes_the_capture_rehearsal(case, monkeypatch):
    """After a warm-up call, the program body of each configuration runs
    in the tensor-word mode without a host read or a tensor from host data
    (a: ``DirectIntegrator(1, 1).render_program``, which rebuilds the
    scene from the params, 32x32 spp 2 on 1,292 triangles, so the BVH and
    K1 run; b: the same under ``PathTracer(3)`` at 16x16; c: renderC on
    ``env_bench_scene`` at 16x16, the frozen envmap table; d: renderD with
    every boundary term, 16x16 spp 4, sppe 2, sppse 4, the secondary
    wavefront compacted; and the fused boundary pass of ``PathTracer(2,
    camera_depth=2)``'s renderD), and its image equals the host-key
    render's bit for bit. The "pallas" cases run a, b, d and the fused
    pass on K1 with visibility reuse, through the sorted and compacted
    sweeps."""
    prog, args, want = _body(case, _k1_mode(case, monkeypatch))
    with rehearsal(monkeypatch), torch.no_grad():
        got = prog.fn(*args)
    np.testing.assert_array_equal(got.reshape(-1, 3).numpy(), want.numpy())
    assert float(want.mean()) > 0.0


def _assert_images_match(got, want):
    assert np.isfinite(got).all() and got.mean() > 0.0
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(got.mean() - want.mean()) <= 1e-4 * want.mean()


@pytest.mark.parametrize("case", ["direct renderD", "path(2) renderC",
                                  "envmap renderC"])
def test_cached_renders_match_jax(case):
    """renderC / renderD through both packages' program caches at seed 4:
    ``DirectIntegrator(1, 1)``'s renderD (with_boundary on, the budgets of
    the boundary terms 0, as their primal is) on cbox 16x16, spp 4;
    ``PathTracer(2)``'s
    renderC on the same scene; ``DirectIntegrator(1, 1)``'s renderC on
    ``env_scene`` (the port sampling the JAX package's importance table).
    Each port render leaves one program in its cache."""
    kw = dict(width=16, height=16, spp=4, occluder_subdiv=1)
    if case == "envmap renderC":
        js, ts, _ = _pair(width=16, height=16, spp=4)
        ji, ti = J.DirectIntegrator(1, 1), T.DirectIntegrator(1, 1)
        want, got = ji.renderC(js, seed=4), ti.renderC(ts, seed=4)
    elif case == "path(2) renderC":
        js, ts = j_cbox(**kw), t_scenes.cbox_scene(**kw, **CPU)
        ji, ti = J.PathTracer(2), T.PathTracer(2)
        want, got = ji.renderC(js, seed=4), ti.renderC(ts, seed=4)
    else:
        js, ts = j_cbox(**kw), t_scenes.cbox_scene(**kw, **CPU)
        ji, ti = J.DirectIntegrator(1, 1), T.DirectIntegrator(1, 1)
        want, got = ji.renderD(js, seed=4), ti.renderD(ts, seed=4)
    assert len(ti._radiance_jits) == len(ji._radiance_jits) == 1
    assert got.shape == (16, 16, 3)
    _assert_images_match(got.numpy().reshape(-1, 3),
                         np.asarray(want).reshape(-1, 3))


def test_cache_keys_as_jax_and_clears_above_16():
    """The cache key is the JAX package's, (id(scene), id(flat), opts,
    sensor, boundary, detached): the same call reuses its program, a new
    flat (the params set again) and other opts each add one, renderD adds
    its own; a 17th program is kept and the 18th clears the cache first."""
    sc = t_scenes.cbox_scene(8, 8, spp=1, occluder_subdiv=1, **CPU)
    integ = T.DirectIntegrator(1, 1)
    integ.renderC(sc)
    (key0, prog0), = integ._radiance_jits.items()
    assert key0 == (id(sc), id(sc.flat), sc.opts, 0, False, True)
    integ.renderC(sc, seed=1)
    assert integ._radiance_jits == {key0: prog0}
    sc.set_params(sc.params())                # a new flat
    integ.renderC(sc)
    sc.opts = dataclasses.replace(sc.opts, spp=2)
    integ.renderC(sc)
    integ.renderD(sc)
    assert len(integ._radiance_jits) == 4
    assert (id(sc), id(sc.flat), sc.opts, 0, True, False) in \
        integ._radiance_jits
    for spp in range(3, 16):
        sc.opts = dataclasses.replace(sc.opts, spp=spp)
        integ.renderC(sc)
    assert len(integ._radiance_jits) == 17
    sc.opts = dataclasses.replace(sc.opts, spp=16)
    integ.renderC(sc)
    assert list(integ._radiance_jits) == [
        (id(sc), id(sc.flat), sc.opts, 0, False, True)]


def test_program_on_cpu_runs_eagerly_and_keeps_its_signature():
    """On CPU tensors a Program calls its function every time, under
    ``torch.no_grad()``, on nests of tensors; a call of another shape,
    dtype or structure, or with a non-tensor, raises."""
    calls = []

    def fn(p, k):
        calls.append(1)
        return {"sum": p["x"] * 2 + k, "k": k}

    prog = Program(fn, "f")
    x = torch.ones(3, requires_grad=True)
    out = prog({"x": x}, torch.zeros(3))
    assert torch.equal(out["sum"], torch.full((3,), 2.0))
    assert not out["sum"].requires_grad and len(calls) == 1
    prog({"x": x + 1}, torch.ones(3))
    assert len(calls) == 2 and not prog.captured
    for args in (({"x": torch.ones(4)}, torch.zeros(4)),
                 ({"x": torch.ones(3, dtype=torch.float64)}, torch.zeros(3)),
                 ({"y": torch.ones(3)}, torch.zeros(3))):
        with pytest.raises(ValueError, match="was built for"):
            prog(*args)
    with pytest.raises(TypeError):
        prog({"x": x}, 0.0)
    assert len(calls) == 2


# -- the gradient programs ----------------------------------------------------

def _flagship_step(small_cut=dict(width=16, height=16, spp=2, sppe=2,
                                  sppse=4)):
    """(the flagship's step program, its arguments): the small flagship
    scene cut to 16 x 16, masked Adam under ``exponential_decay``."""
    occ = flagship_recovery.OCCLUDER
    sc = flagship_recovery.build_scene(True, "cpu")
    sc.opts = dataclasses.replace(sc.opts, **small_cut)
    sc.prepare_accel()
    integ = T.DirectIntegrator(1, 1)
    truth = params_from_numpy(sc.params(), **CPU)
    targets = flagship_recovery.render_targets(sc, integ, truth)
    params = tree_map(lambda x: x.clone(), truth)
    v = truth["meshes"][occ]["vertex_positions"]
    params["meshes"][occ]["vertex_positions"] = torch.as_tensor(
        t_scenes.flagship_deform(v.numpy()))
    mask = tree_map(torch.zeros_like, params)
    mask["meshes"][occ]["vertex_positions"][:] = 1.0
    opt = masked(adam(exponential_decay(1e-2, 10, 0.05)), mask)
    step = flagship_recovery.make_train_step(
        sc, flagship_recovery.make_loss(sc, integ, targets),
        flagship_recovery.laplacian_smoother(sc.meshes[occ].faces,
                                             v.shape[0], "cpu"), opt)
    state = opt.init(params)
    # one step first, so the rehearsed one runs at a count of 1
    params, state, _, _ = step(params, state, threefry.PRNGKey(5))
    return step, (params, state, threefry.PRNGKey(0))


def _recorded(monkeypatch, module, run):
    """The ``Program`` that ``run()`` makes through ``module.Program``,
    and ``run()``'s result."""
    made = []

    def record(*a, **k):
        made.append(Program(*a, **k))
        return made[-1]
    with monkeypatch.context() as m:
        m.setattr(module, "Program", record)
        out = run()
    (prog,) = made
    return prog, out


def _grad_body(case, monkeypatch):
    """(a gradient-side program after its first call, which is the warm-up,
    its arguments, that call's outputs) for ``case``."""
    key = threefry.PRNGKey(3)
    mode = _k1_mode(case, monkeypatch)
    case = case.removesuffix(" pallas")
    if case in ("direct backward", "path backward", "boundary step"):
        boundary = case == "boundary step"
        sc = _cbox(16, mode, spp=4 if boundary else 2,
                   **(dict(sppe=2, sppse=4) if boundary else {}))
        integ = (T.PathTracer(3) if case == "path backward"
                 else T.DirectIntegrator(1, 1))
        prog = integ.grad_program(sc, torch.zeros(256, 3),
                                  with_boundary=boundary)
        args = (params_from_numpy(sc.params(), **CPU), key)
    elif case == "adam update":
        sc = t_scenes.sphere_light_scene(8, 8, spp=1, **CPU)
        opt = Optimizer(sc, ["BSDF[id=white].reflectance",
                             "Mesh[0].vertex_positions"], lr=0.05)
        gen = torch.Generator().manual_seed(0)
        for _ in range(2):
            opt.update({p: torch.randn(x.shape, generator=gen)
                        for p, x in opt.trainable()})
        paths, leaves = zip(*opt.trainable())
        prog = opt._jit_update
        args = (list(leaves), [torch.randn(x.shape, generator=gen)
                               for x in leaves],
                [opt.state["mu"][p] for p in paths],
                [opt.state["nu"][p] for p in paths], opt.state["count"])
    elif case in ("guiding build", "indirect guiding build"):
        sc = _cbox(16, spp=2, sppse=2)
        if case == "guiding build":
            integ = T.DirectIntegrator(1, 1)
            integ.preprocess_secondary_edges(sc, 0, (4, 4, 4, 2), nrounds=2,
                                             seed=3)
        else:
            integ = T.PathTracer(max_depth=2)
            integ.preprocess_indirect_edges(sc, 0, (4, 4, 4, 1), nrounds=2,
                                            seed=3)
        (prog,) = integ._guiding_jits.values()
        args = (key,)
    elif case == "flagship step":
        prog, args = _flagship_step()
    elif case in ("step_grad", "train step whole", "multiview local"):
        _, make = _rebuild_case({"multiview local": "multiview split"}.get(
            case, case))
        step, args = make()
        prog = getattr(step, "programs", (step,))[0]
        if case == "multiview local":
            args = args[::2]                 # (params, key)
    else:   # run_ad
        sc = _cbox(16, spp=2, sppe=2, sppse=4)
        prog, _ = _recorded(monkeypatch, harness, lambda: harness.run_ad(
            sc, T.DirectIntegrator(1, 1), "mesh_transform", mesh_index=5))
        args = (threefry.PRNGKey(1000),)
    return prog, args, prog(*args)


GRAD_CASES = ["direct backward", "path backward", "boundary step",
              "adam update", "guiding build", "indirect guiding build",
              "flagship step", "run_ad", "direct backward pallas",
              "path backward pallas", "boundary step pallas", "step_grad",
              "train step whole", "multiview local"]


@pytest.mark.parametrize("case", GRAD_CASES)
def test_gradient_program_body_passes_the_capture_rehearsal(case,
                                                            monkeypatch):
    """After a warm-up call, each gradient-side program body runs, forward
    and backward, without a host read, in the tensor-word mode, and every
    output equals the host-key call's bit for bit: ``grad_program``
    (bench.py's ``grad_step``) under ``DirectIntegrator(1, 1)`` and
    ``PathTracer(3)`` on cbox 16x16 spp 2 and with every boundary term
    (spp 4, sppe 2, sppse 4: 1,024 secondary lanes, compacted); the
    optimizer's ``_jit_update`` (Adam at a device count of 2); both
    guiding builds (2 rounds in one program); the flagship's step (three
    views, smoothing, masked Adam with its schedule at count 1);
    ``run_ad``'s forward-mode derivative image; the first three again on
    K1 with visibility reuse ("pallas"); ``inverse_geometry``'s
    ``step_grad``; the sharded train step in its one-program form and the
    multi-view step's local program, on a one-rank mesh without a group
    (``testing.ranks.LocalRank``, ``LocalSplitRank``)."""
    prog, args, want = _grad_body(case, monkeypatch)
    with rehearsal(monkeypatch), (torch.enable_grad() if prog.grad
                                  else torch.no_grad()):
        got = prog.fn(*args)
    got_leaves, want_leaves = (tree_flatten(x)[0] for x in (got, want))
    assert len(got_leaves) == len(want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        assert torch.equal(a.detach(), b), case
    assert any(float(x.abs().sum()) > 0 for x in want_leaves
               if x.is_floating_point())


def test_split_step_programs_pass_the_capture_rehearsal(monkeypatch):
    """The gloo form of the sharded train step on a one-rank mesh without
    a group (``testing.ranks.LocalSplitRank``): the bodies of its
    ``VJPProgram``'s two graphs (the forward, the backward fed a
    cotangent) and of its update program pass the rehearsal, each output
    equal to the host-key call's bit for bit."""
    _, make = _rebuild_case("train step split")
    step, (params, state, key) = make()
    forward, update = step.programs
    leaves, spec = tree_flatten((params, key))

    def bodies():
        saved = forward._forward(leaves, spec)
        grads = VJPProgram._backward(
            saved, torch.full_like(saved[0], 1e-3), retain=True)
        with torch.no_grad():
            new = update.fn(params, grads, state)
        return saved[0].detach(), grads, new

    want = bodies()
    with rehearsal(monkeypatch):
        got = bodies()
    got_leaves, want_leaves = (tree_flatten(x)[0] for x in (got, want))
    assert len(got_leaves) == len(want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        assert torch.equal(a, b)
    assert float(want[1]["meshes"][5]["vertex_positions"].abs().sum()) > 0


def test_envmap_table_lives_as_long_as_a_program_that_read_it():
    """The frozen importance table of a sky above 2^15 cells (a 398 x 198
    grid) leaves the host cache after 9 other radiance snapshots: with no
    program that read it, nothing keeps it; a ``render_program`` that read
    it (its capture, on the card) holds it until the program goes."""
    import gc
    import weakref
    sky = np.random.default_rng(4).uniform(0.1, 1.0, (100, 200, 3)).astype(
        np.float32)
    sc = t_scenes.env_scene(None, 8, 8, spp=1, sky=sky, **CPU)

    def push_snapshots():
        rad = sc.emitters[0].radiance.data
        for k in range(9):
            p = sc.params()
            p["emitters"][0] = dict(p["emitters"][0],
                                    radiance=rad * np.float32(1 + k / 64))
            sc.set_params(p)
            sc.configure()
        sc._flat_cache = None
        gc.collect()

    def table():
        return weakref.ref(sc.flat.envmap.cell_distrb.distrb.cmf)

    unread = table()
    push_snapshots()
    assert unread() is None
    prog = T.DirectIntegrator(1, 1).render_program(sc, with_boundary=False,
                                                   detached=True)
    read = table()
    prog(params_from_numpy(sc.params(), **CPU), threefry.PRNGKey(0))
    push_snapshots()
    assert read() is not None
    del prog
    gc.collect()
    assert read() is None


def test_rebuilt_tree_recaptures_and_matches_a_fresh_program(monkeypatch):
    """After ``Optimizer.maybe_rebuild_accel`` re-sorts the tree, a
    ``grad_program`` made before is stale: its body reads the new
    topology's host data (the rehearsal fails, as a capture would) until
    the recapture's warm-up call has run; after it the rehearsed body
    equals a fresh program's step on the new tree bit for bit."""
    from test_torch_opt import _twist
    sc = t_scenes.sphere_light_scene(16, 16, spp=2, subdiv=3, **CPU)
    sc.prepare_accel()
    opt = Optimizer(sc, ["Mesh[0].vertex_positions"])
    integ = T.DirectIntegrator(1, 1)
    prog = integ.grad_program(sc, torch.zeros(256, 3))
    key = threefry.PRNGKey(4)
    prog(opt.params, key)
    assert not prog.stale()
    vp = opt.params["meshes"][0]["vertex_positions"]
    vp.copy_(torch.as_tensor(_twist(vp.numpy(), 3.0)))
    q = sc.refit_quality(opt.params)
    assert opt.maybe_rebuild_accel(threshold=q - 0.01)
    assert prog.stale() and sc.accel_version == 1
    with rehearsal(monkeypatch), torch.enable_grad(), \
            pytest.raises(AssertionError, match="host"):
        prog.fn(opt.params, key)
    warm = prog(opt.params, key)
    assert not prog.stale()
    with rehearsal(monkeypatch), torch.enable_grad():
        got = prog.fn(opt.params, key)
    fresh = integ.grad_program(sc, torch.zeros(256, 3))(opt.params, key)
    for a, b, c in zip(*(tree_flatten(x)[0] for x in (got, warm, fresh))):
        assert torch.equal(a, b) and torch.equal(b, c)


def _rebuild_case(case):
    """(scene, make() -> (step, its arguments)) of a program that builds
    the scene: the flagship step, ``inverse_geometry``'s ``step_grad``,
    and the sharded train steps in both forms on a one-rank mesh."""
    from psdr_tpu_torch.examples.inverse_geometry import make_step_grad
    cpu = torch.device("cpu")
    if case == "flagship step":
        occ = flagship_recovery.OCCLUDER
        sc = flagship_recovery.build_scene(True, "cpu")
        sc.opts = dataclasses.replace(sc.opts, width=16, height=16, spp=1,
                                      sppe=0, sppse=0)
        sc.accel_min_faces = 1
        sc.prepare_accel()
        integ = T.DirectIntegrator(1, 1)
        params = params_from_numpy(sc.params(), **CPU)
        targets = [torch.zeros(256, 3)] * sc.num_sensors
        smooth = flagship_recovery.laplacian_smoother(
            sc.meshes[occ].faces, sc.meshes[occ].num_vertices, "cpu")
        opt = adam(1e-2)

        def make():
            step = flagship_recovery.make_train_step(
                sc, flagship_recovery.make_loss(sc, integ, targets), smooth,
                opt)
            return step, (params, opt.init(params), threefry.PRNGKey(0))
        return sc, make
    if case == "step_grad":
        sc = t_scenes.sphere_light_scene(16, 16, spp=2, subdiv=3, **CPU)
        sc.prepare_accel()
        base = params_from_numpy(sc.params(), **CPU)

        def make():
            step = make_step_grad(sc, T.DirectIntegrator(1, 1), base,
                                  torch.zeros(256, 3))
            return step, (torch.tensor([0.1, -0.1]), threefry.PRNGKey(2))
        return sc, make
    whole = case.endswith("whole")
    mesh = (ranks.LocalRank if whole else ranks.LocalSplitRank)(None, 0, 1,
                                                                cpu)
    if case.startswith("train step"):
        sc = _cbox(16, spp=2)

        def make():
            step, state = make_train_step(T.DirectIntegrator(1, 1), sc, mesh,
                                          np.zeros((256, 3), np.float32),
                                          optimizer=sgd(1.0),
                                          with_boundary=False)
            return step, (params_from_numpy(sc.params(), **CPU), state,
                          threefry.PRNGKey(4))
        return sc, make
    sc = ranks.multiview_scene(1, spp=1, sppe=0, sppse=0)
    sc.accel_min_faces = 1

    def make():
        step, state = make_multiview_train_step(
            T.DirectIntegrator(1, 1), sc, mesh,
            np.zeros((1, 256, 3), np.float32), optimizer=sgd(1.0),
            with_boundary=False)
        return step, (params_from_numpy(sc.params(), **CPU), state,
                      threefry.PRNGKey(4))
    return sc, make


@pytest.mark.parametrize("case", ["flagship step", "step_grad",
                                  "train step whole", "train step split",
                                  "multiview whole", "multiview split"])
def test_scene_programs_capture_again_after_a_rebuild(case):
    """Every program whose body builds the scene retraces on its BVH
    topology: after a forced ``maybe_rebuild_accel`` it is stale (its next
    call on the card drops the graph and captures anew), the programs that
    do not build the scene (the split steps' updates) are not, the old
    topology's uploads have left the scene's cache, and the step made
    before the rebuild equals one made after it, bit for bit."""
    sc, make = _rebuild_case(case)
    step, args = make()
    step(*args)
    progs = getattr(step, "programs", (step,))
    assert sc._bvh_topo is not None
    assert not any(p.stale() for p in progs)
    old = sc._bvh_topo
    assert sc.maybe_rebuild_accel(threshold=sc.refit_quality() - 0.01)
    assert [p.stale() for p in progs] == [True] + [False] * (len(progs) - 1)
    assert not any(a is old.perm or a is old.skip
                   for a, _ in sc.__dict__.get("_uploads", {}).values())
    got = tree_flatten(step(*args))[0]
    want = tree_flatten(make()[0](*args))[0]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b), case


def test_guiding_table_after_set_params_equals_a_fresh_build():
    """The guiding-build cache keys on the flat scene's identity and its
    programs hold that scene, so that no later scene takes over the
    identity: after ``set_params`` moves the geometry, both flat scenes
    are alive, each under its own entry, and a build again equals a fresh
    integrator's table bit for bit."""
    import gc
    from psdr_tpu_torch.scene.scene import FlatScene
    sc = _cbox(16, spp=2, sppse=2)
    integ = T.DirectIntegrator(1, 1)
    g = dict(reso=(4, 4, 4, 2), nrounds=2, seed=3)
    integ.preprocess_secondary_edges(sc, 0, **g)
    before = integ.warpper[0].distrb.pmf.clone()
    p = sc.params()
    vp = p["meshes"][5]["vertex_positions"]
    p["meshes"][5]["vertex_positions"] = vp + np.float32([0.2, 0.1, 0.0])
    sc.set_params(p)
    integ.preprocess_secondary_edges(sc, 0, **g)
    fresh = T.DirectIntegrator(1, 1)
    fresh.preprocess_secondary_edges(sc, 0, **g)
    got = integ.warpper[0].distrb.pmf
    assert torch.equal(got, fresh.warpper[0].distrb.pmf)
    assert not torch.equal(got, before)
    assert len(integ._guiding_jits) == 2
    gc.collect()
    # the scenes' own flat scenes (a program's detached copies are others)
    live = {id(o) for o in gc.get_objects()
            if isinstance(o, FlatScene) and not o.detached}
    assert all(k[2] in live for k in integ._guiding_jits)   # k[2]: id(flat)


@pytest.mark.parametrize("case", ["interior", "boundary"])
def test_grad_program_matches_jax_value_and_grad(case):
    """``grad_program`` against ``jax.jit(jax.value_and_grad)`` of the same
    L2 loss (bench.py's ``grad_step``; a zero target) under the same key,
    every params leaf: cbox 16x16, spp 2 (interior) and spp 2, sppe 2,
    sppse 4 through ``render_fn(with_boundary=True)``; the loss within
    1e-5, each leaf within 1e-2 relative L2 and cosine 0.999
    (``tests/test_torch_grad.py``'s and ``test_torch_boundary.py``'s
    bounds)."""
    boundary = case == "boundary"
    kw = dict(width=16, height=16, spp=2, occluder_subdiv=3,
              **(dict(sppe=2, sppse=4) if boundary else {}))
    js, ts = j_cbox(**kw), t_scenes.cbox_scene(**kw, **CPU)
    j_render = J.DirectIntegrator(1, 1).render_fn(js, with_boundary=boundary)

    def j_loss(p):
        return jnp.mean(j_render(p, jax.random.PRNGKey(3)) ** 2)

    j_value, j_grad = jax.jit(jax.value_and_grad(j_loss))(js.params())
    prog = T.DirectIntegrator(1, 1).grad_program(
        ts, torch.zeros(256, 3), with_boundary=boundary)
    value, grad = prog(params_from_numpy(js.params(), **CPU),
                       threefry.PRNGKey(3))
    assert abs(float(value) - float(j_value)) <= 1e-5 * float(j_value)
    _assert_grads_match([np.asarray(g).ravel()
                         for g in jax.tree.leaves(j_grad)],
                        [g.numpy().ravel() for g in _leaves(grad)],
                        rel_l2=1e-2, min_cos=0.999)


def test_value_and_grad_and_vjp_program_on_cpu():
    """``value_and_grad`` gives zeros for an unused leaf and a detached
    value; a gradient ``Program`` on CPU tensors returns detached
    outputs; ``VJPProgram``'s two halves equal autograd's VJP and its
    ``vjp`` needs a forward first."""
    def f(p, k):
        return (p["a"] * p["a"]).sum() * k.sum()

    vg = Program(value_and_grad(f), "vg", grad=True)
    p = {"a": torch.arange(3.0), "unused": torch.ones(2)}
    value, grads = vg(p, torch.full((2,), 0.5))
    assert not value.requires_grad and float(value) == 5.0
    assert torch.equal(grads["a"], torch.arange(3.0) * 2.0)
    assert torch.equal(grads["unused"], torch.zeros(2))
    vjp = VJPProgram(lambda x, k: x["a"] * x["a"] * k, "vjp")
    with pytest.raises(RuntimeError, match="before a forward"):
        vjp.vjp(torch.ones(3))
    y = vjp({"a": torch.arange(3.0)}, torch.full((3,), 2.0))
    assert not y.requires_grad and torch.equal(y, torch.tensor([0., 2., 8.]))
    g = vjp.vjp(torch.tensor([1.0, 1.0, 3.0]))
    assert torch.equal(g["a"], torch.tensor([0.0, 4.0, 24.0]))
    with pytest.raises(RuntimeError, match="before a forward"):
        vjp.vjp(torch.ones(3))


def test_checkpointed_backward_equals_the_plain_backward():
    """``remat_passes=True`` checkpoints each chunk without saving the
    generator state (``preserve_rng_state=False``): its rehearsed
    backward, in chunks below the wavefront, equals the un-checkpointed
    one bit for bit."""
    out = []
    for remat in (False, True):
        sc = _cbox(16, spp=2, sppe=2, sppse=4)
        sc.opts = dataclasses.replace(sc.opts, remat_passes=remat,
                                      pass_lanes=256)
        prog = T.DirectIntegrator(1, 1).grad_program(
            sc, torch.zeros(256, 3), with_boundary=True)
        args = (params_from_numpy(sc.params(), **CPU), threefry.PRNGKey(2))
        prog(*args)
        with rehearsal(pytest.MonkeyPatch()), torch.enable_grad():
            out.append(tree_flatten(prog.fn(*args))[0])
    for a, b in zip(*out):
        assert torch.equal(a, b)
