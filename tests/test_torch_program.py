"""The compiled render programs on the CPU (``psdr_tpu_torch/program.py``
and the integrators' program cache, ``_jit_radiance_call``).

* A capture rehearsal: a CUDA graph capture refuses every host read of a
  tensor and every tensor made from host data (the copy synchronizes).
  ``HostReadGuard`` fails on both, so a program body that passes under it
  (after one warm-up call that fills the caches, with its key in the
  tensor-word mode) is one the card can capture. The plain versions of the
  kernels run unguarded: on the card the kernels launch in their place.
  Bodies: the forward configurations of ``chip_smoke.py`` phase 28
  (a-d, shrunk) and ``PathTracer(2, camera_depth=2)``'s renderD primal;
  each guarded image equals the host-key render bit for bit.
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

import psdr_tpu as J
import psdr_tpu_torch as T
from psdr_tpu_torch.accel import intersect
from psdr_tpu_torch.convert import params_from_numpy
from psdr_tpu_torch.core import threefry
from psdr_tpu_torch.program import Program
from psdr_tpu_torch.testing import scenes as t_scenes

from scenes import cbox_scene as j_cbox
from test_torch_envmap import _pair

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


@contextlib.contextmanager
def rehearsal(monkeypatch):
    """Tensor-word keys under ``HostReadGuard``; the kernels' plain
    versions unguarded."""
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
        with threefry.tensor_words(), guard:
            yield


def test_guard_fails_on_host_reads(monkeypatch):
    """The rehearsal is not vacuous: each kind of host access fails."""
    x = torch.arange(4.0)
    cases = [lambda: x.sum().item(), lambda: bool(x[0] > 0),
             lambda: x[x > 1.0], lambda: x.tolist(),
             lambda: torch.tensor([1.0]), lambda: torch.as_tensor([1.0]),
             lambda: torch.from_numpy(np.zeros(2)),
             lambda: threefry.PRNGKey(0)]
    for case in cases:
        with rehearsal(monkeypatch), pytest.raises(AssertionError):
            case()
    with rehearsal(monkeypatch):     # device work on tensors passes
        assert (x * 2 + torch.as_tensor(x)).shape == (4,)


def _cbox(size, **kw):
    return t_scenes.cbox_scene(size, size, occluder_subdiv=3, **kw, **CPU)


def _body(case):
    """(the program of ``case`` after its first call, which is the warm-up
    that fills the caches, its argument tuple, that call's host-key
    image)."""
    key = threefry.PRNGKey(3)
    if case in ("a", "b"):
        sc = _cbox(32 if case == "a" else 16, spp=2)
        integ = T.DirectIntegrator(1, 1) if case == "a" else T.PathTracer(3)
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
        sc = _cbox(16, spp=4, sppe=2, sppse=4)
        integ = (T.DirectIntegrator(1, 1) if case == "d"
                 else T.PathTracer(2, camera_depth=2))
        img = integ.renderD(sc, seed=3)
    (prog,) = integ._radiance_jits.values()
    return prog, (key,), img.reshape(-1, 3)


@pytest.mark.parametrize("case", ["a", "b", "c", "d", "path renderD"])
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
    render's bit for bit."""
    prog, args, want = _body(case)
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
