"""The port's ``PathTracer`` against a reference that shares nothing with
it, and the path tracer's span and counters, on the CPU.

The reference is the benchmark's plain multi-bounce estimator
(``benchmark/references/cbox_path.py``), on the benchmark's own
configuration ``cbox_path`` (psdr-cuda's Cornell box) cut to a 32 x 32
film and a 320-face sphere, below the port's ``accel_min_faces``, so the
port intersects by brute force. ``PathTracer(4)`` agrees with it within
limits set from CPU readings at this size (PERF.md), and
``PathTracer(3)``, which leaves out the light of the last bounce, does
not. At one vertex the reference agrees with the benchmark's direct
reference (``benchmark/reference.py``, the Direct cells' own); at two it
does not.

The counters: ``path.bounce`` opens once for each depth after the
camera's, ``path.bounces`` counts them, and ``k1.rays.bounce`` counts the
lanes launched into K1 inside them, here through a stand-in for the CUDA
launch that counts ``k1.rays`` as the launch does. The span and the
counters add no operation to a body (on the card: no node to its graph).

The benchmark's modules are imported under their own names, which
``tests/scenes.py`` shares, and taken out of ``sys.modules`` again
(``_benchmark``)."""
import contextlib
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import psdr_tpu_torch as port
from psdr_tpu_torch import profiling
from psdr_tpu_torch.accel import intersect
from psdr_tpu_torch.convert import params_from_numpy
from psdr_tpu_torch.core import threefry
from psdr_tpu_torch.integrator import path as t_path

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
_NAMES = ("harness", "check", "scenes", "shapes", "reference", "stats")

FILM = [32, 32]
SPP = 16                  # the port's samples a pixel
REF_SPP = 128             # the reference's
CHECK = dict(film=FILM, check=dict(regions=[2, 2], pixels_per_region=64))
SEED = 2_000_000_020
# From CPU readings at this size, seeds 1-9 and SEED (PERF.md):
# PathTracer(4) against the reference read bias_all <= 0.0243,
# bias_region <= 0.073; PathTracer(3) bias_all >= 0.0909, bias_region
# >= 0.125 (at SEED: 0.0065, 0.028 and 0.112, 0.148).
LIMITS = {"bias_all": 0.05, "bias_region": 0.1}
# The reference at one vertex against the direct reference, 64 spp each,
# same seeds: bias_all <= 0.0126, bias_region <= 0.0324; at two vertices
# >= 0.49, 0.58.
DIRECT_SPP = 64
DIRECT_LIMITS = {"bias_all": 0.03, "bias_region": 0.08}


@contextlib.contextmanager
def _benchmark():
    """The benchmark's folder first on the path and its modules importable
    by their own names inside the block; after it, ``sys.modules`` holds
    what it held before under those names."""
    saved = {n: sys.modules.pop(n) for n in _NAMES if n in sys.modules}
    sys.path.insert(0, str(BENCH))
    try:
        yield
    finally:
        sys.path.remove(str(BENCH))
        for n in _NAMES:
            sys.modules.pop(n, None)
        sys.modules.update(saved)


@pytest.fixture(scope="module")
def bench():
    with _benchmark():
        import check
        import harness
        import reference
        b = harness.Bench(ROOT)
        cfg = b.config("cbox_path")
        cfg["scene"]["occluder_subdiv"] = 2
        builder = b.builder("cbox_path")
        return types.SimpleNamespace(
            check=check, direct=reference, path=b.reference("cbox_path"),
            builder=builder, data=builder.scene(cfg))


def _depth(data, kind, max_depth=None):
    ic = dict(kind=kind)
    if max_depth is not None:
        ic["max_depth"] = max_depth
    return dict(data, integrator=ic)


def _numbers(bench, mine, ref, region, limits):
    """The check's numbers that ``limits`` bounds (``noise`` is left out:
    at this size it cannot tell a bounce more from a bounce less)."""
    nums = bench.check.numbers(mine, ref, region)
    return {k: nums[k] for k in limits}


@pytest.fixture(scope="module")
def pixels(bench):
    ids, region = bench.check.pixels(CHECK, SEED)
    keep = ~bench.path.sees_emitter(bench.data, FILM, ids, "cpu")
    return ids[keep], region[keep]


@pytest.fixture(scope="module")
def reference_image(bench, pixels):
    return bench.path.render(_depth(bench.data, "path", 4), FILM, pixels[0],
                             REF_SPP, SEED, "cpu")


@pytest.mark.parametrize("max_depth,agrees", [(4, True), (3, False)])
def test_path_tracer_against_the_plain_reference(bench, pixels,
                                                 reference_image, max_depth,
                                                 agrees):
    ids, region = pixels
    sc, integ = bench.builder.build(
        port, _depth(bench.data, "path", max_depth),
        dict(width=FILM[0], height=FILM[1], spp=SPP), "cpu")
    assert isinstance(integ, port.PathTracer)
    assert integ.max_depth == max_depth and integ.camera_depth == 1
    img = integ.renderC(sc, seed=SEED).reshape(-1, 3).double().numpy()
    nums = _numbers(bench, img[ids], reference_image, region, LIMITS)
    assert bench.check.within(nums, LIMITS) == agrees, nums


@pytest.mark.parametrize("max_depth,agrees", [(1, True), (2, False)])
def test_reference_at_one_vertex_is_the_direct_reference(bench, pixels,
                                                         max_depth, agrees):
    ids, region = pixels
    direct = bench.direct.render(_depth(bench.data, "direct"), FILM, ids,
                                 DIRECT_SPP, SEED + 1, "cpu")
    mine = bench.path.render(_depth(bench.data, "path", max_depth), FILM,
                             ids, DIRECT_SPP, SEED + 2, "cpu")
    nums = _numbers(bench, mine, direct, region, DIRECT_LIMITS)
    assert bench.check.within(nums, DIRECT_LIMITS) == agrees, nums


# -- the span and the counters -------------------------------------------------

def _small_scene(bench, max_depth, subdiv, accel_mode):
    """The box at 8 x 8, spp 2, with a sphere of 20 x 4^subdiv faces."""
    with _benchmark():
        import shapes
        v, f = shapes.icosphere(subdiv, 0.35)
    meshes = list(bench.data["meshes"])
    meshes[5] = dict(meshes[5], vertices=v + np.array([0.0, -0.2, 0.0]),
                     faces=f)
    sc, integ = bench.builder.build(
        port, dict(_depth(bench.data, "path", max_depth), meshes=meshes),
        dict(width=8, height=8, spp=2), "cpu")
    sc.accel_mode = accel_mode
    return sc, integ


@pytest.fixture
def k1_launches(monkeypatch):
    """K1 driven on the CPU through a stand-in for its CUDA launch, which
    counts ``k1.rays`` as the launch does; yields [(lanes, whether
    ``path.bounce`` was open)], one a launch."""
    launches = []

    def k1_stand_in(bvh, ray_o, ray_d, active, tmax, any_hit=False):
        launches.append((ray_o.shape[0],
                         "path.bounce" in profiling.open_spans()))
        profiling.count("k1.rays", ray_o.shape[0])
        return intersect.k1_plain(bvh, ray_o, ray_d, active, tmax)
    device_of = intersect._device_of
    monkeypatch.setattr(intersect, "_device_of", lambda o, name: (
        "cuda" if name == "K1" else device_of(o, name)))
    monkeypatch.setattr(intersect, "k1_cuda", k1_stand_in)
    return launches


def _body(sc, integ):
    p = params_from_numpy(sc.params(), device="cpu")
    with torch.no_grad():
        return integ.render_fn(sc, with_boundary=False)(
            p, threefry.PRNGKey(5))


@pytest.mark.parametrize("max_depth", [1, 4])
def test_bounce_span_and_counters(bench, k1_launches, max_depth):
    sc, integ = _small_scene(bench, max_depth, 3, "pallas")   # K1's sweeps
    c0 = profiling.counters()
    with profiling.recording() as rec:
        _body(sc, integ)
    c1 = profiling.counters()
    added = {k: c1.get(k, 0) - c0.get(k, 0)
             for k in ("k1.rays", "k1.rays.bounce", "path.bounces")}
    bounces = [s for s in rec if s.name == "path.bounce"]
    assert len(bounces) == added["path.bounces"] == max_depth - 1
    by_id = {s.id: s for s in rec}
    assert all(by_id[s.parent].name == "render" for s in bounces)
    assert added["k1.rays"] == sum(n for n, _ in k1_launches) > 0
    assert added["k1.rays.bounce"] == sum(n for n, b in k1_launches if b)
    if max_depth > 1:
        assert 0 < added["k1.rays.bounce"] < added["k1.rays"]
    else:
        assert added["k1.rays.bounce"] == 0


def test_open_spans_names_the_open_spans_outermost_first():
    assert profiling.open_spans() == ()
    with profiling.span("t.a"):
        with profiling.span("t.b"):
            assert profiling.open_spans() == ("t.a", "t.b")
        assert profiling.open_spans() == ("t.a",)
    assert profiling.open_spans() == ()


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _without_tracing(monkeypatch):
    """``path.py`` with a ``profiling`` whose span and counters do
    nothing: the body as it would be without them."""
    stub = types.SimpleNamespace(span=lambda name: contextlib.nullcontext(),
                                 count=lambda name, n=1: None,
                                 counters=lambda: {})
    monkeypatch.setattr(t_path, "profiling", stub)


def test_bounce_span_adds_no_operation(bench, monkeypatch):
    """The same aten operations, in the same order, with the span and
    counters and without them: with tracing off they put nothing on the
    device, so a captured program has the nodes it had without them."""
    sc, integ = _small_scene(bench, 4, 1, "auto")
    _body(sc, integ)                       # fills the scene's caches
    seen = []
    for strip in (False, True):
        if strip:
            _without_tracing(monkeypatch)
        with _Ops() as mode:
            out = _body(sc, integ)
        seen.append((mode.ops, out))
    assert seen[0][0] == seen[1][0] and len(seen[0][0]) > 100
    assert torch.equal(seen[0][1], seen[1][1])


@pytest.mark.gpu
def test_bounce_span_adds_no_graph_node(bench, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    nodes, images = [], []
    for strip in (False, True):
        if strip:
            _without_tracing(monkeypatch)
        sc, integ = bench.builder.build(
            port, _depth(bench.data, "path", 4),
            dict(width=64, height=64, spp=4), "cuda")
        prog = integ.render_program(sc, with_boundary=False, detached=True)
        p = params_from_numpy(sc.params(), device="cuda")
        images.append(prog(p, threefry.PRNGKey(3, device="cuda")))
        nodes.append(prog.nodes)
    assert nodes[0] == nodes[1] > 0
    assert torch.equal(images[0], images[1])
