"""The multi-bounce cell ``cbox_path.forward`` on the CPU: its
configuration, its own reference and its workload found by name in a
copy of the benchmark; the launch recorder's K1 records of a path tracer
body, which the ``path.bounce`` span leaves as they were before it; and a
run of the cell cut to 32 x 32, correct, with its one-bounce-fewer
control not correct.

K1 runs on the card only. Here its sweeps (``accel_mode`` "pallas") go
through a stand-in for its CUDA launch (``k1_cpu``), which the recorder
wraps as it wraps the launch."""
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import harness  # noqa: E402
import reference  # noqa: E402
import recorder  # noqa: E402

CELL = "cbox_path.forward"
SEED = 2 ** 31 + 303
# Readings of the cut cell below on the CPU, 8 seeds (PERF.md):
# PathTracer(4) bias_all 0.0002-0.0206, bias_region 0.086-0.258, noise
# 0.010-0.017; PathTracer(3) bias_all 0.083-0.122, bias_region
# 0.159-0.320, noise 0.020-0.026. At 16 pixels a region only bias_all
# tells the two apart; the other two limits are above every reading.
SMALL_LIMITS = {"bias_all": 0.045, "bias_region": 0.5, "noise": 0.05}

# The K1 records of a PathTracer(4) and a DirectIntegrator(2, 2) body on
# the 8 x 8 box (spp 2, a 1,280-face sphere), as the recorder kept them
# before the path tracer had its span: (lanes, active lanes, faces), one a
# launch.
PARENT_K1 = {
    "cbox_path": [(128, 128, 1292), (128, 103, 1292), (128, 0, 1292),
                  (128, 128, 1292), (128, 76, 1292), (128, 107, 1292),
                  (128, 64, 1292), (128, 84, 1292), (128, 43, 1292),
                  (128, 0, 1292)],
    "cbox_direct": [(128, 128, 1292), (128, 2, 1292), (128, 0, 1292),
                    (128, 103, 1292), (128, 104, 1292)],
}


@pytest.fixture
def k1_cpu(monkeypatch):
    """K1's sweeps on CPU tensors through a stand-in for the CUDA launch
    (its plain version), no stream capture to ask about, and the port's
    default visibility reuse (read at call time; the tests' conftest turns
    it off)."""
    from psdr_tpu_torch import profiling
    from psdr_tpu_torch.accel import intersect
    device_of = intersect._device_of

    def k1_stand_in(bvh, ray_o, ray_d, active, tmax, any_hit=False):
        profiling.count("k1.rays", ray_o.shape[0])
        return intersect.k1_plain(bvh, ray_o, ray_d, active, tmax)
    monkeypatch.setattr(intersect, "_device_of", lambda o, name: (
        "cuda" if name == "K1" else device_of(o, name)))
    monkeypatch.setattr(intersect, "k1_cuda", k1_stand_in)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setenv("PSDR_TPU_VIS_REUSE", "edge")
    monkeypatch.delenv("PSDR_TPU_VIS_REUSE_Q", raising=False)


def _recorded_body(config: str):
    import psdr_tpu_torch as port
    from psdr_tpu_torch.convert import params_from_numpy
    from psdr_tpu_torch.core import threefry
    bench = harness.Bench(ROOT)
    cfg = bench.config(config)
    cfg["scene"]["occluder_subdiv"] = 3
    builder = bench.builder(config)
    sc, integ = builder.build(port, builder.scene(cfg),
                              dict(width=8, height=8, spp=2), "cpu")
    sc.accel_mode = "pallas"
    p = params_from_numpy(sc.params(), device="cpu")
    fn = integ.render_fn(sc, with_boundary=False)
    with torch.no_grad(), recorder.LaunchRecorder() as r:
        fn(p, threefry.PRNGKey(5))
    return r


def test_cell_found_by_name_in_a_copy(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    bench = harness.Bench(tmp_path)
    cell = bench.cell(CELL)
    assert cell["config"] == "cbox_path" and cell["chips"] == 1
    cfg = bench.config("cbox_path")
    assert cfg["integrator"] == {"kind": "path", "max_depth": 4}
    wl = bench.workload(CELL)
    assert (wl["kind"], wl["film"], wl["spp"], wl["passes"]) == (
        "forward", [256, 256], 8, 20)
    ref = bench.reference("cbox_path")
    assert ref is not reference
    assert Path(ref.__file__) == tmp_path / "benchmark/references/cbox_path.py"
    assert callable(ref.render) and ref.sees_emitter is reference.sees_emitter
    data = harness.scene_data(bench, CELL)
    assert len(data["meshes"]) == 7 and data["integrator"]["max_depth"] == 4
    names = [m["name"] for m in bench.metrics(CELL, True)]
    assert names == ["idle_share.render", "k1_roofline.render", "capture_s"]
    assert [m["name"] for m in bench.metrics(CELL, False)] == [
        "setup_s", "render_samples_per_s", "peak_gib"]


@pytest.mark.parametrize("config", sorted(PARENT_K1))
def test_recorder_keeps_its_records(k1_cpu, config):
    r = _recorded_body(config)
    assert r.k1 == PARENT_K1[config]
    assert r.stop()["k1"] is r.k1


def small_bench(root: Path, max_depth: int = 4) -> harness.Bench:
    """The benchmark copied under ``root``, the cell cut to a 32 x 32 film,
    spp 8 x 2 passes, a 320-face sphere, 16 pixels a region at 128 spp;
    the configuration's integrator at ``max_depth`` (the control: a copy
    of the configuration, not a switch)."""
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    path = root / "benchmark" / "configs" / "cbox_path.py"
    path.write_text(path.read_text().replace(
        'max_depth=ic["max_depth"]', f"max_depth={max_depth}"))
    path = root / "benchmark" / "configs" / "cbox_path.json"
    c = json.loads(path.read_text())
    c["scene"]["occluder_subdiv"] = 2
    path.write_text(json.dumps(c))
    path = root / "benchmark" / "workloads" / f"{CELL}.json"
    wl = json.loads(path.read_text())
    wl.update(film=[32, 32], spp=8, passes=2, limits=SMALL_LIMITS)
    wl["check"].update(pixels_per_region=16, spp=128)
    path.write_text(json.dumps(wl))
    return harness.Bench(root)


@pytest.mark.parametrize("max_depth,correct", [(4, True), (3, False)])
def test_cut_cell_runs_and_its_control_fails(tmp_path, monkeypatch,
                                             max_depth, correct):
    monkeypatch.setattr(harness, "CHECKED", 1)
    b = small_bench(tmp_path, max_depth)
    rec = harness.run_cell(b, CELL, SEED, 0.0, False, "cpu",
                           log=lambda *_: None)
    assert rec["correct"] == correct, rec["checks"]
    out = harness.result(b, rec, False)
    assert out["metrics"]["render_samples_per_s"]["value"] > 0
