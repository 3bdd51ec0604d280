"""The check that decides ``correct``, driven through the rest of a run on
the CPU at a size a test can hold: each cell's configuration and kind on
a 32 x 32 film with a smaller sphere and sky. A sound run is correct; the
lower-precision control and each fault that such a cell can have, planted
in the port underneath the timed path, are not. One test runs a small
cell on the card and skips where there is none.

At this size the Monte Carlo error is larger than at a cell's own, so the
limits here (``SMALL_LIMITS``) are set from CPU readings of this size, as
the cells' own are from chip readings of theirs (PERF.md)."""
import dataclasses
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import check  # noqa: E402
import harness  # noqa: E402

CELLS = ("cbox_direct.forward", "bunny_env.forward")
SEED = 2 ** 31 + 101
SMALL_LIMITS = {
    "cbox_direct.forward": {"bias_all": 0.02, "bias_region": 0.06,
                            "noise": 0.00024},
    "bunny_env.forward": {"bias_all": 0.025, "bias_region": 0.2,
                          "noise": 0.0011},
}


def small_bench(root: Path) -> harness.Bench:
    """The benchmark copied under ``root`` with each cell cut to a 32 x 32
    film (its spp and passes kept at most 16 and 4), its sphere to 320
    faces and its sky to 64 x 128."""
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for cfg in ("cbox_direct", "bunny_env"):
        path = root / "benchmark" / "configs" / f"{cfg}.json"
        c = json.loads(path.read_text())
        for key in ("occluder_subdiv", "subdiv"):
            if key in c["scene"]:
                c["scene"][key] = 2
        if "env_size" in c["scene"]:
            c["scene"]["env_size"] = [64, 128]
        path.write_text(json.dumps(c))
    for cell in CELLS:
        path = root / "benchmark" / "workloads" / f"{cell}.json"
        wl = json.loads(path.read_text())
        wl.update(film=[32, 32], spp=min(wl["spp"], 16),
                  passes=min(wl["passes"], 4), limits=SMALL_LIMITS[cell])
        wl["check"].update(pixels_per_region=48, spp=512)
        path.write_text(json.dumps(wl))
    return harness.Bench(root)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return small_bench(tmp_path_factory.mktemp("bench"))


def run(bench, cell, monkeypatch):
    monkeypatch.setattr(harness, "CHECKED", 1)
    return harness.run_cell(bench, cell, SEED, 0.0, False, "cpu",
                            log=lambda *_: None)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(bench, cell, monkeypatch):
    rec = run(bench, cell, monkeypatch)
    assert rec["correct"], rec["checks"]
    out = harness.result(bench, rec, False)
    assert list(out)[-1] == "checks"
    assert out["attempted"] == rec["steps"] > rec["checked_step"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(bench, cell):
    ids, region, ref = check.reference_pixels(bench, cell, SEED, "cpu")
    _, _, ctl = check.reference_pixels(bench, cell, SEED, "cpu",
                                       control=True)
    nums = check.numbers(ctl, ref, region)
    assert not check.within(nums, bench.workload(cell)["limits"]), nums


def _half_the_samples(monkeypatch):
    """Each pass of the interior term over half its samples, the mean
    taken over those."""
    from psdr_tpu_torch.integrator import base
    orig = base.Integrator.render_interior

    def half(self, scene, flat, sensor_id, key, shard=None):
        opts = scene.opts
        scene.opts = dataclasses.replace(opts, spp=max(1, opts.spp // 2))
        try:
            return orig(self, scene, flat, sensor_id, key, shard)
        finally:
            scene.opts = opts
    monkeypatch.setattr(base.Integrator, "render_interior", half)


def _answer_altered(monkeypatch):
    """Each image scaled by 1.05 where it is produced."""
    from psdr_tpu_torch.integrator import base
    orig = base.Integrator.radiance_image
    monkeypatch.setattr(base.Integrator, "radiance_image",
                        lambda *a, **k: orig(*a, **k) * 1.05)


@pytest.mark.parametrize("fault", [_half_the_samples, _answer_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(bench, cell, fault, monkeypatch):
    fault(monkeypatch)
    rec = run(bench, cell, monkeypatch)
    assert not rec["correct"], rec["checks"]


@pytest.mark.gpu
def test_small_cell_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b = small_bench(tmp_path)
    # 1,292 faces: past the 512 below which the port intersects without
    # its tree, so that K1, whose roofline the cell reports, runs
    path = tmp_path / "benchmark" / "configs" / "cbox_direct.json"
    path.write_text(json.dumps(dict(
        json.loads(path.read_text()),
        scene=dict(json.loads(path.read_text())["scene"],
                   occluder_subdiv=3))))
    for traced in (False, True):
        rec = harness.run_cell(b, "cbox_direct.forward", SEED, 1.0, traced,
                               "cuda:0", log=lambda *_: None)
        assert rec["correct"], rec["checks"]
        out = harness.result(b, rec, traced)
        assert out["device"]["platform"] == "gpu"
        assert out["metrics"]
        assert np.isfinite([m["value"] for m in out["metrics"].values()]
                           ).all()
