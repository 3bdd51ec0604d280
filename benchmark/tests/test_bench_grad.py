"""The gradient job (``jobs/grad_step.py``) and its check
(``check.fd_gradient``, ``check.grad_numbers``), driven through the rest
of a run on the CPU at a size a test can hold. A gradient cell is added
to a copy of the benchmark as new files only: psdr-cuda's AD job
(``examples/config.py:21-40``: spp 16, sppe 8, sppse 64, a guided
secondary-edge term) on a 32 x 32 film, in ``cbox_direct``'s box with a
black 320-face sphere for its occluder, a guiding table of 1000 x 5 x 5
x 2 cells over 4 rounds and a run of ``STEPS`` steps. The port's guided
gradient passes; the interior-only control and each fault that such a
cell can have, planted in the port underneath the timed path, do not.

The occluder is black and coarse because this tests the check, not the
port: on a lit flat-shaded occluder, and on a dense one, the port's
gradient departs from the reference's finite differences (PERF.md
section 7), which is why the benchmark has no gradient cell yet.

At this size a pixel spans eight times the world that it spans at
256 x 256, so the finite differences take eps 0.02 and 1024 samples a
pixel, and the limit here (``SMALL_LIMIT``) is set from CPU readings of
this size: ``grad_err`` of sound runs 0.014-0.037 (seven seeds; at twice
the spp 0.012-0.036, unguided 0.012-0.028, the finite differences at
other generator seeds 0.021 and 0.025 from these), the control 1.0 (a
black occluder's interior derivative is 0), the faults 1.0, 0.48 and
0.16."""
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

CELL = "cbox_black.guided_step"
SEED = 2 ** 31 + 103
STEPS = 8
SMALL_LIMIT = 0.1
BLACK_CONFIG = '''
from pathlib import Path

import harness

_box = harness.load_module(Path(__file__).with_name("cbox_direct.py"),
                           "bench_config_cbox_direct")
OCCLUDER = 5           # the mesh after the five walls


def scene(cfg):
    data = _box.scene(cfg)
    data["meshes"][OCCLUDER] = dict(data["meshes"][OCCLUDER],
                                    bsdf=_box.BLACK)
    return data


build = _box.build
'''
WORKLOAD = {
    "config": "cbox_black", "kind": "grad_step", "film": [32, 32],
    "spp": 16, "sppe": 8, "sppse": 64,
    "guiding": {"reso": [1000, 5, 5, 2], "nrounds": 4, "seed": 5},
    "grad": {"mesh": 5, "axes": [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                                 [0.0, 0.0, 1.0]],
             "target_offset": [0.05, 0.05, 0.0], "target_spp": 256,
             "target_seed": 20241019},
    "check": {"eps": 0.02, "fd_spp": 1024, "fd_seed": 20241020},
    "limits": {"grad_err": SMALL_LIMIT}}


def small_bench(root: Path) -> harness.Bench:
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    # a byte-code cache beside the configurations is no input of the check
    (root / "benchmark" / "configs" / "__pycache__").mkdir()
    configs = root / "benchmark" / "configs"
    cfg = json.loads((configs / "cbox_direct.json").read_text())
    cfg["name"] = "cbox_black"
    cfg["scene"]["occluder_subdiv"] = 2
    (configs / "cbox_black.json").write_text(json.dumps(cfg))
    (configs / "cbox_black.py").write_text(BLACK_CONFIG)
    (root / "benchmark" / "workloads" / f"{CELL}.json").write_text(
        json.dumps(WORKLOAD))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(name="cbox_black", source="x", reduced=[],
                                why="x",
                                file="benchmark/configs/cbox_black.json"))
    spec["workloads"].append(dict(name=CELL, config="cbox_black",
                                  traffic="guided_step", chips=1, why="x"))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return harness.Bench(root)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return small_bench(tmp_path_factory.mktemp("bench"))


def run(bench, monkeypatch, **job_kw):
    """A run of ``STEPS`` steps on the CPU; ``job_kw`` departs from the
    cell (``GradStep``'s arguments)."""
    orig = harness.Bench.job

    def job(self, kind):
        mod = orig(self, kind)

        def setup(run_):
            j = mod.GradStep(run_, **job_kw)
            j.min_steps = STEPS
            return j
        mod.setup = setup
        return mod
    monkeypatch.setattr(harness.Bench, "job", job)
    return harness.run_cell(bench, CELL, SEED, 0.0, False, "cpu",
                            log=lambda *_: None)


def test_sound_run_is_correct(bench, monkeypatch):
    rec = run(bench, monkeypatch)
    assert rec["correct"], rec["checks"]
    assert rec["steps"] == STEPS and rec["failed"] == 0
    assert rec["guiding_s"] > 0 and rec["target_s"] >= 0
    assert rec["samples_per_step"] == 32 * 32 * (16 + 8 + 64)
    out = harness.result(bench, rec, False)
    assert set(out["metrics"]) == {"setup_s", "peak_gib"}
    assert list(out["checks"]) == ["grad_err"]
    # the same target and finite differences, read from the checkout
    assert sorted(p.name.split(".")[-3] for p in
                  (bench.root / "bench_runs").glob(f"{CELL}.*.npy")) == [
        "fd", "target"]


def test_control_is_not_correct(bench, monkeypatch):
    """The interior derivative alone: plain autodiff of the renderer."""
    rec = run(bench, monkeypatch, with_boundary=False)
    assert not rec["correct"], rec["checks"]


def _state_unchanged(monkeypatch):
    """Each step returns its gradient untouched: zeros."""
    from psdr_tpu_torch.integrator import base
    orig = base.value_and_grad

    def zero(fn, argnums=0):
        vg = orig(fn, argnums)

        def f(*args):
            value, grads = vg(*args)
            return value, torch.utils._pytree.tree_map(torch.zeros_like,
                                                       grads)
        return f
    monkeypatch.setattr(base, "value_and_grad", zero)


def _half_the_pixels(monkeypatch):
    """The loss over the first half of the film's pixels, its mean taken
    over those: the rest of the batch left out."""
    from psdr_tpu_torch.integrator import base
    from psdr_tpu_torch.program import Program, value_and_grad

    def grad_program(self, scene, target, sensor_id=0,
                     with_boundary=False):
        render = self.render_fn(scene, sensor_id, with_boundary)
        half = target.shape[0] // 2

        def loss(params, key):
            return torch.mean(((render(params, key) - target) ** 2)[:half])
        return Program(value_and_grad(loss), grad=True)
    monkeypatch.setattr(base.Integrator, "grad_program", grad_program)


def _answer_altered(monkeypatch):
    """The secondary-edge (shadow) term's contribution halved where it is
    produced."""
    from psdr_tpu_torch.integrator import direct
    orig = direct.DirectIntegrator.render_secondary_edges
    monkeypatch.setattr(direct.DirectIntegrator, "render_secondary_edges",
                        lambda *a, **k: orig(*a, **k) * 0.5)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_pixels,
                                   _answer_altered])
def test_fault_is_not_correct(bench, fault, monkeypatch):
    fault(monkeypatch)
    rec = run(bench, monkeypatch)
    assert not rec["correct"], rec["checks"]
