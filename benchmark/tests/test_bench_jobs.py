"""Jobs and references found by name: a configuration, its own reference
and a job kind added to a copy of the benchmark as new files only, and
run; and the forward job drawing the keys, the checked image and the
pixels that the harness drew before jobs had files of their own."""
import hashlib
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import check  # noqa: E402
import harness  # noqa: E402
import reference  # noqa: E402

TOY_CONFIG = '''
def scene(cfg):
    return {"meshes": [], "camera": None, "integrator": {"kind": "count"}}
'''
TOY_REFERENCE = '''
def expected(n, steps):
    return n * steps
'''
TOY_JOB = '''
class Count:
    """A job that counts: every step adds the workload's n."""

    def __init__(self, run):
        self.run = run
        self.capture_s, self.excluded_s, self.extra = 0.0, 0.0, {}
        self.samples_per_step = run.wl["n"]
        self.replays_per_step, self.min_steps = 1, 3
        self.total = self.steps = 0

    def warm(self):
        pass

    def step(self, i):
        self.total += self.run.wl["n"]
        self.steps += 1
        return True

    def body(self):
        pass

    def close(self):
        pass

    def judge(self):
        ref = self.run.bench.reference(self.run.config)
        return {"miss": abs(self.total - ref.expected(self.run.wl["n"],
                                                      self.steps))}


def setup(run):
    return Count(run)
'''


def _digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_config_reference_and_job_added_as_new_files_only(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "benchmark")
    new = {"configs/toy.json": json.dumps({"name": "toy"}),
           "configs/toy.py": TOY_CONFIG,
           "references/toy.py": TOY_REFERENCE,
           "jobs/count.py": TOY_JOB,
           "workloads/toy.count.json": json.dumps(
               {"config": "toy", "kind": "count", "n": 5,
                "limits": {"miss": 0}}),
           "metrics/counted.py": "def read(rec):\n"
                                 "    return rec['steps'] * "
                                 "rec['samples_per_step']\n"}
    for name, text in new.items():
        path = tmp_path / "benchmark" / name
        assert not path.exists()
        path.parent.mkdir(exist_ok=True)
        path.write_text(text)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(name="toy", source="x", reduced=[], why="x",
                                file="benchmark/configs/toy.json"))
    spec["workloads"].append(dict(name="toy.count", config="toy",
                                  traffic="count", chips=1, why="x"))
    spec["end_to_end"].append(dict(name="counted", unit="things",
                                   better="higher", bound=0.01,
                                   source="host_clock",
                                   workloads=["toy.count"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    bench = harness.Bench(tmp_path)
    assert bench.reference("toy").expected(2, 3) == 6
    assert bench.reference("cbox_direct") is reference   # none of its own
    rec = harness.run_cell(bench, "toy.count", 7, 0.0, False, "cpu",
                           log=lambda *_: None)
    assert rec["correct"] and rec["checks"] == {"miss": 0}
    assert rec["steps"] == 3 and rec["kind"] == "count"
    out = harness.result(bench, rec, False)
    assert out["metrics"]["counted"]["value"] == 15
    assert out["checks"] == {"miss": {"value": 0, "limit": 0}}
    after = _digests(tmp_path / "benchmark")
    assert {k: after[k] for k in before} == before


# The parent's draws, before the forward job had a file of its own: the
# sha256 (first 16 hex digits) of the key words and of the pixel ids, and
# the checked image's index, at two seeds.
FORWARD_DRAWS = {
    ("cbox_direct.forward", 2 ** 31 + 17): (5, "644aee46ba4fc8ac",
                                            "8aa446b8a5c538b0"),
    ("cbox_direct.forward", 3087654321): (7, "2531ce020dd7b299",
                                          "036efb06daced8f7"),
    ("bunny_env.forward", 2 ** 31 + 17): (0, "efe75002c6b840ef",
                                          "260d18c93d3f8979"),
    ("bunny_env.forward", 3087654321): (1, "5e165061630a5538",
                                        "c80a8826b228fa92"),
}


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, np.int64).tobytes()
                          ).hexdigest()[:16]


@pytest.mark.parametrize("cell,seed", sorted(FORWARD_DRAWS))
def test_forward_job_draws_as_before(tmp_path, cell, seed):
    checked, keys, ids = FORWARD_DRAWS[cell, seed]
    bench = harness.Bench(ROOT)
    ids_now, _ = check.pixels(bench.workload(cell), seed)
    assert _sha(ids_now) == ids
    # the job itself, on a film of 8 x 8 (its draws do not depend on it)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    config = bench.cell(cell)["config"]
    path = tmp_path / "benchmark" / "configs" / f"{config}.json"
    cfg = json.loads(path.read_text())
    for key in ("occluder_subdiv", "subdiv"):
        if key in cfg["scene"]:
            cfg["scene"][key] = 1
    if "env_size" in cfg["scene"]:
        cfg["scene"]["env_size"] = [16, 32]
    path.write_text(json.dumps(cfg))
    path = tmp_path / "benchmark" / "workloads" / f"{cell}.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                    film=[8, 8])))
    small = harness.Bench(tmp_path)
    job = small.job("forward").setup(
        harness.Run(small, cell, seed, "cpu"))
    assert job.checked == checked and job.min_steps == checked + 1
    assert _sha(job.keys.reshape(-1, 2).numpy()) == keys
    assert job.replays_per_step == bench.workload(cell)["passes"]
