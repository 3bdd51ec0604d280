"""The benchmark's harness, driven by data.

``BENCHMARK.json`` (the checkout's root) names the cells and metrics; each
name leads to files of its own under ``benchmark/``:

* ``configs/<config>.json``, the deployment as it is run, and
  ``configs/<config>.py``, whose ``scene(cfg)`` makes its scene as host
  arrays (``scenes.py``) and ``build(port, data, opts, device)`` hands
  them to the port with its integrator;
* ``references/<config>.py``, the plain reference that the
  configuration's answers are judged against, where the configuration
  brings one of its own, and ``reference.py`` where it does not
  (``Bench.reference``);
* ``workloads/<cell>.json``, the cell's job: its ``kind``, film, samples,
  and the size and limits of its check;
* ``jobs/<kind>.py``, one kind of job (``Bench.job``), whose
  ``setup(run)`` builds the cell's program on the port, makes its first
  call and returns the job: ``forward``, images rendered back to back,
  each the mean of ``passes`` replays of the render program, read on the
  host; ``grad_step``, gradient steps of an L2 loss to a target image,
  each loss read on the host;
* ``metrics/<metric>.py``, whose ``read(rec)`` takes the metric from the
  run's record (``run_cell``), or returns None where it finds nothing.

A job has ``capture_s`` (the seconds of its first call),
``samples_per_step``, ``replays_per_step``, ``min_steps`` (the fewest
steps after which the window may close), ``extra`` (readings of its
set-up, copied into the record) and ``excluded_s`` (set-up seconds that
are the benchmark's and not the program's, kept out of ``setup_s``);
``warm()`` makes one step outside the window, ``step(i)`` the window's
``i``-th, with its answer read on the host (False where it is not
finite), ``body()`` one eager run of the program's body (for the launch
recorder), ``close()`` frees the program, and ``judge()`` returns the
numbers that its check compares with the workload's ``limits``.

A run sets the cell up (the job's set-up and one step), steps until the
slow phase ends (``settle``), measures a closed loop for the window's
seconds (each step with a new key drawn from the seed, its answer read on
the host), reads the peak memory and, with a trace, the device's work,
frees the program and has the job judge the window's answers against the
plain reference (``check.py``).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import time
from pathlib import Path

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "psdr_tpu")
KEYS = 2048          # images a run has keys for: more than a window completes
CHECKED = 8          # the checked image is one of the window's first CHECKED
SETTLE_CAP_S = 90.0  # the latest the window opens after the process started
SETTLE_DROP = 0.015  # the fall in an image's time that ends the slow phase


def forbidden_modules(names) -> list:
    """The top-level names among module ``names`` that a run may not load:
    each name's part before its first dot, compared whole."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` under ``root`` and the files that its names
    lead to in ``root/benchmark``."""

    def __init__(self, root):
        self.root = Path(root)
        self.dir = self.root / "benchmark"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def builder(self, name: str):
        return load_module(self.dir / "configs" / f"{name}.py",
                           f"bench_config_{name}")

    def workload(self, cell: str) -> dict:
        return json.loads((self.dir / "workloads" / f"{cell}.json")
                          .read_text())

    def metrics(self, cell: str, traced: bool) -> list:
        """The cell's end-to-end metrics (untraced) or per-layer ones
        (traced): those that list the cell, or list no cells."""
        group = self.spec["per_layer" if traced else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str):
        return load_module(self.dir / "metrics" / f"{metric}.py",
                           f"bench_metric_{metric.replace('.', '_')}")

    def job(self, kind: str):
        """The module of job kind ``kind`` (``jobs/<kind>.py``)."""
        return load_module(self.dir / "jobs" / f"{kind}.py",
                           f"bench_job_{kind}")

    def reference(self, config: str):
        """The plain reference of configuration ``config``: its own
        (``references/<config>.py``) where it has one, else
        ``reference.py``."""
        own = self.dir / "references" / f"{config}.py"
        if own.is_file():
            return load_module(own, f"bench_reference_{config}")
        import reference
        return reference


def device_params(tree, device):
    """A params nest of host arrays as float32 tensors on ``device``."""
    import torch
    if isinstance(tree, dict):
        return {k: device_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(device_params(v, device) for v in tree)
    return torch.tensor(np.asarray(tree, np.float32), device=device)


def opts_of(wl: dict) -> dict:
    return dict(width=wl["film"][0], height=wl["film"][1], spp=wl["spp"])


def samples_per_image(wl: dict) -> int:
    w, h = wl["film"]
    return w * h * wl["spp"] * wl["passes"]


def key_words(seed: int, n: int) -> np.ndarray:
    """(n, 2) Threefry keys (two uint32 words in int64) drawn from
    ``seed``, and the index of the image whose answer a ``forward`` cell
    checks."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 2), dtype=np.uint64)
    return words.astype(np.int64), int(rng.integers(0, CHECKED))


def key_tensor(words, device):
    import torch
    return torch.as_tensor(np.asarray(words, np.int64), device=device)


def sync(device):
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.synchronize(device)


def _nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().split("\n")[0]


def scene_data(bench: Bench, cell: str) -> dict:
    """The cell's scene as host arrays (``scenes.py``)."""
    config = bench.cell(cell)["config"]
    return bench.builder(config).scene(bench.config(config))


def program(bench: Bench, cell: str, device, spp=None):
    """The render program of a ``forward`` cell on the port, set up:
    (workload, program, device params); ``spp`` replaces the workload's.
    Its first call is the caller's."""
    import psdr_tpu_torch as port
    wl = bench.workload(cell)
    if spp is not None:
        wl["spp"] = spp
    if wl["kind"] != "forward":
        raise NotImplementedError(f"job kind {wl['kind']!r}")
    builder = bench.builder(bench.cell(cell)["config"])
    scene, integ = builder.build(port, scene_data(bench, cell), opts_of(wl),
                                 device)
    params = device_params(scene.params(), device)
    prog = integ.render_program(scene, with_boundary=False, detached=True)
    return wl, prog, params


def image(prog, params, keys) -> "np.ndarray":
    """One image: the mean of one replay a key, read on the host."""
    acc = prog(params, keys[0])
    for k in keys[1:]:
        acc += prog(params, k)
    return (acc / len(keys)).cpu().numpy()


def settle(make_step, t0: float) -> list:
    """Make steps until the slow phase ends: the median time of the last
    five steps falls by ``SETTLE_DROP`` or more below the first step's or
    below the median of the five before, or ``SETTLE_CAP_S`` after ``t0``.
    On the H100 the replays of every process of this benchmark ran slower
    at first (10% on ``cbox_direct.forward``, 2.8% on
    ``bunny_env.forward``) and then switched once, from under a second to
    over a minute into the first sustained replays (PERF.md). Returns the
    steps' seconds."""
    times = []
    while time.perf_counter() - t0 < SETTLE_CAP_S:
        ts = time.perf_counter()
        make_step()
        times.append(time.perf_counter() - ts)
        if len(times) < 6:
            continue
        before = times[0]
        if len(times) >= 10:
            before = max(before, float(np.median(times[-10:-5])))
        if np.median(times[-5:]) <= (1 - SETTLE_DROP) * before:
            break
    return times


class Run:
    """What a job's set-up is handed: the benchmark, the cell, its
    workload and configuration, the run's seed and the device."""

    def __init__(self, bench: Bench, cell: str, seed: int, device):
        self.bench, self.cell, self.seed = bench, cell, seed
        self.wl = bench.workload(cell)
        self.config = bench.cell(cell)["config"]
        self.device = device
        self.on_card = str(device).startswith("cuda")


def run_cell(bench: Bench, cell: str, seed: int, seconds: float,
             traced: bool, device="cuda:0", t0: float | None = None,
             log=print) -> dict:
    """One run of ``cell``: set-up, the measured window, the readings and
    the check. Returns the run's record (see the module docstring); the
    metrics are not read here (``result``)."""
    import torch
    import check

    t0 = time.perf_counter() if t0 is None else t0
    run = Run(bench, cell, seed, device)
    torch.set_num_threads(4)
    job = bench.job(run.wl["kind"]).setup(run)
    job.warm()
    setup_s = time.perf_counter() - t0 - job.excluded_s
    log(f"set-up {setup_s:.3f} s (first call {job.capture_s:.3f} s)")
    settle_s = settle(job.warm, t0) if run.on_card else []

    # -- the window: a closed loop of steps, each with keys of its own
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
    step_s, failed = [], 0
    start = time.perf_counter()
    start_epoch = time.time()
    deadline = start + seconds
    i = 0
    while True:
        ts = time.perf_counter()
        ok = job.step(i)
        te = time.perf_counter()
        step_s.append(te - ts)
        failed += not ok
        i += 1
        if te >= deadline and i >= job.min_steps:
            break
    window_s = te - start
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(device) if run.on_card else 0
    log(f"window {window_s:.3f} s, {i} steps, {failed} failed")

    rec = {"cell": cell, "kind": run.wl["kind"], "seed": seed, "steps": i,
           "replays": i * job.replays_per_step, "step_s": step_s,
           "window_s": window_s, "settle_s": settle_s,
           "window_opens_s": start - t0,
           "samples_per_step": job.samples_per_step, "setup_s": setup_s,
           "capture_s": job.capture_s, "peak_bytes": peak, "failed": failed,
           "window_start": start_epoch, "trace": None, "launches": None,
           **job.extra}
    if prof is not None:
        import devtrace
        rec["trace"] = devtrace.summarize(prof, window_s)
        del prof
        from recorder import LaunchRecorder
        with LaunchRecorder() as r:
            job.body()
            sync(device)
        rec["launches"] = {"k1": r.k1}
    if run.on_card:
        rec["card"] = {"name": torch.cuda.get_device_name(0),
                       "smi": _nvidia_smi()}

    # -- the program's state is freed before the reference runs
    job.close()
    gc.collect()
    if run.on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    rec["checks"] = job.judge()
    rec["reference_s"] = time.perf_counter() - t
    rec["limits"] = run.wl["limits"]
    rec["correct"] = check.within(rec["checks"], run.wl["limits"])
    if run.on_card:
        rec["reference_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    log(f"reference {rec['reference_s']:.3f} s")
    return rec


def result(bench: Bench, rec: dict, traced: bool, count: int = 1) -> dict:
    """The result line of a run's record: the contract's keys, the
    compared numbers last. A metric that the cell lists and that reads
    nothing stops the run: a later change that takes its source away
    takes the metric out of ``BENCHMARK.json`` too."""
    metrics = {}
    for m in bench.metrics(rec["cell"], traced):
        v = bench.reader(m["name"]).read(rec)
        if v is None:
            raise RuntimeError(f"{m['name']} read nothing in {rec['cell']}")
        metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    card = rec.get("card", {})
    dev = {"platform": "gpu" if card else "cpu",
           "kind": card.get("name", "cpu"), "count": count,
           "memory_peak_bytes": int(rec["peak_bytes"])}
    out = {"correct": bool(rec["correct"]), "attempted": rec["steps"],
           "failed": rec["failed"], "metrics": metrics, "device": dev}
    tr = rec.get("trace")
    if tr is not None:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["checks"] = {k: {"value": v, "limit": rec["limits"][k]}
                     for k, v in rec["checks"].items()}
    return out
