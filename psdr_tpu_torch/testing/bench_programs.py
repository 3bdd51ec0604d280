"""Time the captured programs of ``chip_smoke.py`` phases 28 and 29 on one
GPU beside another checkout's, and check that each checkout's eager
trainer steps repeat themselves.

    python3 -m psdr_tpu_torch.testing.bench_programs [--parent DIR] [--out F]

The configurations are (a)-(j) of ``chip_smoke.program_configs`` and
``gradient_configs``, each checkout's own. For each checkout (parent, this
one, this one, parent; this one alone without ``--parent``) a process of
its own imports that checkout's package and ``chip_smoke.py`` and, for
each configuration, runs one eager step, captures the program and replays
it once (its launch counts), then times 5 eager steps and 5 replays (host
clock around a synchronize; medians) and profiles one of each (device busy
ms, host launch calls). Then REPRO_STEPS eager trainer steps at phase 22's
config, twice, every K1 and K2 launch hashed by this checkout's
``chip_smoke.LaunchHasher`` (run on that checkout's package), and where the
two passes part (``first_difference``; None where they agree). Last, in
this process, a 1-D ``torch.cumsum`` and ``core.segsum.prefix_sum`` of
300,000 floats, each run 1000 times: their counts of distinct results.
``--parent`` names a directory that holds another checkout (``git archive
<commit> | tar -x -C DIR``). Writes one JSON object to ``--out`` (default
``build/bench_programs.json``) and prints a table.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
REPS = 5
CUMSUM_N, CUMSUM_RUNS = 300_000, 1000


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(tree: str) -> dict:
    """The timings and the hashed passes of checkout ``tree`` (this
    process imports its package)."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    cs = _load(Path(tree) / "chip_smoke.py", "chip_smoke")
    tools = _load(ROOT / "chip_smoke.py", "repro_tools")
    from psdr_tpu_torch.accel import intersect
    intersect.build_library()
    intersect.load_library()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    out = {}

    def run(label, eager, replay):
        eager(1)
        replay(0)
        torch.cuda.synchronize()
        intersect.reset_launch_counts()
        replay(1)
        torch.cuda.synchronize()
        launches = dict(intersect.LAUNCHES)
        times = {}
        for name, fn in (("eager", eager), ("replay", replay)):
            ts = []
            for i in range(REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(2 + i)
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t0)
            times[name] = ts
        prof = {n: cs.program_frame(lambda: f(9))
                for n, f in (("eager", eager), ("replay", replay))}
        out[label[0]] = {
            **{f"{n}_s": float(np.median(ts)) for n, ts in times.items()},
            **{f"{n}_all": ts for n, ts in times.items()},
            **{f"{n}_{k}": prof[n][i] for n in prof
               for i, k in ((0, "wall_ms"), (1, "busy_ms"), (3, "calls"))},
            "launches": launches}

    for label, eager, replay, _, _ in cs.program_configs(dev):
        run(label, eager, replay)
        torch.cuda.empty_cache()
    for label, make, _ in cs.gradient_configs(dev):
        eager, replay, *_ = make()
        run(label, eager, replay)
        del eager, replay
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    passes = [tools.hashed_trainer(intersect, dev, tools.TRAIN,
                                   tools.REPRO_STEPS) for _ in range(2)]
    out["trainer"] = {
        "steps": tools.REPRO_STEPS, "launches": len(passes[0]["launches"]),
        "first_difference": tools.first_difference(*passes),
        "losses_differing": sum(a != b for a, b in zip(
            passes[0]["losses"], passes[1]["losses"]))}
    return out


def distinct_results(fn, x, runs: int) -> int:
    """How many bit patterns ``fn(x)`` gives over ``runs`` runs."""
    import torch
    w = (torch.arange(x.numel(), device=x.device, dtype=torch.int64)
         * 2654435761 % (1 << 31) + 1)
    digests = torch.stack([(fn(x).view(torch.int32).long() * w).sum()
                           for _ in range(runs)])
    return len(set(digests.cpu().tolist()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another checkout's directory")
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "bench_programs.json"))
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree:
        print(json.dumps(measure(args.tree)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("bench_programs: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    order = ([(args.parent, "parent"), (str(ROOT), "this"),
              (str(ROOT), "this"), (args.parent, "parent")]
             if args.parent else [(str(ROOT), "this")])
    runs = []
    for tree, tag in order:
        # run as a file, so that the tree's own package is the one found
        proc = subprocess.run([sys.executable, __file__, "--tree",
                               os.path.abspath(tree)], cwd=tree,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-6000:], file=sys.stderr)
            return 1
        runs.append((tag, json.loads(proc.stdout.strip().splitlines()[-1])))
    sys.path.insert(0, str(ROOT))
    from psdr_tpu_torch.core.segsum import prefix_sum
    x = torch.rand(CUMSUM_N, device="cuda")
    scans = {"torch.cumsum": distinct_results(
                 lambda v: torch.cumsum(v, 0), x, CUMSUM_RUNS),
             "prefix_sum": distinct_results(prefix_sum, x, CUMSUM_RUNS)}
    result = {"card": card, "runs": runs, "scans": scans,
              "scan_size": CUMSUM_N, "scan_runs": CUMSUM_RUNS}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(card)
    print("config | " + " | ".join(f"{t} replay s / eager s / busy ms"
                                   for t, _ in runs))
    for k in "abcdefghij":
        print(k, " | ".join(f"{r[k]['replay_s']:.5f} / {r[k]['eager_s']:.4f}"
                            f" / {r[k]['replay_busy_ms']:.1f}"
                            for _, r in runs))
    for tag, r in runs:
        print(f"{tag}: {r['trainer']['steps']} eager trainer steps twice: "
              f"{r['trainer']['losses_differing']} losses differ; first "
              f"difference {r['trainer']['first_difference']}")
    print(f"{CUMSUM_RUNS} runs of {CUMSUM_N} floats: distinct results "
          f"{scans}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
