"""Run one cell of the benchmark once, on the card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints progress and the compared numbers
(last) on standard error, and the result as one JSON object, the last line
of standard output. With ``--trace 0`` the result's metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer ones, read from a
profiler trace of the window. The run's record (trace summary included)
is written to ``bench_runs/`` in the checkout.

Exits with another code than 0, printing no result, where no card (or
fewer than the cell asks for) is present, where a file the run needs is
missing, or where the process has loaded JAX or the JAX package."""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    import harness
    bench = harness.Bench(ROOT)
    entry = bench.cell(args.workload)
    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA device(s); this machine "
            f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    rec = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda:0", T0, log)
    out = harness.result(bench, rec, bool(args.trace), chips)
    found = harness.forbidden_modules(sys.modules)
    if found:
        log(f"the run loaded {', '.join(found)}; no result")
        return 4
    runs = ROOT / "bench_runs"
    runs.mkdir(exist_ok=True)
    (runs / f"{args.workload}.{args.seed}.trace{args.trace}.json").write_text(
        json.dumps(rec, default=str))
    log(f"card: {rec['card']['smi']}")
    for k, v in out["checks"].items():
        log(f"check {k} = {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
