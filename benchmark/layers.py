"""The device time of each layer of a cell's render program, from the
port's own spans and counters (``psdr_tpu_torch.profiling``), on the card:

    python3 benchmark/layers.py <cell> <seed>

from the root of a checkout. Builds the cell's program as a run does
(``harness.program``), calls it once, replays images until the device's
slow phase has ended (``harness.settle``), then calls
``Program.profile_layers`` on a key drawn from the seed: each layer's
self device time and graph nodes in an instrumented twin of the graph,
the replay times of twin and program, and the host time of a call with
the device idle. Prints a summary on standard error and the measurement
as one JSON object, the last line of standard output. Exits with 3,
printing nothing, where no card is present or the port has no
``profile_layers``.

No metric of ``BENCHMARK.json`` reads this: ``harness.result`` stops a
run where a metric that the cell lists reads nothing, so a metric read
from these spans would stop every traced run of a port that lacks them.
``summary`` gives the numbers such metrics would read.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if __name__ == "__main__":
    sys.path[:0] = [str(BENCH), str(ROOT)]

import harness  # noqa: E402

DEVICE = "cuda:0"
SHARES = ("rng", "bsdf", "emitter")


def measure(cell: str, seed: int) -> dict:
    """One measurement of ``cell``'s program in this process (which must
    have built nothing before, so that its warm-up is a run's)."""
    import torch
    from psdr_tpu_torch import profiling
    t0 = time.perf_counter()
    torch.set_num_threads(4)             # as a run sets it
    wl, prog, params = harness.program(harness.Bench(ROOT), cell, DEVICE)
    words, _ = harness.key_words(seed, wl["passes"])
    keys = harness.key_tensor(words, DEVICE)
    prog(params, keys[0])
    harness.settle(lambda: harness.image(prog, params, keys), t0)
    layers = prog.profile_layers(params, keys[0])
    w, h = wl["film"]
    return {"cell": cell, "seed": seed, "layers": layers,
            "spans": profiling.spans(), "counters": profiling.counters(),
            "samples_per_replay": w * h * wl["spp"],
            "seconds": time.perf_counter() - t0}


def summary(m: dict) -> dict:
    """The per-layer numbers of one measurement: the self device time of
    the random stream, the materials and the emitters as percent of the
    twin's replay, graph nodes per million samples a replay, the host
    milliseconds of a call, and the seconds of the program's warm-up."""
    la = m["layers"]
    out = {f"{k}_share": 100.0 * la["layers_ms"].get(k, 0.0) / la["twin_ms"]
           for k in SHARES}
    out["graph_nodes_per_msample"] = la["nodes"] / (
        m["samples_per_replay"] / 1e6)
    out["launch_ms"] = la["call_ms"]
    warm = m["spans"].get("program.warm_up")
    out["warm_up_s"] = None if warm is None else warm["total_s"]
    return out


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 2:
        print(__doc__.strip().split("\n\n")[1].strip(), file=sys.stderr)
        return 2
    cell, seed = args[0], int(args[1])
    import torch
    from psdr_tpu_torch.program import Program
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    if not hasattr(Program, "profile_layers"):
        print("the port has no Program.profile_layers", file=sys.stderr)
        return 3
    m = measure(cell, seed)
    la = m["layers"]
    print(f"{cell}: " + ", ".join(
        f"{k} {v:.3f} ms / {la['layer_nodes'][k]} nodes"
        for k, v in la["layers_ms"].items())
        + f"; sum {la['sum_ms']:.3f}, twin {la['twin_ms']:.3f}, plain "
        f"{la['plain_ms']:.3f} ms a replay, call {la['call_ms']:.3f} ms, "
        f"{la['nodes']} nodes, {la['events']} events; measured in "
        f"{m['seconds']:.1f} s", file=sys.stderr, flush=True)
    print(json.dumps(summary(m)), file=sys.stderr, flush=True)
    print(json.dumps(m), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
