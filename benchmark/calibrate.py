"""The readings that a cell's check limits are set from, in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --control 4,5,6

For each of ``--seeds``: the program's checked image of that seed (the
replays a run's window makes for it) against the reference (the lower
readings), and the same image from a program of half the spp, the mean
taken over those samples (the fault of half the work left out). For
each of ``--control``: the control (``check.py``: the reference in
bfloat16 at the image's samples a pixel) in the program's place (the
upper readings). Prints one line a reading and writes them all to
``bench_runs/calibrate.<cell>.json``. The benchmark's runs do not run
this; it needs the card."""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]


def readings(bench, cell: str, seeds, control_seeds, device) -> dict:
    import numpy as np
    import torch
    import check
    import harness
    wl, prog, params = harness.program(bench, cell, device)
    _, half, _ = harness.program(bench, cell, device, spp=wl["spp"] // 2)
    passes = wl["passes"]
    images = {}
    for seed in seeds:
        words, j = harness.key_words(seed, (harness.KEYS + 1) * passes)
        keys = harness.key_tensor(words, device).reshape(-1, passes, 2)[j]
        images[seed] = (harness.image(prog, params, keys),
                        harness.image(half, params, keys))
    del prog, half, params
    gc.collect()
    torch.cuda.empty_cache()
    found = {"cell": cell, "program": {}, "half": {}, "control": {}}
    for seed in sorted(set(seeds) | set(control_seeds)):
        t = time.perf_counter()
        ids, region, ref = check.reference_pixels(bench, cell, seed, device)
        ref_s = time.perf_counter() - t
        if seed in images:
            for kind, img in zip(("program", "half"), images[seed]):
                mine = np.asarray(img, np.float64).reshape(-1, 3)[ids]
                found[kind][seed] = check.numbers(mine, ref, region)
                print(f"{kind} seed {seed}: {found[kind][seed]} "
                      f"(reference {ref_s:.2f} s, {len(ids)} pixels)",
                      flush=True)
        if seed in control_seeds:
            _, _, ctl = check.reference_pixels(bench, cell, seed, device,
                                               control=True)
            found["control"][seed] = check.numbers(ctl, ref, region)
            print(f"control seed {seed}: {found['control'][seed]}",
                  flush=True)
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    args = ap.parse_args(argv)
    import torch
    import harness
    if not torch.cuda.is_available():
        print("calibrate.py needs the card", file=sys.stderr)
        return 3
    bench = harness.Bench(ROOT)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control.split(",") if s]
    found = readings(bench, args.workload, seeds, control, "cuda:0")
    found["card"] = harness._nvidia_smi()
    runs = ROOT / "bench_runs"
    runs.mkdir(exist_ok=True)
    (runs / f"calibrate.{args.workload}.json").write_text(
        json.dumps(found, indent=1))
    for kind in ("program", "half", "control"):
        for name in next(iter(found[kind].values()), {}):
            vals = [v[name] for v in found[kind].values()]
            print(f"{kind} {name}: min {min(vals)!r} max {max(vals)!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
