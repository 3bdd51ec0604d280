"""The readings that a cell's check limits are set from, in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --control 4,5,6 [--steps N]

A ``forward`` cell: for each of ``--seeds``: the program's checked image
of that seed (the replays a run's window makes for it) against the
reference (the lower readings), and the same image from a program of
half the spp, the mean taken over those samples (the fault of half the
work left out). For each of ``--control``: the control (``check.py``:
the reference in bfloat16 at the image's samples a pixel) in the
program's place (the upper readings).

A ``grad_step`` cell: for each of ``--seeds``, the mean gradient of
``--steps`` steps (what a run's window completes) with keys drawn from
the seed, against the finite differences (the lower readings); the same
at twice the spp (the size of the interior's covariance with the image,
which the loss of a 16-spp image puts into its gradient) and without the
guiding table at equal samples (which should pass too). For each of
``--control``: the program without its boundary terms (the upper
readings). Besides, the finite differences at two other generator seeds
(their own noise), and the same central differences of the program's own
forward renders (``port_fd``), a witness of what the program's images
say its gradient is.

Prints one line a reading and writes them all to
``bench_runs/calibrate.<cell>.json``. The benchmark's runs do not run
this; it needs the card."""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]


def readings(bench, cell: str, seeds, control_seeds, device) -> dict:
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


def port_fd(bench, cell: str, device) -> list:
    """Central differences, at ``check.eps``, of mean((I - T)^2) over the
    program's own forward images I (its render program at the cell's spp,
    ``check.fd_spp`` / spp replays with the same keys on both sides) with
    the mesh moved along each axis."""
    import torch
    import check
    import harness
    import psdr_tpu_torch as port
    wl = bench.workload(cell)
    g, c = wl["grad"], wl["check"]
    w, h = wl["film"]
    scene, integ = bench.builder(bench.cell(cell)["config"]).build(
        port, harness.scene_data(bench, cell),
        dict(width=w, height=h, spp=wl["spp"]), device)
    params = harness.device_params(scene.params(), device)
    prog = integ.render_program(scene, with_boundary=False, detached=True)
    target = torch.as_tensor(check.grad_target(bench, cell, device),
                             dtype=torch.float64, device=device)
    words, _ = harness.key_words(c["fd_seed"], c["fd_spp"] // wl["spp"])
    keys = harness.key_tensor(words, device)
    leaf = params["meshes"][g["mesh"]]
    base = leaf["vertex_positions"].clone()

    def loss(offset):
        leaf["vertex_positions"] = base + torch.as_tensor(
            offset, dtype=base.dtype, device=device)
        img = sum(prog(params, k).double() for k in keys) / len(keys)
        return float(((img - target) ** 2).mean())
    out = []
    for axis in np.asarray(g["axes"], np.float64):
        step = c["eps"] * axis
        out.append((loss(step) - loss(-step)) / (2 * c["eps"]))
    return out


def grad_readings(bench, cell: str, seeds, control_seeds, steps: int,
                  device) -> dict:
    import torch
    import check
    import harness
    wl = bench.workload(cell)
    t = time.perf_counter()
    g_fd = check.fd_gradient(bench, cell, device)
    found = {"cell": cell, "steps": steps,
             "fd": {"cell": g_fd.tolist(),
                    "seconds": time.perf_counter() - t},
             "program": {}, "double": {}, "unguided": {}, "control": {}}
    for k in (1, 2):
        other = check.fd_gradient(bench, cell, device,
                                  seed=wl["check"]["fd_seed"] + k)
        found["fd"][f"seed+{k}"] = dict(check.grad_numbers(other, g_fd),
                                        grad=other.tolist())
    mine = port_fd(bench, cell, device)
    found["fd"]["port"] = dict(check.grad_numbers(mine, g_fd), grad=mine)
    print(f"finite differences {found['fd']}", flush=True)
    job_mod = bench.job("grad_step")
    for kind, kw, kind_seeds in (
            ("program", {}, seeds),
            ("double", {"spp": 2 * wl["spp"]}, seeds),
            ("unguided", {"guided": False}, seeds),
            ("control", {"with_boundary": False}, control_seeds)):
        if not kind_seeds:
            continue
        job = job_mod.GradStep(harness.Run(bench, cell, kind_seeds[0],
                                           device), **kw)
        for seed in kind_seeds:
            job.reseed(seed)
            t = time.perf_counter()
            for i in range(steps):
                job.step(i)
            mean = job.mean_grad()
            found[kind][seed] = dict(check.grad_numbers(mean, g_fd),
                                     grad=mean.tolist(),
                                     seconds=time.perf_counter() - t)
            print(f"{kind} seed {seed}: {found[kind][seed]}", flush=True)
        job.close()
        del job
        gc.collect()
        torch.cuda.empty_cache()
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args(argv)
    import torch
    import harness
    if not torch.cuda.is_available():
        print("calibrate.py needs the card", file=sys.stderr)
        return 3
    bench = harness.Bench(ROOT)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control.split(",") if s]
    if bench.workload(args.workload)["kind"] == "grad_step":
        found = grad_readings(bench, args.workload, seeds, control,
                              args.steps, "cuda:0")
    else:
        found = readings(bench, args.workload, seeds, control, "cuda:0")
    found["card"] = harness._nvidia_smi()
    runs = ROOT / "bench_runs"
    runs.mkdir(exist_ok=True)
    (runs / f"calibrate.{args.workload}.json").write_text(
        json.dumps(found, indent=1))
    for kind in ("program", "half", "double", "unguided", "control"):
        for name, v0 in next(iter(found.get(kind, {}).values()), {}).items():
            if not isinstance(v0, float):
                continue
            vals = [v[name] for v in found[kind].values()]
            print(f"{kind} {name}: min {min(vals)!r} max {max(vals)!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
