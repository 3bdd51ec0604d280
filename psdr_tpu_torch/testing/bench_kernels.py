"""Time K1 and K3 on one GPU beside another checkout's kernels on the
same rays.

    python3 -m psdr_tpu_torch.testing.bench_kernels [--parent DIR] [--out F]

The rays are the bench scene's (``cbox_scene(512, 512, spp=64,
occluder_subdiv=5)``, 20,492 triangles): the first 2^21-lane camera chunk
in tile order with the bounce and shadow sweeps from its hits, the shapes
the render path launches, and 2^21 rays through random pixels, the
incoherent case. K1's closest hits must equal ``k1_plain``'s bit for bit,
its any hits in ``valid``, and K3 must equal K1 at every blocking, or the
run fails. Times are CUDA events over 20 launches, best of two runs; the
order is parent, this package, this package, parent. ``--parent`` names a
directory that holds another checkout of the repository (``git archive
<commit> | tar -x -C DIR``); its package is timed in a process of its own
(this file run as a script with ``--rays``) on the rays this process saved
under ``build/``. Writes one JSON object to ``--out`` (default
``build/bench_kernels.json``) and prints a table.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

BENCH = dict(width=512, height=512, spp=64, occluder_subdiv=5)
N = 1 << 21
SHAPES = ("tiled camera", "tiled bounce", "tiled shadow", "random camera",
          "random shadow")          # closest, any, any, closest, any
K3_BLOCKINGS = ((512, 128), (128, 256), (256, 128), (128, 128), (1024, 128))


def time_ms(fn, reps=20):
    """Best of two runs of ``reps`` launches, by CUDA events, and the last
    result."""
    best = float("inf")
    out = fn()
    for _ in range(2):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best, out


def make_rays(dev):
    """{shape: (ray_o, ray_d, active, tmax, any_hit)} on ``dev``."""
    from psdr_tpu_torch.accel.intersect import _rays
    from psdr_tpu_torch.scene.scene import detach_flat
    from psdr_tpu_torch.testing.scenes import (cbox_scene, scene_rays,
                                               tiled_camera_rays)
    sc = cbox_scene(**BENCH, device=dev)
    sc.prepare_accel()
    flat = detach_flat(sc.build(sc.params()))
    tiled = tiled_camera_rays(sc, flat, N, BENCH["spp"], 2)
    rand = scene_rays(sc, flat, N, 2)
    sweeps = (tiled[0], tiled[1], tiled[2], rand[0], rand[2])
    return {name: (*_rays(ray.o, ray.d, act, tmax), i not in (0, 3))
            for i, (name, (ray, act, tmax)) in enumerate(zip(SHAPES, sweeps))}


def bench_accel(dev):
    """The bench scene's refit BVH, built by whatever package is first on
    ``sys.path``."""
    from psdr_tpu_torch.scene.scene import detach_flat
    from psdr_tpu_torch.testing.scenes import cbox_scene
    sc = cbox_scene(**BENCH, device=dev)
    sc.prepare_accel()
    return detach_flat(sc.build(sc.params())).accel


def time_package(intersect, accel, rays):
    """K1 on every shape and K3 on the tiled camera chunk, through
    ``intersect``'s wrappers as they stand: ({shape: ms}, K3 ms, hits)."""
    k1, hits = {}, {}
    for name, (*args, any_hit) in rays.items():
        k1[name], hits[name] = time_ms(
            lambda: intersect.k1_cuda(accel, *args, any_hit=any_hit))
    k3, hits["k3"] = time_ms(
        lambda: intersect.k3_cuda(accel, *rays["tiled camera"][:4]))
    return k1, k3, hits


def parent_main(rays_file):
    """Runs with another checkout's package first on ``sys.path``: time
    its kernels on the saved rays and print one JSON line."""
    import psdr_tpu_torch
    from psdr_tpu_torch.accel import intersect
    dev = torch.device("cuda:0")
    rays = torch.load(rays_file, map_location=dev)
    k1, k3, _ = time_package(intersect, bench_accel(dev), rays)
    print(json.dumps({"package": os.path.dirname(psdr_tpu_torch.__file__),
                      "k1": k1, "k3": k3}), flush=True)
    return 0


def run_parent(parent, rays_file):
    """This file as a script, with ``parent``'s package on the path."""
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--rays", str(rays_file)],
        env=dict(os.environ, PYTHONPATH=str(parent)), cwd=parent,
        capture_output=True, text=True, timeout=600)
    if out.returncode:
        raise RuntimeError(f"parent run failed:\n{out.stdout}\n{out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def same(a, b, any_hit):
    fields = ("valid",) if any_hit else ("valid", "tri_id", "t", "uv")
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in fields)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--out", type=Path,
                    default=Path("build/bench_kernels.json"))
    ap.add_argument("--rays", type=Path, default=None,
                    help="time the package on the path on these saved rays")
    opts = ap.parse_args()
    if opts.rays is not None:
        return parent_main(opts.rays)
    if not torch.cuda.is_available():
        print("bench_kernels: needs a CUDA device", file=sys.stderr)
        return 1
    from psdr_tpu_torch.accel import intersect
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    lib_path = intersect.build_library()
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    rays = make_rays(dev)
    accel = bench_accel(dev)
    result = {"card": card, "rays": N, "k1": [], "k3": [], "k3_blockings": {},
              "parent": []}

    def parent():
        if opts.parent is not None:
            result["parent"].append(run_parent(opts.parent.resolve(),
                                               rays_file.resolve()))
            print(f"parent: {json.dumps(result['parent'][-1])}", flush=True)

    if opts.parent is not None:
        rays_file = Path("build/bench_rays.pt")
        rays_file.parent.mkdir(parents=True, exist_ok=True)
        torch.save(rays, rays_file)
    parent()
    for _ in range(2):
        k1, k3, hits = time_package(intersect, accel, rays)
        result["k1"].append(k1)
        result["k3"].append(k3)
        print("K1: " + ", ".join(f"{n} {t:.3f}" for n, t in k1.items())
              + f"; K3 {k3:.3f}", flush=True)
    for name, (*args, any_hit) in rays.items():
        if not same(hits[name], intersect.k1_plain(accel, *args), any_hit):
            raise AssertionError(f"K1 differs from k1_plain on {name}")
    print("K1 equals k1_plain on every shape", flush=True)
    for rb, tb in K3_BLOCKINGS:
        ms, hit = time_ms(lambda: intersect.k3_cuda(
            accel, *rays["tiled camera"][:4], ray_block=rb, tri_block=tb))
        if not same(hit, hits["tiled camera"], False):
            raise AssertionError(f"K3 at {rb}x{tb} differs from K1")
        result["k3_blockings"][f"{rb}x{tb}"] = ms
    print("K3, equal to K1: " + ", ".join(
        f"{n} {t:.3f}" for n, t in result["k3_blockings"].items()), flush=True)
    parent()
    opts.out.parent.mkdir(parents=True, exist_ok=True)
    opts.out.write_text(json.dumps(result, indent=1))
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
