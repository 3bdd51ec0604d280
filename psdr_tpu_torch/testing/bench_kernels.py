"""Time K1, K3 and the fixed-order sum on one GPU beside another
checkout's kernels on the same inputs.

    python3 -m psdr_tpu_torch.testing.bench_kernels [--parent DIR] [--out F]

The rays are the bench scene's (``cbox_scene(512, 512, spp=64,
occluder_subdiv=5)``, 20,492 triangles): the first 2^21-lane camera chunk
in tile order with the bounce and shadow sweeps from its hits, the shapes
the render path launches, and 2^21 rays through random pixels, the
incoherent case. K1's closest hits must equal ``k1_plain``'s bit for bit,
its any hits in ``valid``, and K3 must equal K1 at every blocking, or the
run fails. The fixed-order sum (``core/segsum.py``, ``csrc/segsum.cu``)
runs on ``segsum_cases``: the face-table gather of the camera chunk's hits
(2^21 lanes x 32 onto the 20,492 faces), hot and cold rows, the pixels,
the guiding masses and the occluder's vertex gather; each package sorts
with its own ``sort_keys`` and its kernel must equal its own
``segsum_plain`` and itself bit for bit (two trees may add in two orders).
Times are CUDA events over 20 launches, best of two runs (the sums' behind
a spin kernel, since a small one runs shorter than its host call); the
order is parent, this package, this package, parent. ``--parent`` names a
directory that holds another checkout of the repository (``git archive
<commit> | tar -x -C DIR``); its package is timed in a process of its own
(this file run as a script with ``--rays``) on the inputs this process
saved under ``build/``. Writes one JSON object to ``--out`` (default
``build/bench_kernels.json``) and prints a table.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

BENCH = dict(width=512, height=512, spp=64, occluder_subdiv=5)
N = 1 << 21
SHAPES = ("tiled camera", "tiled bounce", "tiled shadow", "random camera",
          "random shadow")          # closest, any, any, closest, any
K3_BLOCKINGS = ((512, 128), (128, 256), (256, 128), (128, 128), (1024, 128))
GUIDING_CELLS, GUIDING_SAMPLES = 216, 4    # chip_smoke.GUIDING's table
SPIN_CYCLES = 100_000_000
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, published


def time_ms(fn, reps=20, spin=False):
    """Best of two runs of ``reps`` launches, by CUDA events, and the last
    result; ``spin`` queues each run behind a spin kernel."""
    best = float("inf")
    out = fn()
    for _ in range(2):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
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


def segsum_cases(dev, faces, seed=31):
    """The fixed-order sum's synthetic shapes, ``chip_smoke.py`` phase 31's:
    {name: (idx (n,) int64, rows, values (n, c) float32, presorted)}: 2^21
    lanes onto ``faces`` rows x 32 with 2^20 lanes on row 0 and 2^19 on
    row 1 (hot) or spread evenly (cold); 131,072 pixel lanes x 3 onto
    65,536 rows, some dropped (-1); a guiding table's 864 lanes x 1 onto
    its 217 cells, already in cell order (no sort, no ``order``)."""
    gen = np.random.default_rng(seed)
    n = 1 << 21
    hot = np.concatenate([np.zeros(1 << 20), np.ones(1 << 19),
                          gen.integers(2, faces, n - (1 << 20) - (1 << 19))])
    shapes = (("hot rows", gen.permutation(hot), faces, 32, False),
              ("cold rows", gen.integers(0, faces, n), faces, 32, False),
              ("pixels", gen.integers(-1, 65536, 131072), 65536, 3, False),
              ("guiding masses", np.arange(GUIDING_CELLS * GUIDING_SAMPLES)
               // GUIDING_SAMPLES, GUIDING_CELLS + 1, 1, True))
    return {name: (torch.as_tensor(idx.astype(np.int64), device=dev), rows,
                   torch.as_tensor(gen.normal(size=(idx.size, c)).astype(
                       np.float32), device=dev), pre)
            for name, idx, rows, c, pre in shapes}


def segsum_bench_cases(dev, sc, hits):
    """``segsum_cases`` with the render path's own shapes ahead: the
    face-table gather of the tiled camera chunk's closest hits (2^21 x 32)
    and the occluder's vertex gather (its faces' corners x 3)."""
    gen = np.random.default_rng(13)
    faces = sum(m.num_faces for m in sc.meshes)
    tri = torch.where(hits.valid, hits.tri_id, -1).long()
    corners = torch.as_tensor(max(sc.meshes, key=lambda m: m.num_faces)
                              .faces.reshape(-1).astype(np.int64), device=dev)
    rows = int(corners.max()) + 1

    def normal(n, c):
        return torch.as_tensor(gen.normal(size=(n, c)).astype(np.float32),
                               device=dev)
    return {"main: face-table gather of the camera chunk": (
                tri, faces, normal(tri.numel(), 32), False),
            "vertex gather": (corners, rows, normal(corners.numel(), 3),
                              False),
            **segsum_cases(dev, faces)}


def segsum_bytes(n, rows, c, ordered):
    """Bytes the sum must move: keys (int32), the sort's order (int64) and
    the values read once, the rows written once."""
    return n * (4 + (8 if ordered else 0) + 4 * c) + rows * c * 4


def time_segsum(segsum, cases):
    """The package ``segsum`` (its ``core.segsum`` module) on ``cases``:
    {shape: {ms, sort_ms}}; raises unless its kernel equals its own plain
    version and itself bit for bit."""
    out = {}
    for name, (idx, rows, values, pre) in cases.items():
        sort_ms, (keys, order) = ((None, (idx.to(torch.int32), None)) if pre
                                  else time_ms(lambda: segsum.sort_keys(
                                      idx, rows), spin=True))
        ms, got = time_ms(lambda: segsum.segsum_cuda(keys, values, rows,
                                                     order), spin=True)
        if not (torch.equal(got, segsum.segsum_plain(keys, values, rows,
                                                     order))
                and torch.equal(got, segsum.segsum_cuda(keys, values, rows,
                                                        order))):
            raise AssertionError(f"segsum on {name}: the kernel differs "
                                 "from its plain version or from itself")
        out[name] = {"ms": ms, "sort_ms": sort_ms}
    return out


def library_segsum(cases):
    """Each shape's size, bound (by bytes: ``segsum_bytes`` at 3.35 TB/s)
    and ``index_add_`` time (the atomic library call for the same sum,
    dropped lanes clamped onto row 0, as ``chip_smoke.py`` phase 31)."""
    out = {}
    for name, (idx, rows, values, pre) in cases.items():
        n, c = values.shape
        lib_ms, _ = time_ms(lambda: torch.zeros(
            rows, c, device=values.device).index_add_(
                0, idx.clamp(min=0), values), spin=True)
        out[name] = {"lanes": n, "channels": c, "rows": rows,
                     "bound_ms": segsum_bytes(n, rows, c, not pre)
                     / HBM_BYTES_PER_S * 1e3, "library_ms": lib_ms}
    return out


def print_segsum(result):
    """The sums' table: this tree's and the parent's runs by shape."""
    runs = [("this", r) for r in result["segsum"]] + [
        ("parent", p["segsum"]) for p in result["parent"]]
    for name, info in result["segsum_shapes"].items():
        print(f"segsum {name} ({info['lanes']} x {info['channels']} onto "
              f"{info['rows']}; bound {info['bound_ms']:.4f} ms, index_add_ "
              f"{info['library_ms']:.4f}): " + ", ".join(
                  f"{tag} {r[name]['ms']:.4f} (sort {r[name]['sort_ms']})"
                  for tag, r in runs), flush=True)


def parent_main(rays_file):
    """Runs with another checkout's package first on ``sys.path``: time
    its kernels on the saved rays and print one JSON line."""
    import psdr_tpu_torch
    from psdr_tpu_torch.accel import intersect
    from psdr_tpu_torch.core import segsum
    dev = torch.device("cuda:0")
    saved = torch.load(rays_file, map_location=dev)
    k1, k3, _ = time_package(intersect, bench_accel(dev), saved["rays"])
    print(json.dumps({"package": os.path.dirname(psdr_tpu_torch.__file__),
                      "k1": k1, "k3": k3,
                      "segsum": time_segsum(segsum, saved["segsum"])}),
          flush=True)
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
    from psdr_tpu_torch.core import segsum
    from psdr_tpu_torch.testing.scenes import cbox_scene
    seg_cases = segsum_bench_cases(dev, cbox_scene(**BENCH, device=dev),
                                   intersect.k1_cuda(
                                       accel, *rays["tiled camera"][:4]))
    result = {"card": card, "rays": N, "k1": [], "k3": [], "k3_blockings": {},
              "segsum": [], "segsum_shapes": library_segsum(seg_cases),
              "parent": []}

    def parent():
        if opts.parent is not None:
            result["parent"].append(run_parent(opts.parent.resolve(),
                                               rays_file.resolve()))
            print(f"parent: {json.dumps(result['parent'][-1])}", flush=True)

    if opts.parent is not None:
        rays_file = Path("build/bench_rays.pt")
        rays_file.parent.mkdir(parents=True, exist_ok=True)
        torch.save({"rays": rays, "segsum": seg_cases}, rays_file)
    parent()
    for _ in range(2):
        k1, k3, hits = time_package(intersect, accel, rays)
        result["k1"].append(k1)
        result["k3"].append(k3)
        print("K1: " + ", ".join(f"{n} {t:.3f}" for n, t in k1.items())
              + f"; K3 {k3:.3f}", flush=True)
        result["segsum"].append(time_segsum(segsum, seg_cases))
        print("segsum: " + json.dumps(result["segsum"][-1]), flush=True)
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
    print_segsum(result)
    opts.out.parent.mkdir(parents=True, exist_ok=True)
    opts.out.write_text(json.dumps(result, indent=1))
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
