#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``psdr_tpu_torch``) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Every phase passes or the script exits nonzero:

1. the card: a CUDA device, its name and power limit (``nvidia-smi``);
   TF32 off for matmuls and convolutions;
2. build K1 (``psdr_tpu_torch/csrc/intersect.cu``) with ``nvcc``;
3. K1 against its plain PyTorch version on the card: a random triangle
   soup (2048 tris, 600 rays, mixed ``active`` and ``tmax``), then the bench
   scene (20,492 tris) on 2^16 camera rays, 2^16 cosine-bounce rays from
   their hits and 2^16 light-sample shadow rays; then both timed on one
   2^21-lane camera chunk and one 2^21-lane shadow sweep (the main path's
   shapes), and the timed runs' results compared the same way;
4. ``renderC`` on the card against ``renderC`` on the CPU (64x64, spp 4,
   1,292 tris), same key;
5. the main path at full width: ``DirectIntegrator(1, 1)`` forward through
   ``render_fn(with_boundary=False, detached=True)`` on
   ``cbox_scene(512, 512, spp=64, occluder_subdiv=5)``: one warm-up frame,
   three timed frames, then one profiled frame.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. No JAX is imported.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# the smoke drives one card: expose only the first unless the caller chose
os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
import torch  # noqa: E402  (after the device choice)

ROOT = os.path.dirname(os.path.abspath(__file__))
RTOL = 1e-5              # hit t and t-ties, as tests/test_bvh.py:43-50
IMG_RTOL, IMG_ATOL = 1e-4, 1e-5   # per-pixel, as tests/test_torch_render.py
IMG_CLOSE_FRAC = 0.99
IMG_MEAN_REL = 1e-4
BENCH = dict(width=512, height=512, spp=64, occluder_subdiv=5)
N_CHECK = 1 << 16       # rays per bench-scene comparison
N_TIME = 1 << 21        # rays per timed sweep: one pass_lanes chunk
DEVICE = "cuda:0"


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def check_hits(label, args, tris, hk, hp, any_hit):
    """Kernel record ``hk`` against plain record ``hp`` on the K1 inputs
    ``args`` (bvh, ray_o, ray_d, active, tmax) over triangles ``tris``
    (p0, e1, e2): ``valid`` exactly equal. Closest hit: same tri except at
    t-ties, t allclose to ``hp``'s. Any hit, where the walk may stop at
    another triangle than the closest: the plain Moller-Trumbore on the
    kernel's triangle accepts the hit and gives its t and uv. Returns
    (largest |t_kernel - t_plain| over hit lanes, lanes whose ``valid``
    differs)."""
    from psdr_tpu_torch.accel.bruteforce import _accept, moller_trumbore_tile
    vk, vp = hk.valid.cpu().numpy(), hp.valid.cpu().numpy()
    n_bad = int((vk != vp).sum())
    if n_bad:
        raise AssertionError(f"{label}: valid differs on {n_bad} lanes")
    if not vk.any():
        raise AssertionError(f"{label}: no lane hit, nothing to compare")
    tk = hk.t.cpu().numpy()[vk]
    if any_hit:
        _, ray_o, ray_d, _, tmax = args
        hit = hk.valid
        ids = hk.tri_id[hit].long()
        tri9 = tuple(x[ids, c] for x in tris for c in range(3))
        u, v, t = moller_trumbore_tile(
            *(ray_o[hit, c] for c in range(3)),
            *(ray_d[hit, c] for c in range(3)), tri9)
        if not bool(_accept(u, v, t, tmax[hit]).all()):
            raise AssertionError(f"{label}: a kernel hit fails the plain "
                                 "accept test")
        tp = t.cpu().numpy()
        np.testing.assert_allclose(hk.uv[hit].cpu().numpy(),
                                   torch.stack([u, v], -1).cpu().numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=label)
        what = "occluded, t against the plain MT on the kernel's triangle"
    else:
        tp = hp.t.cpu().numpy()[vp]
        same = hk.tri_id.cpu().numpy() == hp.tri_id.cpu().numpy()
        tie = np.isclose(hk.t.cpu().numpy(), hp.t.cpu().numpy(), rtol=RTOL)
        if not np.all(same | tie):
            raise AssertionError(f"{label}: tri_id differs off t-ties on "
                                 f"{int((~(same | tie)).sum())} lanes")
        what = f"hit, tri_id equal on {same[vk].mean():.6f} of hits"
    np.testing.assert_allclose(tk, tp, rtol=RTOL, err_msg=label)
    err = float(np.abs(tk - tp).max())
    log(f"  {label}: {vk.sum()} / {vk.size} {what}; valid equal, "
        f"max |dt| {err:.3g}")
    return err, n_bad


def time_ms(fn, reps: int, warmup: bool = True):
    """Mean device milliseconds of ``fn`` over ``reps`` back-to-back
    launches, by CUDA events, and the last launch's result."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def soup_case(intersect, bvh_mod, dev, record):
    """The tests/test_bvh.py:192-197 soup: 2048 tris, 600 rays."""
    from psdr_tpu_torch.scene.scene import BVH_LEAF_SIZE
    from psdr_tpu_torch.testing.scenes import triangle_soup
    p0, e1, e2, o, d, act, tmax = triangle_soup()
    topo = bvh_mod.build_bvh_topology(p0, e1, e2, leaf_size=BVH_LEAF_SIZE)
    t = [torch.as_tensor(x, device=dev) for x in (p0, e1, e2, o, d, act, tmax)]
    bvh = bvh_mod.refit_bvh(topo, *t[:3])
    args = (bvh, t[3], t[4], t[5], t[6])
    for any_hit in (False, True):
        mode = "any" if any_hit else "closest"
        record(mode, check_hits(f"soup {mode}", args, t[:3],
                                intersect.k1_cuda(*args, any_hit=any_hit),
                                intersect.k1_plain(*args), any_hit))


def bench_rays(pt, flat, n, seed, dev):
    """Camera rays of the bench scene, cosine-bounce rays from their hits
    and light-sample shadow rays, n each, from a numpy seed."""
    from psdr_tpu_torch.core.constants import ShadowEpsilon
    from psdr_tpu_torch.core.frame import to_world
    from psdr_tpu_torch.core.records import Ray
    from psdr_tpu_torch.core.warp import square_to_cosine_hemisphere
    from psdr_tpu_torch.integrator.direct import _emitter_meta
    from psdr_tpu_torch.scene.scene import (ray_intersect,
                                            sample_emitter_position)
    from psdr_tpu_torch.sensor.perspective import sample_primary_ray
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.uniform(size=(n, 6)).astype(np.float32),
                        device=dev)
    cam = sample_primary_ray(flat.sensors[0], u[:, 0:2])
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    its = ray_intersect(flat, cam, active)
    hit = its.valid
    bounce = Ray(its.p, to_world(its.sh_frame,
                                 square_to_cosine_hemisphere(u[:, 2:4])))
    ps = sample_emitter_position(flat, pt.face_offset, _emitter_meta(pt),
                                 its.p, u[:, 4:6], hit)
    wo = ps.p - its.p
    dist = torch.sqrt(torch.clamp((wo * wo).sum(-1), min=1e-20))
    shadow = Ray(its.p, wo / dist[:, None])
    return (cam, active, None), (bounce, hit, None), \
        (shadow, hit, dist - ShadowEpsilon)


def k1_phase(intersect, bvh_mod, dev):
    """Phase 3: K1 against its plain version on the soup and the bench
    scene, then both timed at the main path's shapes. Returns
    ({mode: [(max |dt|, valid mismatches), ...]}, {mode: (kernel ms,
    plain ms)})."""
    from psdr_tpu_torch.scene.scene import detach_flat
    from psdr_tpu_torch.testing.scenes import cbox_scene
    err = {"closest": [], "any": []}
    soup_case(intersect, bvh_mod, dev, lambda m, e: err[m].append(e))
    sc = cbox_scene(**BENCH, device=dev)
    sc.prepare_accel()
    flat = detach_flat(sc.build(sc.params()))
    tris = (flat.tri.p0, flat.tri.e1, flat.tri.e2)
    log(f"  bench scene: {flat.tri.p0.shape[0]} tris, "
        f"{flat.accel.num_leaves} leaves")

    def k1_args(ray, act, tmax):
        return (flat.accel, ray.o.contiguous(), ray.d.contiguous(), act,
                (torch.full_like(ray.o[:, 0], float("inf")) if tmax is None
                 else tmax.contiguous()))

    for label, rays in zip(("camera", "bounce", "shadow"),
                           bench_rays(sc, flat, N_CHECK, 1, dev)):
        for any_hit in ((False, True) if rays[2] is None else (True,)):
            mode = "any" if any_hit else "closest"
            args = k1_args(*rays)
            err[mode].append(check_hits(
                f"{label} {mode}", args, tris,
                intersect.k1_cuda(*args, any_hit=any_hit),
                intersect.k1_plain(*args), any_hit))
    # the main path's shapes: one 2^21-lane camera chunk and one 2^21-lane
    # shadow sweep, timed, and the results of the timed runs compared
    cam, _, shd = bench_rays(sc, flat, N_TIME, 2, dev)
    ms = {}
    for mode, label, args in (("closest", "camera chunk", k1_args(*cam)),
                              ("any", "shadow sweep", k1_args(*shd))):
        any_hit = mode == "any"
        # plain, kernel, kernel, plain
        p1, hp = time_ms(lambda: intersect.k1_plain(*args), 1)
        k1, hk = time_ms(
            lambda: intersect.k1_cuda(*args, any_hit=any_hit), 20)
        k2, _ = time_ms(lambda: intersect.k1_cuda(*args, any_hit=any_hit), 20)
        p2, _ = time_ms(lambda: intersect.k1_plain(*args), 1, warmup=False)
        ms[mode] = (min(k1, k2), min(p1, p2))
        log(f"  {N_TIME} rays, {label} ({mode}, {int(args[3].sum())} "
            f"active): kernel {k1:.3f} / {k2:.3f} ms, plain {p1:.1f} / "
            f"{p2:.1f} ms")
        err[mode].append(check_hits(f"{N_TIME} {label} {mode}", args, tris,
                                    hk, hp, any_hit))
    return err, ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if torch.cuda.device_count() != 1:
        print(f"chip_smoke: drives one card, {torch.cuda.device_count()} "
              "visible (set CUDA_VISIBLE_DEVICES to one)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from psdr_tpu_torch import DirectIntegrator
    from psdr_tpu_torch.accel import bvh as bvh_mod
    from psdr_tpu_torch.accel import intersect
    from psdr_tpu_torch.core import threefry
    from psdr_tpu_torch.testing.scenes import cbox_scene

    # -- 1. the card --------------------------------------------------------
    card = card_line()
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # -- 2. build K1 ----------------------------------------------------------
    t0 = time.time()
    lib_path = intersect.build_library()
    intersect.load_library()
    log(f"phase 2: K1 built in {time.time() - t0:.1f} s -> "
        f"{os.path.relpath(lib_path, ROOT)}")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # -- 3. K1 against its plain version -----------------------------------
    log("phase 3: K1 kernel vs plain PyTorch version on the card")
    # a function of its own, so that its tensors are freed before phase 5
    # reads the peak memory
    err, ms = k1_phase(intersect, bvh_mod, dev)

    # -- 4. the port on the card against the port on the CPU ------------------
    log("phase 4: renderC on the card vs on the CPU (64x64, spp 4)")
    imgs = []
    for d in (dev, torch.device("cpu")):
        s = cbox_scene(64, 64, spp=4, occluder_subdiv=3, device=d)
        imgs.append(DirectIntegrator(1, 1).renderC(s, seed=7).cpu().numpy())
    close = np.isclose(imgs[0], imgs[1], rtol=IMG_RTOL,
                       atol=IMG_ATOL).all(axis=-1)
    mean_rel = abs(imgs[0].mean() - imgs[1].mean()) / abs(imgs[1].mean())
    log(f"  {close.mean():.6f} of pixels close (rtol {IMG_RTOL}, atol "
        f"{IMG_ATOL}), image means {imgs[0].mean():.6f} / "
        f"{imgs[1].mean():.6f}, relative difference {mean_rel:.3g}")
    if close.mean() < IMG_CLOSE_FRAC or mean_rel >= IMG_MEAN_REL:
        raise AssertionError("phase 4: card and CPU renders disagree")

    # -- 5. the main path at full width --------------------------------------
    log("phase 5: DirectIntegrator(1, 1) forward, 512x512, spp 64, "
        f"reuse {os.environ.get('PSDR_TPU_VIS_REUSE', 'edge')}")
    sc = cbox_scene(**BENCH, device=dev)
    render = DirectIntegrator(1, 1).render_fn(sc, with_boundary=False,
                                              detached=True)
    params = sc.params()
    img = render(params, threefry.PRNGKey(0))            # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    intersect.reset_launch_counts()
    times = []
    for i in range(3):
        t0 = time.perf_counter()
        img = render(params, threefry.PRNGKey(i + 1))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(intersect.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    img = img.cpu().numpy()
    if (img.shape != (BENCH["width"] * BENCH["height"], 3)
            or not np.isfinite(img).all()):
        raise AssertionError("phase 5: image not finite or misshapen")
    if not img.mean() > 0.0:
        raise AssertionError("phase 5: image mean is not positive")
    if launches["closest"] == 0 or launches["any"] == 0:
        raise AssertionError(f"phase 5: K1 not launched in both modes "
                             f"({launches})")
    rays = BENCH["width"] * BENCH["height"] * BENCH["spp"] * 3
    dt = float(np.median(times))
    log(f"  frames {', '.join(f'{t:.3f}' for t in times)} s; median {dt:.3f}"
        f" s -> {rays / dt / 1e6:.2f} M rays/s; image mean {img.mean():.6f};"
        f" peak memory {peak / 2**30:.2f} GiB; K1 launches over 3 frames "
        f"{launches}")

    # where the time goes: one profiled frame, device time by kernel
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render(params, threefry.PRNGKey(9))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    k1_dev = sum(e.self_device_time_total for e in kern
                 if "k1_kernel" in e.key) / 1e3
    log(f"  profiled frame: wall {wall:.1f} ms, device busy {busy:.1f} ms "
        f"(idle {1 - busy / wall:.3f} of wall), K1 {k1_dev:.2f} ms, "
        f"{sum(e.count for e in kern)} kernel launches; top kernels:")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"    {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.count:6d}x  {e.key[:100]}")
    # the random stream: one chunk's (n, 3) uniform draw in tensor code
    key = threefry.PRNGKey(1)
    rng_ms, _ = time_ms(lambda: threefry.uniform(key, (N_TIME, 3), dev), 5)
    log(f"  threefry uniform of ({N_TIME}, 3): {rng_ms:.2f} ms")

    kernels = [{
        "name": f"ray_intersect_k1 ({mode} hit)",
        "route": "cuda",
        "source": "psdr_tpu_torch/csrc/intersect.cu",
        "replaces": "psdr_tpu/accel/pallas_kernel.py:678",
        "launches": launches[mode],
        # |t| error of the hits: closest against k1_plain's hit, any against
        # the plain Moller-Trumbore on the kernel's triangle
        "max_abs_err": max(e for e, _ in err[mode]),
        "valid_mismatches": sum(n for _, n in err[mode]),
        "ms": ms[mode][0],
        "plain_ms": ms[mode][1],
    } for mode in ("closest", "any")]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
