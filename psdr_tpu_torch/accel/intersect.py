"""The scene-intersection kernels and their plain PyTorch versions. Each
returns a ``HitRecord`` for rays with t in (RayEpsilon, tmax):

* K1, ``ray_intersect_k1``: closest or any hit against the refit BVH
  (``accel/bvh.py``). Replaces ``psdr_tpu/accel/pallas_kernel.py``
  ``ray_intersect_pallas_culled2``. Kernel ``csrc/intersect.cu``: one
  thread per ray walks the tree's 4-wide nodes (``BVH.wide``), nearest
  child first, with a stack in shared memory. Plain version ``k1_plain``,
  which mirrors the JAX package's ``ray_intersect_culled``
  (``psdr_tpu/accel/bvh.py``): a slab cull of each ray block against the
  leaf-block AABBs, then a dense Moller-Trumbore over the occupied (ray
  block, leaf block) pairs. ``k1_walk_plain`` is the kernel's own walk in
  lockstep tensor code, visit order, cull margin and tie rule included;
  tests hold it against ``k1_plain``, and no entry point dispatches to it.
* K2, ``ray_intersect_brute``: dense closest hit, every ray against every
  triangle. Replaces ``ray_intersect_pallas``. Kernel ``csrc/brute.cu``;
  plain version ``bruteforce.brute_plain``.
* K3, ``ray_intersect_k3``: block-culled dense closest hit in one kernel:
  a CTA per ray block slab-tests its rays against each leaf block's AABB,
  votes, and sweeps the blocks that a ray enters, in ascending order.
  Replaces ``ray_intersect_pallas_culled``. Kernel ``csrc/culled.cu``;
  plain version ``k1_plain``, whose contract it shares.

Each entry point dispatches on the device of the rays: CPU tensors take
the plain version, CUDA tensors launch the kernel, which is built with
``nvcc`` for ``sm_90a`` at first use and loaded through ``ctypes``; a
failed build or launch raises. Closest hits go to the lowest t, ties to
the lowest triangle id (K2) or padded slot (K1, K3); in any-hit mode K1
returns the first hit its walk accepts, so only ``valid`` is comparable
there.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from .. import profiling
from ..core.constants import RayEpsilon
from .bruteforce import HitRecord, _accept, brute_plain, moller_trumbore_tile
from .bvh import BVH, wide_layout

_INF = float("inf")

# Launches of each CUDA kernel (K1 by mode), counted where its wrapper
# launches it and nowhere else (chip_smoke.py reads them to show the path
# ran the kernels): the counters ``launches.<key>`` of ``profiling``.
# ``segsum`` is the fixed-order reduction of ``core/segsum.py`` (one count a
# level's launch), built into the same library.
LAUNCHES = profiling.CounterGroup(
    "launches", ("closest", "any", "k2", "k3", "segsum"))
# Launches of the random stream's kernels (``csrc/rng.cu``, in the same
# library: ``core/threefry.py``'s draws and key derivations,
# ``core/sampler.py``'s (0,2)-points and pixel scrambles), one count a
# launch: the counter ``launches.rng``. Apart from ``LAUNCHES``, whose
# counts are the same for a render under a host key and under a key on
# the card; this one is not, since host words derive keys on the host.
RNG_LAUNCHES = profiling.CounterGroup("launches", ("rng",))


def reset_launch_counts() -> None:
    for group in (LAUNCHES, RNG_LAUNCHES):
        for k in group:
            group[k] = 0


def _rays(ray_o, ray_d, active, tmax):
    """Detached, contiguous float32 rays, bool ``active`` and (N,) tmax."""
    n = ray_o.shape[0]
    dev = ray_o.device
    ray_o = ray_o.detach().float().contiguous()
    ray_d = ray_d.detach().float().contiguous()
    active = (torch.ones((n,), dtype=torch.bool, device=dev) if active is None
              else active.detach().to(torch.bool).contiguous())
    tmax = (torch.full((n,), _INF, device=dev) if tmax is None
            else torch.broadcast_to(tmax.detach().float(), (n,)).contiguous())
    return ray_o, ray_d, active, tmax


def _device_of(ray_o, name):
    dev = ray_o.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {dev}")
    return dev.type


@profiling.span("intersect")
def ray_intersect_k1(bvh: BVH, ray_o: torch.Tensor, ray_d: torch.Tensor,
                     active: torch.Tensor | None = None,
                     tmax: torch.Tensor | None = None,
                     any_hit: bool = False) -> HitRecord:
    """Closest hit (or, with ``any_hit``, some hit) with t in
    (RayEpsilon, tmax) for every active ray."""
    args = (bvh, *_rays(ray_o, ray_d, active, tmax))
    if _device_of(ray_o, "K1") == "cuda":
        return k1_cuda(*args, any_hit)
    return k1_plain(*args)


@profiling.span("intersect")
def ray_intersect_brute(p0: torch.Tensor, e1: torch.Tensor, e2: torch.Tensor,
                        ray_o: torch.Tensor, ray_d: torch.Tensor,
                        active: torch.Tensor | None = None,
                        tmax: torch.Tensor | None = None) -> HitRecord:
    """K2: closest hit over all triangles (p0/e1/e2: (F, 3)) with t in
    (RayEpsilon, tmax); ties in t go to the lowest triangle id."""
    tris = tuple(x.detach().float().contiguous() for x in (p0, e1, e2))
    args = (*tris, *_rays(ray_o, ray_d, active, tmax))
    if _device_of(ray_o, "K2") == "cuda":
        return k2_cuda(*args)
    return brute_plain(*args)


@profiling.span("intersect")
def ray_intersect_k3(bvh: BVH, ray_o: torch.Tensor, ray_d: torch.Tensor,
                     active: torch.Tensor | None = None,
                     tmax: torch.Tensor | None = None,
                     ray_block: int = 512, tri_block: int = 128) -> HitRecord:
    """K3: block-culled closest hit with t in (RayEpsilon, tmax), with
    ``ray_block`` rays per culled block and ``tri_block`` triangle slots
    per leaf block. The result equals ``k1_plain``'s."""
    args = (bvh, *_rays(ray_o, ray_d, active, tmax))
    if _device_of(ray_o, "K3") == "cuda":
        return k3_cuda(*args, ray_block=ray_block, tri_block=tri_block)
    return k1_plain(*args)


# -- the CUDA kernels -----------------------------------------------------------

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_SOURCES = (_CSRC / "intersect.cu", _CSRC / "brute.cu", _CSRC / "culled.cu",
            _CSRC / "segsum.cu", _CSRC / "rng.cu", _CSRC / "stamp.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "psdr_tpu_torch"
_LIB = None


def _find_nvcc() -> str | None:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    return None


def build_library(nvcc: str | None = None) -> Path:
    """Compile ``csrc/*.cu`` (K1, K2, K3, ``core/segsum.py``'s reduction,
    the random stream's kernels and ``Program.profile_layers``' timestamp),
    one ``nvcc`` per source, all
    started together, and link them into one library,
    ``build/psdr_tpu_torch/<hash of the sources and flags>/
    libpsdr_kernels.so``, unless that file exists. Each source's
    ``nvcc -Xptxas -v`` output goes to ``build.log`` beside it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _SOURCES:
        h.update(src.read_bytes())
    out = BUILD_ROOT / h.hexdigest()[:16] / "libpsdr_kernels.so"
    if out.exists():
        return out
    nvcc = nvcc or _find_nvcc()
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError(
            "the intersection kernels need nvcc (the CUDA toolkit) to build "
            f"csrc/*.cu; none found (looked for {nvcc or 'nvcc on PATH'})")
    out.parent.mkdir(parents=True, exist_ok=True)
    # nvcc reads a file's type from its extension: objects end in .o
    objs = [out.with_name(f"{src.stem}.{os.getpid()}.o") for src in _SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c",
                               "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(_SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    link = None
    if all(p.returncode == 0 for p in procs):
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                               str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
    (out.parent / "build.log").write_text("\n".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link is None or link.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
    os.replace(tmp, out)
    return out


def load_library(nvcc: str | None = None) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _LIB
    if _LIB is None:
        with profiling.span("accel.load_library"):
            lib = ctypes.CDLL(str(build_library(nvcc)))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.psdr_k1_intersect.argtypes = (
                [ptr, i32, i32, i32] + [ptr] * 3 + [i32] + [ptr] * 4
                + [i32, i32] + [ptr] * 3 + [ptr, ptr])
            lib.psdr_k2_brute.argtypes = (
                [ptr] * 3 + [i32] + [ptr] * 4 + [i32] + [ptr] * 3 + [ptr])
            lib.psdr_k3_culled.argtypes = (
                [ptr] * 5 + [i32] * 4 + [ptr] * 4 + [i32] + [ptr] * 3 + [ptr])
            lib.psdr_segsum.argtypes = (
                [ptr] * 3 + [i32] * 2 + [ptr, i32] + [ptr] * 3)
            u32, i64 = ctypes.c_uint32, ctypes.c_int64
            lib.psdr_threefry.argtypes = (
                [ptr, u32, u32, u32, i64, i32, ptr, ptr])
            lib.psdr_randint.argtypes = (
                [ptr, u32, u32, i64, u32, u32, i32, ptr, ptr])
            lib.psdr_ld2d.argtypes = (
                [ptr, ptr, i64, ptr, u32, u32, ptr, ptr])
            lib.psdr_stamp.argtypes = [ptr, i32, ptr]
            for fn in (lib.psdr_k1_intersect, lib.psdr_k2_brute,
                       lib.psdr_k3_culled, lib.psdr_segsum,
                       lib.psdr_threefry, lib.psdr_randint, lib.psdr_ld2d,
                       lib.psdr_stamp):
                fn.restype = i32
            _LIB = lib
    return _LIB


def _check(kernel, specs, device):
    """Raise unless every (name, tensor, dtype, shape) of ``specs`` lies on
    ``device`` with that dtype and shape, contiguous."""
    for name, x, dtype, shape in specs:
        if x.device != device:
            raise ValueError(f"{kernel}: {name} is on {x.device}, "
                             f"expected {device}")
        if x.dtype != dtype:
            raise ValueError(f"{kernel}: {name} has dtype {x.dtype}, "
                             f"expected {dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} has shape "
                             f"{tuple(x.shape)}, expected {tuple(shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def _ray_specs(ray_o, ray_d, active, tmax):
    n = ray_o.shape[0]
    if n >= (1 << 31):
        raise ValueError("the kernels index rays with int32")
    return [("ray_o", ray_o, torch.float32, (n, 3)),
            ("ray_d", ray_d, torch.float32, (n, 3)),
            ("tmax", tmax, torch.float32, (n,)),
            ("active", active, torch.bool, (n,))]


def _bvh_specs(bvh):
    P, L = bvh.num_leaves, bvh.leaf_size
    if P * L >= (1 << 31):
        raise ValueError("the kernels index slots with int32")
    return [("nodes", bvh.nodes, torch.float32, (2 * P, 6)),
            ("node_mask", bvh.node_mask, torch.bool, (2 * P,)),
            ("wide", bvh.wide, torch.float32,
             (max(wide_layout(P).nodes, 1), 32)),
            ("leaf_tris", bvh.leaf_tris, torch.float32, (P, 9 * L)),
            ("tri_valid", bvh.tri_valid, torch.bool, (P, L)),
            ("perm", bvh.perm, torch.int32, (P * L,))]


def _cuda_device(kernel, ray_o):
    dev = ray_o.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel} takes CUDA tensors, got {dev}")
    return dev


def _launch(kernel, fn, *args, dev):
    """Call the C launcher ``fn`` on ``dev``'s current stream; raise unless
    it returns cudaSuccess."""
    with torch.cuda.device(dev):   # the launch goes to the current device
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaGetLastError() = "
                           f"{err}")


def _outputs(n, dev):
    return (torch.empty((n,), dtype=torch.float32, device=dev),
            torch.empty((n,), dtype=torch.int32, device=dev),
            torch.empty((n, 2), dtype=torch.float32, device=dev))


def k1_cuda(bvh: BVH, ray_o: torch.Tensor, ray_d: torch.Tensor,
            active: torch.Tensor, tmax: torch.Tensor,
            any_hit: bool = False,
            counts: torch.Tensor | None = None) -> HitRecord:
    """Launch K1 (``csrc/intersect.cu``) on the current stream. With
    ``counts``, a (4,) int64 CUDA tensor, the launch is the kernel's
    counting instantiation, which adds to it the rays' slab tests and their
    triangle tests left after u, left after v and run in full (a
    measurement; no entry point passes it)."""
    dev = _cuda_device("k1_cuda", ray_o)
    specs = _bvh_specs(bvh) + _ray_specs(ray_o, ray_d, active, tmax)
    if counts is not None:
        specs.append(("counts", counts, torch.int64, (4,)))
    _check("K1", specs, dev)
    n = ray_o.shape[0]
    wide = wide_layout(bvh.num_leaves)
    lib = load_library()
    t, tri, uv = _outputs(n, dev)
    if n == 0:
        return HitRecord(valid=tri >= 0, tri_id=tri, uv=uv, t=t)
    _launch("K1", lib.psdr_k1_intersect, bvh.wide.data_ptr(), wide.nodes,
            wide.roots, wide.levels, bvh.leaf_tris.data_ptr(),
            bvh.tri_valid.data_ptr(), bvh.perm.data_ptr(), bvh.leaf_size,
            ray_o.data_ptr(), ray_d.data_ptr(), tmax.data_ptr(),
            active.data_ptr(), n, int(bool(any_hit)), t.data_ptr(),
            tri.data_ptr(), uv.data_ptr(),
            None if counts is None else counts.data_ptr(), dev=dev)
    LAUNCHES["any" if any_hit else "closest"] += 1
    profiling.count("k1.rays", n)
    return HitRecord(valid=tri >= 0, tri_id=tri, uv=uv, t=t)


def k2_cuda(p0: torch.Tensor, e1: torch.Tensor, e2: torch.Tensor,
            ray_o: torch.Tensor, ray_d: torch.Tensor, active: torch.Tensor,
            tmax: torch.Tensor) -> HitRecord:
    """Launch K2 (``csrc/brute.cu``) on the current stream."""
    dev = _cuda_device("k2_cuda", ray_o)
    f = p0.shape[0]
    if f >= (1 << 31):
        raise ValueError("K2 indexes triangles with int32")
    _check("K2", [(name, x, torch.float32, (f, 3))
                  for name, x in (("p0", p0), ("e1", e1), ("e2", e2))]
           + _ray_specs(ray_o, ray_d, active, tmax), dev)
    n = ray_o.shape[0]
    lib = load_library()
    t, tri, uv = _outputs(n, dev)
    if n == 0:
        return HitRecord(valid=tri >= 0, tri_id=tri, uv=uv, t=t)
    _launch("K2", lib.psdr_k2_brute, p0.data_ptr(), e1.data_ptr(),
            e2.data_ptr(), f, ray_o.data_ptr(), ray_d.data_ptr(),
            tmax.data_ptr(), active.data_ptr(), n, t.data_ptr(),
            tri.data_ptr(), uv.data_ptr(), dev=dev)
    LAUNCHES["k2"] += 1
    return HitRecord(valid=tri >= 0, tri_id=tri, uv=uv, t=t)


def k3_cuda(bvh: BVH, ray_o: torch.Tensor, ray_d: torch.Tensor,
            active: torch.Tensor, tmax: torch.Tensor, ray_block: int = 512,
            tri_block: int = 128) -> HitRecord:
    """Launch K3 (``csrc/culled.cu``) on the current stream: one CTA of
    ``ray_block`` threads per ray block, which culls and sweeps the leaf
    blocks of ``tri_block`` slots in ascending order."""
    dev = _cuda_device("k3_cuda", ray_o)
    _check("K3", _bvh_specs(bvh) + _ray_specs(ray_o, ray_d, active, tmax),
           dev)
    if not 32 <= ray_block <= 1024 or ray_block % 32:
        raise ValueError("K3: ray_block must be a multiple of 32 in "
                         "[32, 1024]")
    P, L = bvh.num_leaves, bvh.leaf_size
    T = min(tri_block, P * L)
    if T % L or (P * L) % T:
        raise ValueError("K3: tri_block must be a multiple of the leaf size "
                         "that divides the padded slot count")
    n = ray_o.shape[0]
    lib = load_library()
    t, tri, uv = _outputs(n, dev)
    if n == 0:
        return HitRecord(valid=tri >= 0, tri_id=tri, uv=uv, t=t)
    _launch("K3", lib.psdr_k3_culled, bvh.nodes.data_ptr(),
            bvh.node_mask.data_ptr(), bvh.leaf_tris.data_ptr(),
            bvh.tri_valid.data_ptr(), bvh.perm.data_ptr(), L, T, P * L // T,
            ray_block, ray_o.data_ptr(), ray_d.data_ptr(), tmax.data_ptr(),
            active.data_ptr(), n, t.data_ptr(), tri.data_ptr(), uv.data_ptr(),
            dev=dev)
    LAUNCHES["k3"] += 1
    return HitRecord(valid=tri >= 0, tri_id=tri, uv=uv, t=t)


# -- the plain PyTorch version of K1 and K3 --------------------------------------

def _tri_comps_at(bvh: BVH, slot: torch.Tensor):
    """The 9 triangle components (p0, e1, e2) of padded slots ``slot``."""
    L = bvh.leaf_size
    leaf, j = slot // L, slot % L
    return tuple(bvh.leaf_tris[leaf, c * L + j] for c in range(9))


# k1_plain's blocking: R rays per ray block, T triangles per leaf block,
# and caps on the elements of the cull's and the pair sweep's temporaries
RAY_BLOCK = 2048
TRI_BLOCK = 512
CULL_ELEMS = 1 << 23
PAIR_ELEMS = 1 << 23


def _block_cull(bvh: BVH, ray_o, ray_d, active, tmax, R: int, T: int):
    """Slab cull of each block of ``R`` rays against the AABBs of the
    leaf blocks of ``T`` slots (the heap level with ``P*L/T`` nodes), over
    (RayEpsilon, tmax), a group of ray blocks at a time. Returns the rays
    padded and reshaped to (n_rb, R, ...) as (o, d, active, tmax) and the
    (n_rb, B) occupancy."""
    n = ray_o.shape[0]
    dev = ray_o.device
    P, L = bvh.num_leaves, bvh.leaf_size
    B = max(1, P * L // T)
    blo, bhi = bvh.nodes[B:2 * B, :3], bvh.nodes[B:2 * B, 3:]
    block_mask = bvh.node_mask[B:2 * B]
    n_rb = -(-n // R)
    pad = n_rb * R - n
    o = torch.nn.functional.pad(ray_o, (0, 0, 0, pad)).reshape(n_rb, R, 3)
    d = torch.nn.functional.pad(ray_d, (0, 0, 0, pad)).reshape(n_rb, R, 3)
    act = torch.nn.functional.pad(active, (0, pad)).reshape(n_rb, R)
    tm = torch.nn.functional.pad(tmax, (0, pad)).reshape(n_rb, R)
    small = torch.abs(d) < 1e-20
    inv_d = 1.0 / torch.where(small, torch.where(d < 0, -1e-20, 1e-20), d)
    occupied = torch.zeros((n_rb, B), dtype=torch.bool, device=dev)
    g = max(1, CULL_ELEMS // (R * B))
    for s in range(0, n_rb, g):
        sl = slice(s, s + g)
        tn = torch.full((1, 1, 1), RayEpsilon, device=dev)
        tf = tm[sl, :, None]
        for c in range(3):
            oc, ic = o[sl, :, c:c + 1], inv_d[sl, :, c:c + 1]
            t0 = (blo[None, None, :, c] - oc) * ic
            t1 = (bhi[None, None, :, c] - oc) * ic
            tn = torch.maximum(tn, torch.minimum(t0, t1))
            tf = torch.minimum(tf, torch.maximum(t0, t1))
        occupied[sl] = (((tn <= tf) & act[sl, :, None]).any(dim=1)
                        & block_mask[None, :])
    return o, d, act, tm, occupied


def k1_plain(bvh: BVH, ray_o: torch.Tensor, ray_d: torch.Tensor,
             active: torch.Tensor, tmax: torch.Tensor) -> HitRecord:
    """Block-culled dense closest hit in tensor code.

    ``_block_cull`` marks the occupied (ray block, leaf block) pairs; each
    then runs a dense (R, T) Moller-Trumbore, batched over pairs. Each lane
    keeps the smallest (t, slot) key over its pairs: the closest hit, ties
    to the lowest slot, as a sequential sweep in block order would give.
    The winner's (u, v, t) are recomputed by the same arithmetic."""
    n = ray_o.shape[0]
    dev = ray_o.device
    P, L = bvh.num_leaves, bvh.leaf_size
    T = min(TRI_BLOCK, P * L)
    B = max(1, P * L // T)
    # (P, 9L) -> (B, leaves/block, 9, L) -> (B, 9, T)
    tri_rows = (bvh.leaf_tris.reshape(B, P // B, 9, L)
                .permute(0, 2, 1, 3).reshape(B, 9, T))
    valid_rows = bvh.tri_valid.reshape(B, T)
    R = min(RAY_BLOCK, max(8, n))
    o, d, act, tm, occupied = _block_cull(bvh, ray_o, ray_d, active, tmax,
                                          R, T)
    n_rb = occupied.shape[0]

    # --- dense MT over occupied pairs; key = (t bits << 32) | slot
    none = torch.iinfo(torch.int64).max
    key = torch.full((n_rb, R), none, dtype=torch.int64, device=dev)
    pairs = torch.nonzero(occupied)
    k = max(1, PAIR_ELEMS // (R * T))
    for s in range(0, pairs.shape[0], k):
        rb, bb = pairs[s:s + k, 0], pairs[s:s + k, 1]
        oc, dc = o[rb], d[rb]                                # (k, R, 3)
        tri9 = tuple(tri_rows[bb, c][:, None, :] for c in range(9))
        u, v, t = moller_trumbore_tile(
            *(oc[..., c:c + 1] for c in range(3)),
            *(dc[..., c:c + 1] for c in range(3)), tri9)     # (k, R, T)
        ok = (_accept(u, v, t, tm[rb][..., None])
              & valid_rows[bb][:, None, :] & act[rb][..., None])
        t_m = torch.where(ok, t, _INF)
        j = torch.argmin(t_m, dim=2, keepdim=True)
        t_c = torch.gather(t_m, 2, j)[..., 0]
        slot = bb[:, None] * T + j[..., 0]
        k_c = torch.where(
            t_c < _INF,
            (t_c.view(torch.int32).to(torch.int64) << 32) | slot, none)
        key.scatter_reduce_(0, rb[:, None].expand(-1, R), k_c, "amin")

    key = key.reshape(-1)[:n]
    valid = key != none
    slot = torch.where(valid, key & 0xFFFFFFFF, 0)
    ox, oy, oz = ray_o.unbind(-1)
    dx, dy, dz = ray_d.unbind(-1)
    u, v, t = moller_trumbore_tile(ox, oy, oz, dx, dy, dz,
                                   _tri_comps_at(bvh, slot))
    tri_id = torch.where(valid, bvh.perm[slot], -1)
    zero = torch.zeros_like(u)
    return HitRecord(valid=valid, tri_id=tri_id,
                     uv=torch.stack([torch.where(valid, u, zero),
                                     torch.where(valid, v, zero)], dim=-1),
                     t=torch.where(valid, t, _INF))


# -- K1's walk in tensor code ------------------------------------------------------

CULL_MARGIN = 1.0001     # kCullMargin of csrc/intersect.cu
_MISS = 0x7FFFFFFF


def k1_walk_plain(bvh: BVH, ray_o: torch.Tensor, ray_d: torch.Tensor,
                  active: torch.Tensor, tmax: torch.Tensor,
                  any_hit: bool = False) -> HitRecord:
    """The walk of ``csrc/intersect.cu`` with every ray in lockstep: the
    4-wide nodes of ``bvh.wide``, the children a ray enters over
    (RayEpsilon, CULL_MARGIN * best t) ordered by the bits of their entry
    distance, the nearest walked next and the others stacked with that
    distance and dropped when popped beyond the best t, and a hit taken at
    a smaller t or at an equal t and a lower slot. In closest-hit mode the
    record equals ``k1_plain``'s bit for bit, unless a hit's computed t
    lies more than the margin below the distance at which the ray enters
    the triangle's boxes (badly conditioned grazing rays from far away:
    the note on ties in ``csrc/intersect.cu``); with ``any_hit`` a ray
    stops at the first hit it takes, and ``valid`` equals ``k1_plain``'s."""
    n = ray_o.shape[0]
    dev = ray_o.device
    L = bvh.leaf_size
    wide = wide_layout(bvh.num_leaves)
    W = wide.nodes
    small = torch.abs(ray_d) < 1e-20
    inv_d = 1.0 / torch.where(small, torch.where(ray_d < 0, -1e-20, 1e-20),
                              ray_d)
    o3, d3 = ray_o.unbind(-1), ray_d.unbind(-1)
    cap = 3 * wide.levels + wide.roots
    stack_id = torch.zeros((n, cap), dtype=torch.int64, device=dev)
    stack_tn = torch.full((n, cap), RayEpsilon, device=dev)
    # ids below W are wide nodes, the others leaves (id - W); -1: pop next
    cur = torch.where(active, 0, -1)
    sp = torch.zeros((n,), dtype=torch.int64, device=dev)
    if wide.roots == 2:
        stack_id[:, 0] = 1
        sp = active.to(torch.int64)
    t_best = tmax.clone()
    slot_best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    u_best = torch.zeros((n,), device=dev)
    v_best = torch.zeros((n,), device=dev)
    child_no = torch.arange(4, device=dev)

    while True:
        r = torch.nonzero((cur < 0) & (sp > 0))[:, 0]
        if r.numel() == 0 and not bool((cur >= 0).any()):
            break
        if r.numel():                                          # pop
            sp[r] -= 1
            beyond = stack_tn[r, sp[r]] > t_best[r] * CULL_MARGIN
            cur[r] = torch.where(beyond, -1, stack_id[r, sp[r]])
        r = torch.nonzero(cur >= W)[:, 0]
        if r.numel():                                          # a leaf
            leaf = cur[r] - W
            cur[r] = -1
            taken = torch.zeros_like(leaf, dtype=torch.bool)
            for j in range(L):
                slot = leaf * L + j
                u, v, t = moller_trumbore_tile(
                    *(x[r] for x in o3), *(x[r] for x in d3),
                    tuple(bvh.leaf_tris[leaf, c * L + j] for c in range(9)))
                take = (_accept(u, v, t, tmax[r]) & bvh.tri_valid[leaf, j]
                        & ((t < t_best[r])
                           | ((t == t_best[r]) & (slot < slot_best[r]))))
                if any_hit:
                    take &= ~taken
                t_best[r] = torch.where(take, t, t_best[r])
                u_best[r] = torch.where(take, u, u_best[r])
                v_best[r] = torch.where(take, v, v_best[r])
                slot_best[r] = torch.where(take, slot, slot_best[r])
                taken |= take
            if any_hit:
                sp[r[taken]] = 0
        r = torch.nonzero((cur >= 0) & (cur < W))[:, 0]
        if r.numel():                                          # a wide node
            rec = bvh.wide[cur[r]]
            lo, hi = rec[:, 0:12].reshape(-1, 3, 4), rec[:, 12:24].reshape(
                -1, 3, 4)
            tn = torch.full((r.numel(), 4), RayEpsilon, device=dev)
            tf = (t_best[r] * CULL_MARGIN)[:, None].expand(-1, 4)
            for c in range(3):
                oc, ic = ray_o[r, c, None], inv_d[r, c, None]
                t0, t1 = (lo[:, c] - oc) * ic, (hi[:, c] - oc) * ic
                tn = torch.maximum(tn, torch.minimum(t0, t1))
                tf = torch.minimum(tf, torch.maximum(t0, t1))
            enters = (rec[:, 24:28] != 0) & (tn <= tf)
            bits = tn.contiguous().view(torch.int32).to(torch.int64)
            key = torch.where(enters, (bits & ~3) | child_no, _MISS)
            key = torch.sort(key, dim=1).values      # nearest first, misses last
            child0 = 4 * cur[r] + wide.roots
            for q in (3, 2, 1):
                m = key[:, q] != _MISS
                rq, kq = r[m], key[m, q]
                stack_id[rq, sp[rq]] = child0[m] + (kq & 3)
                stack_tn[rq, sp[rq]] = (kq & ~3).to(torch.int32).view(
                    torch.float32)
                sp[rq] += 1
            cur[r] = torch.where(key[:, 0] != _MISS,
                                 child0 + (key[:, 0] & 3), -1)

    valid = slot_best >= 0
    slot = torch.where(valid, slot_best, 0)
    return HitRecord(valid=valid,
                     tri_id=torch.where(valid, bvh.perm[slot], -1),
                     uv=torch.stack([u_best, v_best], dim=-1),
                     t=torch.where(valid, t_best, _INF))
