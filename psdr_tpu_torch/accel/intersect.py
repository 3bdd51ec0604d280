"""K1, the scene-intersection kernel: closest hit or any hit of each ray
against the refit BVH (``accel/bvh.py``), returning a ``HitRecord``.

It replaces ``psdr_tpu/accel/pallas_kernel.py`` ``ray_intersect_pallas_culled2``
(the Pallas kernel the JAX package runs on a TPU). Two implementations hold
one contract:

* ``k1_cuda``: the hand-written CUDA kernel ``csrc/intersect.cu``, built with
  ``nvcc`` for ``sm_90a`` at first use and loaded through ``ctypes``. It
  takes CUDA tensors only and raises if the build or the launch fails.
* ``k1_plain``: the plain PyTorch version. It mirrors the JAX package's
  ``ray_intersect_culled`` (``psdr_tpu/accel/bvh.py``): a slab cull of each
  ray block against the leaf-block AABBs, then a dense Moller-Trumbore over
  the occupied (ray block, leaf block) pairs.

``ray_intersect_k1`` dispatches on the device of the rays: CPU tensors take
the plain version, CUDA tensors launch the kernel. Both return the closest
hit, ties in t going to the lowest padded slot; in any-hit mode the kernel
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

from ..core.constants import RayEpsilon
from .bruteforce import HitRecord, _accept, moller_trumbore_tile
from .bvh import BVH

_INF = float("inf")

# Launches of the CUDA kernel by mode, counted where k1_cuda launches it
# and nowhere else (chip_smoke.py reads them to show the path ran K1).
LAUNCHES = {"closest": 0, "any": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def ray_intersect_k1(bvh: BVH, ray_o: torch.Tensor, ray_d: torch.Tensor,
                     active: torch.Tensor | None = None,
                     tmax: torch.Tensor | None = None,
                     any_hit: bool = False) -> HitRecord:
    """Closest hit (or, with ``any_hit``, some hit) with t in
    (RayEpsilon, tmax) for every active ray."""
    n = ray_o.shape[0]
    dev = ray_o.device
    ray_o = ray_o.detach().float().contiguous()
    ray_d = ray_d.detach().float().contiguous()
    active = (torch.ones((n,), dtype=torch.bool, device=dev) if active is None
              else active.detach().to(torch.bool).contiguous())
    tmax = (torch.full((n,), _INF, device=dev) if tmax is None
            else torch.broadcast_to(tmax.detach().float(), (n,)).contiguous())
    if dev.type == "cuda":
        return k1_cuda(bvh, ray_o, ray_d, active, tmax, any_hit)
    if dev.type == "cpu":
        return k1_plain(bvh, ray_o, ray_d, active, tmax)
    raise ValueError(f"K1 runs on CUDA or CPU tensors, not {dev}")


# -- the CUDA kernel ------------------------------------------------------------

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_SOURCES = (_CSRC / "intersect.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "psdr_tpu_torch"
_LIB = None


def _find_nvcc() -> str | None:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    return None


def build_library(nvcc: str | None = None) -> Path:
    """Compile ``csrc/intersect.cu`` into
    ``build/psdr_tpu_torch/<source hash>/libpsdr_k1.so`` unless that file
    exists; ``nvcc -Xptxas -v`` output goes to ``build.log`` beside it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _SOURCES:
        h.update(src.read_bytes())
    out = BUILD_ROOT / h.hexdigest()[:16] / "libpsdr_k1.so"
    if out.exists():
        return out
    nvcc = nvcc or _find_nvcc()
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError(
            "K1 needs nvcc (the CUDA toolkit) to build csrc/intersect.cu; "
            f"none found (looked for {nvcc or 'nvcc on PATH'})")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           *map(str, _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out.parent / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library(nvcc: str | None = None) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library(nvcc)))
        fn = lib.psdr_k1_intersect
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([ptr] * 6 + [i32, i32] + [ptr] * 4 + [i32, i32]
                       + [ptr] * 3 + [ptr])
        fn.restype = i32
        _LIB = lib
    return _LIB


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"K1: {name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"K1: {name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"K1: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"K1: {name} must be contiguous")


def k1_cuda(bvh: BVH, ray_o: torch.Tensor, ray_d: torch.Tensor,
            active: torch.Tensor, tmax: torch.Tensor,
            any_hit: bool = False) -> HitRecord:
    """Launch ``csrc/intersect.cu`` on the current stream."""
    dev = ray_o.device
    if dev.type != "cuda":
        raise ValueError(f"k1_cuda takes CUDA tensors, got {dev}")
    n = ray_o.shape[0]
    P, L = bvh.num_leaves, bvh.leaf_size
    for name, x, dtype, shape in (
            ("nodes", bvh.nodes, torch.float32, (2 * P, 6)),
            ("node_mask", bvh.node_mask, torch.bool, (2 * P,)),
            ("skip", bvh.skip, torch.int32, (2 * P,)),
            ("leaf_tris", bvh.leaf_tris, torch.float32, (P, 9 * L)),
            ("tri_valid", bvh.tri_valid, torch.bool, (P, L)),
            ("perm", bvh.perm, torch.int32, (P * L,)),
            ("ray_o", ray_o, torch.float32, (n, 3)),
            ("ray_d", ray_d, torch.float32, (n, 3)),
            ("tmax", tmax, torch.float32, (n,)),
            ("active", active, torch.bool, (n,))):
        _check(name, x, dtype, shape, dev)
    if n >= (1 << 31) or P * L >= (1 << 31):
        raise ValueError("K1 indexes rays and slots with int32")
    lib = load_library()
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    tri = torch.empty((n,), dtype=torch.int32, device=dev)
    uv = torch.empty((n, 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):   # the launch goes to the current device
        err = lib.psdr_k1_intersect(
            bvh.nodes.data_ptr(), bvh.node_mask.data_ptr(),
            bvh.skip.data_ptr(), bvh.leaf_tris.data_ptr(),
            bvh.tri_valid.data_ptr(), bvh.perm.data_ptr(), P, L,
            ray_o.data_ptr(), ray_d.data_ptr(), tmax.data_ptr(),
            active.data_ptr(), n, int(bool(any_hit)), t.data_ptr(),
            tri.data_ptr(), uv.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaGetLastError() = {err}")
    LAUNCHES["any" if any_hit else "closest"] += 1
    return HitRecord(valid=tri >= 0, tri_id=tri, uv=uv, t=t)


# -- the plain PyTorch version --------------------------------------------------

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


def k1_plain(bvh: BVH, ray_o: torch.Tensor, ray_d: torch.Tensor,
             active: torch.Tensor, tmax: torch.Tensor) -> HitRecord:
    """Block-culled dense closest hit in tensor code.

    The leaf blocks are the heap level with ``B = P*L/T`` nodes (``T``
    Morton-adjacent triangles each). Each ray block of ``R`` lanes is
    slab-tested against every block AABB over (RayEpsilon, tmax); every
    occupied (ray block, leaf block) pair then runs a dense (R, T)
    Moller-Trumbore, batched over pairs. Each lane keeps the smallest
    (t, slot) key over its pairs: the closest hit, ties to the lowest slot,
    as a sequential sweep in block order would give. The winner's (u, v, t)
    are recomputed by the same arithmetic."""
    n = ray_o.shape[0]
    dev = ray_o.device
    P, L = bvh.num_leaves, bvh.leaf_size
    T = min(TRI_BLOCK, P * L)
    B = max(1, P * L // T)
    blo, bhi = bvh.nodes[B:2 * B, :3], bvh.nodes[B:2 * B, 3:]
    block_mask = bvh.node_mask[B:2 * B]
    # (P, 9L) -> (B, leaves/block, 9, L) -> (B, 9, T)
    tri_rows = (bvh.leaf_tris.reshape(B, P // B, 9, L)
                .permute(0, 2, 1, 3).reshape(B, 9, T))
    valid_rows = bvh.tri_valid.reshape(B, T)

    R = min(RAY_BLOCK, max(8, n))
    n_rb = -(-n // R)
    pad = n_rb * R - n
    o = torch.nn.functional.pad(ray_o, (0, 0, 0, pad)).reshape(n_rb, R, 3)
    d = torch.nn.functional.pad(ray_d, (0, 0, 0, pad)).reshape(n_rb, R, 3)
    act = torch.nn.functional.pad(active, (0, pad)).reshape(n_rb, R)
    tm = torch.nn.functional.pad(tmax, (0, pad)).reshape(n_rb, R)
    small = torch.abs(d) < 1e-20
    inv_d = 1.0 / torch.where(small, torch.where(d < 0, -1e-20, 1e-20), d)

    # --- cull: (ray blocks, R, B) slab tests, a group of ray blocks at once
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
