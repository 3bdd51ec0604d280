"""Brute-force closest hit: every ray against every triangle, with a
running (t, id, uv) reduction over triangle chunks. Counterpart of
``psdr_tpu/accel/bruteforce.py``. Detached: no gradient flows through a
hit query."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.constants import RayEpsilon

_INF = float("inf")


class HitRecord(NamedTuple):
    valid: torch.Tensor   # (N,) bool
    tri_id: torch.Tensor  # (N,) int32 global triangle index, -1 on miss
    uv: torch.Tensor      # (N, 2) barycentrics: p = p0 + e1*u + e2*v
    t: torch.Tensor       # (N,) hit distance (inf on miss)


def moller_trumbore_tile(ox, oy, oz, dx, dy, dz, tri9):
    """Moller-Trumbore in component form over broadcastable ray and
    triangle components; ``tri9`` = (p0x, p0y, p0z, e1x, .., e2z).
    Returns (u, v, t). The operation order is the JAX package's, which the
    CUDA kernel (csrc/intersect.cu) repeats."""
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = tri9
    # h = d x e2
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    f = 1.0 / torch.where(torch.abs(a) < 1e-20, torch.full_like(a, 1e-20), a)
    sx = ox - p0x
    sy = oy - p0y
    sz = oz - p0z
    u = f * (sx * hx + sy * hy + sz * hz)
    # q = s x e1
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    return u, v, t


def _accept(u, v, t, t_bound):
    return ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            & (t > RayEpsilon) & (t < t_bound))


def _brute_small_f(p0, e1, e2, ray_o, ray_d, active, tmax) -> HitRecord:
    """Unrolled closest hit for tiny face sets (the emitter-first query's
    emitter geometry), every temporary a (N,) lane vector."""
    ox, oy, oz = ray_o[:, 0], ray_o[:, 1], ray_o[:, 2]
    dx, dy, dz = ray_d[:, 0], ray_d[:, 1], ray_d[:, 2]
    n = ox.shape[0]
    dev = ox.device
    t_best = torch.full((n,), _INF, device=dev)
    id_best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros((n,), device=dev)
    v_best = torch.zeros((n,), device=dev)
    for j in range(p0.shape[0]):
        tri9 = tuple(arr[j, c] for arr in (p0, e1, e2) for c in range(3))
        u, v, t = moller_trumbore_tile(ox, oy, oz, dx, dy, dz, tri9)
        closer = _accept(u, v, t, tmax) & active & (t < t_best)
        t_best = torch.where(closer, t, t_best)
        id_best = torch.where(closer, j, id_best)
        u_best = torch.where(closer, u, u_best)
        v_best = torch.where(closer, v, v_best)
    return HitRecord(valid=id_best >= 0, tri_id=id_best,
                     uv=torch.stack([u_best, v_best], dim=-1), t=t_best)


def ray_intersect_brute(p0: torch.Tensor, e1: torch.Tensor, e2: torch.Tensor,
                        ray_o: torch.Tensor, ray_d: torch.Tensor,
                        active: torch.Tensor | None = None,
                        tmax: torch.Tensor | None = None,
                        tri_block: int = 512) -> HitRecord:
    """Closest hit over all triangles. p0/e1/e2: (F, 3); ray_o/ray_d:
    (N, 3). Ties in t go to the lowest triangle id."""
    p0, e1, e2, ray_o, ray_d = (x.detach() for x in (p0, e1, e2, ray_o, ray_d))
    n = ray_o.shape[0]
    dev = ray_o.device
    active = (torch.ones((n,), dtype=torch.bool, device=dev) if active is None
              else active.detach())
    tmax = (torch.full((n,), _INF, device=dev) if tmax is None
            else torch.broadcast_to(tmax.detach(), (n,)))
    if p0.shape[0] <= 24:
        return _brute_small_f(p0, e1, e2, ray_o, ray_d, active, tmax)

    o = [ray_o[:, c:c + 1] for c in range(3)]
    d = [ray_d[:, c:c + 1] for c in range(3)]
    t_best = torch.full((n,), _INF, device=dev)
    id_best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    uv_best = torch.zeros((n, 2), device=dev)
    rows = torch.arange(n, device=dev)
    for base in range(0, p0.shape[0], tri_block):
        sl = slice(base, base + tri_block)
        tri9 = tuple(arr[sl, c][None, :] for arr in (p0, e1, e2)
                     for c in range(3))
        u, v, t = moller_trumbore_tile(*o, *d, tri9)
        hit = _accept(u, v, t, tmax[:, None]) & active[:, None]
        t_m = torch.where(hit, t, torch.full_like(t, _INF))
        j = torch.argmin(t_m, dim=1)
        t_c = t_m[rows, j]
        closer = t_c < t_best
        t_best = torch.where(closer, t_c, t_best)
        id_best = torch.where(closer, (base + j).to(torch.int32), id_best)
        uv_c = torch.stack([u[rows, j], v[rows, j]], dim=-1)
        uv_best = torch.where(closer[:, None], uv_c, uv_best)
    return HitRecord(valid=id_best >= 0, tri_id=id_best, uv=uv_best, t=t_best)
