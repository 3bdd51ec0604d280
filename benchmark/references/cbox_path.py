"""The plain reference of ``cbox_path``: a textbook multi-bounce Monte Carlo
estimate of the same pixels, written from the scene's description
(``scenes.py``) alone. It imports nothing of the port. It shares
``reference.py``'s geometry, intersector, camera and materials, which
share nothing with the port either, and has an estimator and a generator
of its own.

``PathTracer(max_depth)`` renders, per pixel, the light that reaches the
camera over at most ``max_depth`` + 1 segments: what the first surface a
camera ray hits emits toward the camera, and at each of the first
``max_depth`` surface vertices of the path the light of the area lights
that the vertex reflects toward the one before. The reference estimates
the same sum: uniform jitter in the pixel (a box filter); at each vertex
next-event estimation of the area lights (a light triangle drawn by area,
a point uniform on it, a shadow ray); then a continuation drawn from the
BSDF (cosine-weighted for diffuse), the throughput multiplied by
f cos / pdf, to the next closest hit. The path ends where it leaves the
scene, meets the back of a face or a black surface, or after the
``max_depth``-th vertex.

Where it departs from the program's estimator: the program weights each
vertex's light sample and the light that its continuation ray happens to
meet by the power heuristic (multiple importance sampling); the reference
counts the light at a vertex by next-event estimation alone and never
counts emission that a continuation ray meets after the first segment.
Both estimate the same integral of each path length's light over the
light's area, so their expectations agree and their variances differ.
The program also reuses the camera vertex's visibility across the
pixel's lanes where it is on (``DirectIntegrator._nee_visibility_impl``);
the reference traces every shadow ray.

``dtype`` sets the precision of the geometry, the rays and the shading;
the answer is summed in float64."""
from __future__ import annotations

import math

import numpy as np
import torch

from reference import (RAYS, T_MIN, Materials, Triangles, _dot, camera_rays,
                       sees_emitter)

__all__ = ["render", "sees_emitter", "paths"]


def _unblocked(tris, x, wo, tmax):
    """Whether nothing lies between ``x`` and ``x + tmax * wo``."""
    if x.shape[0] == 0:
        return torch.zeros(0, dtype=torch.bool, device=x.device)
    return ~tris.hits(x, wo, tmax, closest=False)


def paths(scene, o, d, u, max_depth: int):
    """The light along rays (o, d) over paths of at most ``max_depth`` + 1
    segments: (m, 3) in the rays' precision. ``u`` (m, 5 * max_depth) is
    float64: at vertex k, ``u[:, 5k]`` picks a light triangle,
    ``u[:, 5k+1:5k+3]`` a point on it and ``u[:, 5k+3:5k+5]`` the
    continuation; used in the rays' precision but where it picks a light."""
    tris, mats = scene
    m = o.shape[0]
    dev, dtype = o.device, o.dtype
    out = torch.zeros((m, 3), device=dev, dtype=dtype)
    # the live paths: their lanes, vertex, normal, BSDF, incoming direction
    # and throughput
    lane = torch.arange(m, device=dev)
    beta = torch.ones((m, 3), device=dev, dtype=dtype)
    t, tri = tris.hits(o, d, torch.full((m,), math.inf, device=dev),
                       closest=True)
    for k in range(max_depth):
        tri_c = tri.clamp(min=0)
        n = tris.n[tri_c]
        wi = -d
        front = (tri >= 0) & (_dot(n, wi) > 0)
        if k == 0:
            li = tris.light[tri_c]
            out = torch.where((front & (li >= 0))[:, None],
                              tris.radiance[li.clamp(min=0)], out)
        b = tris.bsdf[tri_c]
        keep = torch.nonzero(front & ~mats.black[b]).flatten()
        if keep.numel() == 0:
            break
        lane, beta, b, n, wi = (lane[keep], beta[keep], b[keep], n[keep],
                                wi[keep])
        x = o[keep] + d[keep] * t[keep].to(dtype)[:, None]
        uk = u[lane, 5 * k:5 * k + 5]
        uf = uk.to(dtype)

        # next-event estimation of the area lights
        if tris.em.numel():
            j = torch.searchsorted(tris.em_cdf, uk[:, 0].contiguous())
            lt = tris.em[j.clamp(max=tris.em.shape[0] - 1)]
            su = torch.sqrt(uf[:, 1])
            b1, b2 = 1 - su, uf[:, 2] * su
            y = (tris.p0[lt] + tris.e1[lt] * b1[:, None]
                 + tris.e2[lt] * b2[:, None])
            wo = y - x
            dist = torch.linalg.norm(wo, dim=-1)
            wo = wo / dist[:, None]
            cos_y = _dot(tris.n[lt], -wo)
            ok = (_dot(n, wo) > 0) & (cos_y > 0)
            sel = torch.nonzero(ok).flatten()
            free = torch.zeros_like(ok)
            free[sel] = _unblocked(tris, x[sel], wo[sel],
                                   (dist[sel] - T_MIN).float())
            g = cos_y / (dist * dist) * tris.em_area.to(dtype)
            le = tris.radiance[tris.light[lt].clamp(min=0)]
            nee = beta * mats.eval(b, n, wi, wo) * le * g[:, None]
            out.index_add_(0, lane, torch.where(free[:, None], nee, 0.0))
        if k + 1 == max_depth:
            break

        # the continuation, drawn from the BSDF
        wb = mats.sample(b, n, wi, uf[:, 3:5])
        pb = mats.pdf(b, n, wi, wb)
        ok = (_dot(n, wb) > 0) & (pb > 0)
        f = mats.eval(b, n, wi, wb)
        beta = beta * f / torch.where(pb > 0, pb, 1.0)[:, None]
        keep = torch.nonzero(ok & (beta.amax(-1) > 0)).flatten()
        lane, beta, o, d = lane[keep], beta[keep], x[keep], wb[keep]
        t, tri = tris.hits(o, d, torch.full((o.shape[0],), math.inf,
                                            device=dev), closest=True)
    return out


def render(data: dict, film, pixels: np.ndarray, spp: int, seed: int,
           device, dtype=torch.float32) -> np.ndarray:
    """The mean of ``spp`` samples of each of ``pixels`` (ids y * width +
    x) -> (len(pixels), 3) float64, drawn from ``seed``'s own generator."""
    ic = data["integrator"]
    if ic["kind"] != "path":
        raise NotImplementedError(ic["kind"])
    if data.get("envmap"):
        raise NotImplementedError("an environment map")
    depth = int(ic["max_depth"])
    scene = (Triangles(data, device, dtype),
             Materials(data["bsdfs"], device, dtype))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    pix = torch.as_tensor(np.asarray(pixels, np.int64), device=device)
    total = torch.zeros((len(pixels), 3), dtype=torch.float64, device=device)
    lanes = len(pixels) * spp
    per = max(1, RAYS // spp) * spp
    for s in range(0, lanes, per):
        lane = torch.arange(s, min(s + per, lanes), device=device)
        p = pix[lane // spp]
        u = torch.rand((lane.shape[0], 2 + 5 * depth), generator=gen,
                       device=device, dtype=torch.float64)
        o, d = camera_rays(data["camera"], film, p % film[0], p // film[0],
                           u[:, 0:2].to(dtype), dtype)
        value = paths(scene, o, d, u[:, 2:], depth).double()
        total.index_add_(0, lane // spp, value)
    return (total / spp).cpu().numpy()
