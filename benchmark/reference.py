"""The plain reference that the port's images are judged against: a
textbook Monte Carlo estimate of the same pixels, written from the scene's
description (``scenes.py``) alone. It imports nothing of the port and
shares none of its sampling: its own generator, its own camera, its own
intersector (every ray against clusters of triangles, each cluster's box
first, then Moller-Trumbore on each triangle of the clusters it enters),
its own tables and its own estimator.

``DirectIntegrator`` renders, per pixel, the radiance that leaves the
first surface a camera ray hits toward the camera (or the sky's, where
the ray leaves the scene): what that surface emits, and the light of the
area lights and the sky that it reflects once. The reference estimates
the same integral with uniform jitter in the pixel (a box filter), the
area lights by next-event estimation alone, and the sky by one sky sample
and one BSDF sample under the balance heuristic (``direct``). The port's
estimator (multiple importance sampling over scrambled low-discrepancy
points and tables of its own) has the same expectation and another
variance.

``dtype`` sets the precision of the geometry, the rays and the shading;
the answer is summed in float64."""
from __future__ import annotations

import math

import numpy as np
import torch

CLUSTER = 128          # triangles a cluster
RAYS = 1 << 14         # rays intersected at once
T_MIN = 1e-4           # a ray's start, past the surface it leaves
GRID = 8               # camera rays a side over a pixel, to find lights


class Triangles:
    """The scene's triangles on ``device`` in ``dtype``, grouped by mesh
    and, inside a mesh, by the Morton order of their centroids, into
    clusters of at most ``CLUSTER``, each with its bounding box."""

    def __init__(self, data: dict, device, dtype):
        light_of = {li["mesh"]: i for i, li in enumerate(data["lights"])}
        p0, p1, p2, bsdf, light, clusters = [], [], [], [], [], []
        base = 0
        for k, m in enumerate(data["meshes"]):
            v = np.asarray(m["vertices"], np.float64)
            f = np.asarray(m["faces"], np.int64)
            c = v[f].mean(axis=1)
            lo, hi = c.min(axis=0), c.max(axis=0)
            q = np.clip((c - lo) / np.maximum(hi - lo, 1e-12) * 1023, 0,
                        1023).astype(np.int64)
            f = f[np.argsort(_morton(q), kind="stable")]
            p0.append(v[f[:, 0]])
            p1.append(v[f[:, 1]])
            p2.append(v[f[:, 2]])
            bsdf.append(np.full(len(f), m["bsdf"]))
            light.append(np.full(len(f), light_of.get(k, -1)))
            for s in range(0, len(f), CLUSTER):
                idx = np.arange(base + s, base + min(s + CLUSTER, len(f)))
                clusters.append(np.pad(idx, (0, CLUSTER - len(idx)),
                                       constant_values=-1))
            base += len(f)

        def dev(x, dt=dtype):
            return torch.as_tensor(np.concatenate(x), device=device).to(dt)
        a, b, c = dev(p0), dev(p1), dev(p2)
        self.p0, self.e1, self.e2 = a, b - a, c - a
        n = torch.cross(self.e1, self.e2, dim=1)
        self.area = torch.linalg.norm(n, dim=1) / 2
        self.n = n / (2 * self.area[:, None])
        self.bsdf = dev(bsdf, torch.int64)
        self.light = dev(light, torch.int64)
        self.radiance = torch.tensor(
            [li["radiance"] for li in data["lights"]] or [[0.0] * 3],
            device=device).to(dtype)
        cl = torch.as_tensor(np.stack(clusters), device=device)
        self.cluster = cl
        pts = torch.stack([a, b, c], 1)[cl.clamp(min=0)]      # (C, K, 3, 3)
        pad = (cl < 0)[:, :, None, None]
        self.lo = torch.where(pad, math.inf, pts).flatten(1, 2).amin(1)
        self.hi = torch.where(pad, -math.inf, pts).flatten(1, 2).amax(1)
        # the lights' triangles, drawn in proportion to their area
        em = torch.nonzero(self.light >= 0).flatten()
        self.em = em
        self.em_area = self.area[em].double().sum()
        self.em_cdf = torch.cumsum(self.area[em].double(), 0) / self.em_area

    def hits(self, o, d, tmax, closest: bool):
        """Rays (o, d) against every triangle: for ``closest``, (t, tri)
        of the nearest hit in (T_MIN, tmax), t = inf and tri = -1 where
        none; else whether any triangle lies in (T_MIN, tmax)."""
        r = o.shape[0]
        dev = o.device
        safe = torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
        inv = 1.0 / safe
        t0 = (self.lo[None] - o[:, None]) * inv[:, None]
        t1 = (self.hi[None] - o[:, None]) * inv[:, None]
        near = torch.minimum(t0, t1).amax(-1)
        far = torch.maximum(t0, t1).amin(-1)
        enter = (near <= far) & (far > T_MIN) & (near < tmax[:, None])
        ray, cl = torch.nonzero(enter, as_tuple=True)
        tri = self.cluster[cl]                                # (P, K)
        ok = tri >= 0
        tri_c = tri.clamp(min=0)
        oo, dd = o[ray][:, None], d[ray][:, None]
        e1, e2 = self.e1[tri_c], self.e2[tri_c]
        pv = torch.cross(dd.expand_as(e2), e2, dim=-1)
        det = (e1 * pv).sum(-1)
        det = torch.where(det == 0, torch.full_like(det, 1e-30), det)
        tv = oo - self.p0[tri_c]
        u = (tv * pv).sum(-1) / det
        qv = torch.cross(tv, e1, dim=-1)
        v = (dd * qv).sum(-1) / det
        t = (e2 * qv).sum(-1) / det
        hit = (ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > T_MIN)
               & (t < tmax[ray][:, None]))
        t = torch.where(hit, t.float(), math.inf)
        if not closest:
            any_hit = torch.zeros(r, dtype=torch.int64, device=dev)
            return any_hit.scatter_reduce(0, ray, hit.any(-1).long(),
                                          "amax") > 0
        tp, kp = t.min(-1)
        best = torch.full((r,), math.inf, device=dev)
        best = best.scatter_reduce(0, ray, tp, "amin")
        win = torch.isfinite(tp) & (tp == best[ray])
        idx = torch.full((r,), -1, dtype=torch.int64, device=dev)
        idx = idx.scatter_reduce(
            0, ray, torch.where(win, tri.gather(1, kp[:, None])[:, 0], -1),
            "amax")
        return best, idx


def _morton(q: np.ndarray) -> np.ndarray:
    code = np.zeros(len(q), np.int64)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return code


def camera_rays(cam: dict, film, px, py, u, dtype):
    """Rays through film points (px + u0, py + u1) of a pinhole camera
    whose field of view spans the film's width."""
    w, h = film
    dev = u.device
    tan = math.tan(math.radians(cam["fov_x"]) / 2)
    sx = (px.to(dtype) + u[:, 0]) / w
    sy = (py.to(dtype) + u[:, 1]) / h
    local = torch.stack([(1 - 2 * sx) * tan, (1 - 2 * sy) * tan * h / w,
                         torch.ones_like(sx)], -1)
    m = torch.as_tensor(np.asarray(cam["to_world"], np.float64),
                        device=dev).to(dtype)
    d = local @ m[:3, :3].T
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return m[:3, 3].expand_as(d), d


def _frame(n):
    """Two unit vectors that make an orthonormal frame with ``n``."""
    a = torch.where((n[:, 0].abs() > 0.9)[:, None],
                    torch.tensor([0.0, 1.0, 0.0], device=n.device),
                    torch.tensor([1.0, 0.0, 0.0], device=n.device)).to(n.dtype)
    t = torch.cross(a, n, dim=-1)
    t = t / torch.linalg.norm(t, dim=-1, keepdim=True)
    return t, torch.cross(n, t, dim=-1)


def _dot(a, b):
    return (a * b).sum(-1)


def fresnel_conductor(eta, k, c):
    """Unpolarised reflectance of a conductor of complex index eta + i k
    at incident cosine ``c`` (the exact formula)."""
    c = c[:, None]
    c2 = c * c
    s2 = 1 - c2
    t0 = eta * eta - k * k - s2
    a2b2 = torch.sqrt(torch.clamp(t0 * t0 + 4 * eta * eta * k * k, min=0))
    a = torch.sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0))
    t1 = a2b2 + c2
    t2 = 2 * c * a
    rs = (t1 - t2) / (t1 + t2)
    t3 = a2b2 * c2 + s2 * s2
    t4 = t2 * s2
    return 0.5 * (rs + rs * (t3 - t4) / (t3 + t4))


class Materials:
    """The scene's BSDFs, evaluated and sampled per lane in world space:
    ``diffuse`` (reflectance / pi, one-sided) and ``roughconductor``
    (isotropic GGX: D with its tail below 1e-5 cut as the renderer
    defines it, separable Smith shadowing, exact conductor Fresnel)."""

    def __init__(self, bsdfs, device, dtype):
        def col(key, default):
            rows = [np.broadcast_to(np.asarray(b.get(key, default),
                                               np.float64), (3,))
                    for b in bsdfs]
            return torch.as_tensor(np.stack(rows), device=device).to(dtype)
        for b in bsdfs:
            if b["kind"] not in ("diffuse", "roughconductor"):
                raise NotImplementedError(b["kind"])
            if b["kind"] == "roughconductor" and b["alpha_u"] != b["alpha_v"]:
                raise NotImplementedError("anisotropic roughness")
        self.rough = torch.tensor([b["kind"] == "roughconductor"
                                   for b in bsdfs], device=device)
        self.rho = col("reflectance", 0.0)
        self.alpha = col("alpha_u", 0.1)[:, 0]
        self.eta = col("eta", 1.0)
        self.k = col("k", 0.0)
        self.spec = col("specular_reflectance", 1.0)
        self.black = (~self.rough) & (self.rho.amax(-1) <= 0)

    @staticmethod
    def _d(a, c):
        a2 = a * a
        return 1 / (math.pi * a2 * ((1 - c * c) / a2 + c * c) ** 2)

    @staticmethod
    def _g1(a, v, h, n):
        c = _dot(v, n)
        t2 = torch.clamp(1 - c * c, min=0) / torch.clamp(c * c, min=1e-20)
        g = 2 / (1 + torch.sqrt(1 + a * a * t2))
        return torch.where(_dot(v, h) * c <= 0, 0.0, g)

    def eval(self, b, n, wi, wo):
        """f(wi, wo) cos(wo) of BSDF ``b`` at normal ``n``; (m, 3)."""
        ci, co = _dot(n, wi), _dot(n, wo)
        ok = (ci > 0) & (co > 0)
        diff = self.rho[b] / math.pi * co[:, None]
        a = self.alpha[b]
        h = wi + wo
        h = h / torch.clamp(torch.linalg.norm(h, dim=-1, keepdim=True),
                            min=1e-20)
        ch = _dot(h, n)
        dd = self._d(a, ch)
        dd = torch.where(dd * ch > 1e-5, dd, 0.0)
        g = self._g1(a, wi, h, n) * self._g1(a, wo, h, n)
        f = fresnel_conductor(self.eta[b], self.k[b], _dot(wi, h))
        spec = (f * self.spec[b] * (dd * g / torch.clamp(4 * ci, min=1e-20))
                [:, None])
        v = torch.where(self.rough[b][:, None], spec, diff)
        return torch.where(ok[:, None], v, 0.0)

    def pdf(self, b, n, wi, wo):
        """The solid-angle density of ``sample``'s directions."""
        co = _dot(n, wo)
        h = wi + wo
        h = h / torch.clamp(torch.linalg.norm(h, dim=-1, keepdim=True),
                            min=1e-20)
        ch = _dot(h, n)
        a = self.alpha[b]
        spec = self._d(a, ch) * ch / torch.clamp(4 * _dot(wo, h).abs(),
                                                 min=1e-20)
        v = torch.where(self.rough[b], spec, co / math.pi)
        return torch.where((co > 0) & (ch > 0), v, 0.0)

    def sample(self, b, n, wi, u):
        """A direction: cosine-weighted for diffuse, a GGX micro-normal
        drawn by D cos (Walter et al. 2007) and mirrored for the
        conductor."""
        t, s = _frame(n)
        phi = 2 * math.pi * u[:, 1]
        a = self.alpha[b]
        c_cos = torch.sqrt(1 - u[:, 0])
        c_ggx = 1 / torch.sqrt(1 + a * a * u[:, 0] / torch.clamp(
            1 - u[:, 0], min=1e-20))
        c = torch.where(self.rough[b], c_ggx, c_cos)
        sn = torch.sqrt(torch.clamp(1 - c * c, min=0))
        m = (t * (sn * torch.cos(phi))[:, None]
             + s * (sn * torch.sin(phi))[:, None] + n * c[:, None])
        mirror = 2 * _dot(wi, m)[:, None] * m - wi
        return torch.where(self.rough[b][:, None], mirror, m)


class Envmap:
    """An environment map as the renderer defines it: radiance arriving
    from world direction w is the bilinear lookup, without a half-texel
    offset, at u = atan2(w.x, -w.z) / 2 pi, v = acos(w.y) / pi (wrapped
    into [0, 1)), times ``scale``. Sampled by a table of as many cells
    over (u, v) as the map has texels, each in proportion to the brightest
    texel near it times sin(theta), with a floor so that no direction has
    density 0."""

    def __init__(self, env: dict, device, dtype):
        img = torch.as_tensor(np.asarray(env["radiance"], np.float32),
                              device=device)
        self.img = img.to(dtype)
        self.scale = float(env["scale"])
        self.h, self.w = img.shape[:2]
        # a cell's weight: the brightest texel that a lookup inside the
        # cell can blend in, times sin(theta) at the cell's centre
        peak = torch.nn.functional.max_pool2d(
            img.float().mean(-1)[None, None], 3, stride=1, padding=1)[0, 0]
        row = ((torch.arange(self.h, device=device) + 0.5)
               * (self.h - 1) / self.h).round().long()
        col = ((torch.arange(self.w, device=device) + 0.5)
               * (self.w - 1) / self.w).round().long()
        vc = (torch.arange(self.h, device=device) + 0.5) / self.h
        lum = peak[row][:, col] * torch.sin(vc * math.pi)[:, None]
        lum = (lum + 1e-3 * lum.mean()).flatten().double()
        self.cdf = torch.cumsum(lum, 0) / lum.sum()
        self.dens = (lum / lum.sum() * self.h * self.w).float()

    def uv(self, w):
        u = torch.atan2(w[:, 0], -w[:, 2]) / (2 * math.pi)
        v = torch.acos(torch.clamp(w[:, 1], -1, 1)) / math.pi
        return u - torch.floor(u), v - torch.floor(v)

    def radiance(self, w):
        u, v = self.uv(w)
        x, y = u * (self.w - 1), v * (self.h - 1)
        x0 = torch.clamp(torch.floor(x).long(), max=self.w - 2)
        y0 = torch.clamp(torch.floor(y).long(), max=self.h - 2)
        fx, fy = (x - x0.to(x.dtype))[:, None], (y - y0.to(y.dtype))[:, None]
        im = self.img
        top = im[y0, x0] * (1 - fx) + im[y0, x0 + 1] * fx
        bot = im[y0 + 1, x0] * (1 - fx) + im[y0 + 1, x0 + 1] * fx
        return (top * (1 - fy) + bot * fy) * self.scale

    def pdf(self, w):
        u, v = self.uv(w)
        cell = (torch.clamp((v.float() * self.h).long(), max=self.h - 1)
                * self.w
                + torch.clamp((u.float() * self.w).long(), max=self.w - 1))
        sin = torch.sqrt(torch.clamp(1 - w[:, 1].float() ** 2, min=1e-12))
        return (self.dens[cell] / (2 * math.pi ** 2 * sin)).to(w.dtype)

    def sample(self, u, dtype):
        """Directions for float64 uniforms ``u`` (m, 2), in ``dtype``,
        and their densities."""
        cell = torch.searchsorted(self.cdf, u[:, 0].contiguous())
        cell = cell.clamp(max=self.h * self.w - 1)
        # the cell's own share of u[:, 0] places the point inside it
        lo = torch.where(cell > 0, self.cdf[(cell - 1).clamp(min=0)], 0.0)
        fu = torch.clamp((u[:, 0] - lo) / (self.cdf[cell] - lo), 0, 1)
        uu = ((cell % self.w).double() + fu) / self.w
        vv = ((cell // self.w).double() + u[:, 1]) / self.h
        th, ph = vv * math.pi, uu * 2 * math.pi
        w = torch.stack([torch.sin(th) * torch.sin(ph), torch.cos(th),
                         -torch.sin(th) * torch.cos(ph)], -1).to(dtype)
        return w, self.pdf(w)


def direct(scene, o, d, u):
    """Direct illumination along rays (o, d): what the first hit (or the
    environment, where the ray leaves the scene) sends back along the ray,
    plus the light of the area lights and the environment that the hit
    reflects once. The area lights by next-event estimation alone (u[:, 0]
    picks a light triangle, u[:, 1:3] a point on it); the environment by
    one environment sample (u[:, 3:5]) and one BSDF sample (u[:, 5:7]),
    weighted by the balance heuristic. ``u`` is float64; it is used in
    the rays' precision but where it picks a cell of a table."""
    tris, mats, env = scene
    u64, u = u, u.to(o.dtype)
    m = o.shape[0]
    dev, dtype = o.device, o.dtype
    inf = torch.full((m,), math.inf, device=dev)
    t, tri = tris.hits(o, d, inf, closest=True)
    valid = tri >= 0
    tri_c = tri.clamp(min=0)
    n = tris.n[tri_c]
    wi = -d
    front = valid & (_dot(n, wi) > 0)
    x = o + d * torch.where(valid, t, 0.0).to(dtype)[:, None]
    li = tris.light[tri_c]
    out = torch.where((front & (li >= 0))[:, None],
                      tris.radiance[li.clamp(min=0)], 0.0)
    if env is not None:
        out = torch.where(valid[:, None], out, env.radiance(d))
    b = tris.bsdf[tri_c]
    shade = front & ~mats.black[b]

    def unblocked(ok, wo, tmax):
        free = ok.clone()
        if bool(ok.any()):
            sel = torch.nonzero(ok).flatten()
            free[sel] = ~tris.hits(x[sel], wo[sel], tmax[sel], closest=False)
        return free

    if tris.em.numel():
        j = torch.searchsorted(tris.em_cdf, u64[:, 0].contiguous())
        lt = tris.em[j.clamp(max=tris.em.shape[0] - 1)]
        su = torch.sqrt(u[:, 1])
        b1, b2 = 1 - su, u[:, 2] * su
        y = (tris.p0[lt] + tris.e1[lt] * b1[:, None]
             + tris.e2[lt] * b2[:, None])
        wo = y - x
        dist = torch.linalg.norm(wo, dim=-1)
        wo = wo / dist[:, None]
        cos_y = _dot(tris.n[lt], -wo)
        ok = shade & (_dot(n, wo) > 0) & (cos_y > 0)
        ok = unblocked(ok, wo, (dist - T_MIN).float())
        g = cos_y / (dist * dist) * tris.em_area.to(dtype)
        le = tris.radiance[tris.light[lt].clamp(min=0)]
        nee = mats.eval(b, n, wi, wo) * le * g[:, None]
        out = out + torch.where(ok[:, None], nee, 0.0)
    if env is not None:
        we, pe = env.sample(u64[:, 3:5], o.dtype)
        ok = shade & (_dot(n, we) > 0)
        ok = unblocked(ok, we, inf)
        w = pe + mats.pdf(b, n, wi, we)
        val = mats.eval(b, n, wi, we) * env.radiance(we) / torch.clamp(
            w, min=1e-20)[:, None]
        out = out + torch.where(ok[:, None], val, 0.0)
        wb = mats.sample(b, n, wi, u[:, 5:7])
        pb = mats.pdf(b, n, wi, wb)
        ok = shade & (_dot(n, wb) > 0) & (pb > 0)
        ok = unblocked(ok, wb, inf)
        w = pb + env.pdf(wb)
        val = mats.eval(b, n, wi, wb) * env.radiance(wb) / torch.clamp(
            w, min=1e-20)[:, None]
        out = out + torch.where(ok[:, None], val, 0.0)
    return out


def sees_emitter(data: dict, film, pixels: np.ndarray,
                 device) -> np.ndarray:
    """Whether a camera ray through a ``GRID`` x ``GRID`` lattice over each
    pixel, widened by half a pixel on every side, meets a light first:
    the pixels whose value a light's own edge can decide. (len(pixels),)
    bool."""
    tris = Triangles(data, device, torch.float32)
    pix = torch.as_tensor(np.asarray(pixels, np.int64), device=device)
    a = (torch.arange(GRID, device=device) + 0.5) / GRID * 2 - 0.5
    uv = torch.stack(torch.meshgrid(a, a, indexing="xy"), -1).reshape(-1, 2)
    seen = torch.zeros(len(pixels), dtype=torch.bool, device=device)
    step = max(1, RAYS // len(uv))
    for s in range(0, len(pixels), step):
        p = pix[s:s + step].repeat_interleave(len(uv))
        u = uv.repeat(p.shape[0] // len(uv), 1)
        o, d = camera_rays(data["camera"], film, p % film[0], p // film[0],
                           u, torch.float32)
        _, tri = tris.hits(o, d, torch.full((o.shape[0],), math.inf,
                                            device=device), closest=True)
        lit = (tri >= 0) & (tris.light[tri.clamp(min=0)] >= 0)
        seen[s:s + step] = lit.reshape(-1, len(uv)).any(1)
    return seen.cpu().numpy()


def render(data: dict, film, pixels: np.ndarray, spp: int, seed: int,
           device, dtype=torch.float32) -> np.ndarray:
    """The mean of ``spp`` samples of each of ``pixels`` (ids y * width +
    x) -> (len(pixels), 3) float64, drawn from ``seed``'s own generator."""
    if data["integrator"]["kind"] != "direct":
        raise NotImplementedError(data["integrator"]["kind"])
    scene = (Triangles(data, device, dtype),
             Materials(data["bsdfs"], device, dtype),
             Envmap(data["envmap"], device, dtype) if data.get("envmap")
             else None)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    pix = torch.as_tensor(np.asarray(pixels, np.int64), device=device)
    total = torch.zeros((len(pixels), 3), dtype=torch.float64, device=device)
    lanes = len(pixels) * spp
    per = max(1, RAYS // spp) * spp
    for s in range(0, lanes, per):
        lane = torch.arange(s, min(s + per, lanes), device=device)
        p = pix[lane // spp]
        u = torch.rand((lane.shape[0], 9), generator=gen, device=device,
                       dtype=torch.float64)
        o, d = camera_rays(data["camera"], film, p % film[0], p // film[0],
                           u[:, 0:2].to(dtype), dtype)
        value = direct(scene, o, d, u[:, 2:]).double()
        total.index_add_(0, lane // spp, value)
    return (total / spp).cpu().numpy()
