"""Vectorized geometry and shading math; the last axis carries vector
components. Counterpart of ``psdr_tpu/core/math.py``. ``safe_sqrt`` and
``safe_acos`` carry the JAX package's bounded derivatives in both autograd
modes: a ``backward`` for reverse mode and a ``jvp`` for forward mode
(``torch.autograd.forward_ad``)."""
from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(a * a, dim=-1))


def squared_norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * a, dim=-1)


def safe_rsqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.rsqrt(torch.clamp(x, min=1e-20))


def normalize(a: torch.Tensor) -> torch.Tensor:
    # rsqrt(max(S, eps)) form: finite derivative at a == 0 exactly
    return a * safe_rsqrt(squared_norm(a))[..., None]


class _SafeSqrt(torch.autograd.Function):
    """sqrt(max(x, 0)) with the derivative 0.5 / max(y, 1e-6): plain sqrt's
    is inf at 0, which poisons whole wavefronts even on masked lanes."""

    @staticmethod
    def forward(ctx, x):
        y = torch.sqrt(torch.clamp(x, min=0.0))
        ctx.save_for_backward(y)
        ctx.save_for_forward(y)
        return y

    @staticmethod
    def _slope(ctx):
        (y,) = ctx.saved_tensors
        return 0.5 / torch.clamp(y, min=1e-6)

    @staticmethod
    def backward(ctx, g):
        return g * _SafeSqrt._slope(ctx)

    @staticmethod
    def jvp(ctx, t):
        return t * _SafeSqrt._slope(ctx)


class _SafeAcos(torch.autograd.Function):
    """acos(clip(x, -1, 1)) with the derivative -1 / sqrt(max(1 - x^2,
    1e-8)), finite at the poles |x| = 1."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        ctx.save_for_forward(x)
        return torch.arccos(torch.clamp(x, -1.0, 1.0))

    @staticmethod
    def _slope(ctx):
        (x,) = ctx.saved_tensors
        return -1.0 / torch.sqrt(torch.clamp(1.0 - x * x, min=1e-8))

    @staticmethod
    def backward(ctx, g):
        return g * _SafeAcos._slope(ctx)

    @staticmethod
    def jvp(ctx, t):
        return t * _SafeAcos._slope(ctx)


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    return _SafeSqrt.apply(x)


def safe_acos(x: torch.Tensor) -> torch.Tensor:
    return _SafeAcos.apply(x)


def rcp(x):
    return 1.0 / x


def sqr(x):
    return x * x


def lerp(a, b, t):
    return a + (b - a) * t


def sign_eps(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Ternary sign with a dead zone: +1 if x > eps, -1 if x < -eps, else 0
    (int32)."""
    return (x > eps).to(torch.int32) - (x < -eps).to(torch.int32)


def sphdir(theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Spherical angles -> unit direction."""
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    return torch.stack([cp * st, sp * st, ct], dim=-1)


def bilinear(p0, e1, e2, st):
    """p0 + e1*s + e2*t with st shape (..., 2)."""
    return p0 + e1 * st[..., 0:1] + e2 * st[..., 1:2]


def rgb2luminance(rgb: torch.Tensor) -> torch.Tensor:
    return rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722


def ray_intersect_triangle(p0, e1, e2, ray_o, ray_d):
    """Differentiable Moller-Trumbore without validity clipping; returns
    ((u, v), t). The caller masks."""
    h = cross(ray_d, e2)
    a = dot(e1, h)
    # guard the parallel case so masked lanes cannot carry NaN gradients
    a = torch.where(torch.abs(a) < 1e-20, torch.full_like(a, 1e-20), a)
    f = 1.0 / a
    s = ray_o - p0
    u = f * dot(s, h)
    q = cross(s, e1)
    v = f * dot(ray_d, q)
    t = f * dot(e2, q)
    return torch.stack([u, v], dim=-1), t


def ray_intersect_box(ray_o, ray_d, lower, upper):
    """Slab test. Returns (active, mint, maxt)."""
    inv_d = 1.0 / ray_d
    t1 = (lower - ray_o) * inv_d
    t2 = (upper - ray_o) * inv_d
    mint = torch.minimum(t1, t2).amax(dim=-1)
    maxt = torch.maximum(t1, t2).amin(dim=-1)
    return maxt >= mint, mint, maxt


def ray_intersect_scene_aabb(ray_o, ray_d, lower, upper):
    """Intersect a ray (origin inside) with the scene AABB from within.
    Returns (t, n, G): n is the inward-facing axis normal of the exit face
    and G = cos / t^2 converts the direction pdf to an area pdf."""
    t1 = (lower - ray_o) / ray_d
    t2 = (upper - ray_o) / ray_d
    t2p = torch.maximum(t1, t2)
    t, idx = torch.min(t2p, dim=-1)
    # one-hot of the exit axis by comparison: ``one_hot`` checks its
    # indices on the host on the CPU, which a capture rehearsal refuses
    axis = (idx[..., None] == torch.arange(3, device=idx.device)).to(
        ray_d.dtype)
    n = -torch.sign(ray_d) * axis
    G = dot(n, -ray_d) / sqr(t)
    return t, n, G


def fresnel_conductor(eta_r: torch.Tensor, eta_i: torch.Tensor,
                      cos_theta_i: torch.Tensor) -> torch.Tensor:
    """Unpolarized conductor Fresnel with complex IOR eta_r + i*eta_i.
    eta_r/eta_i shape (..., C); cos_theta_i shape (...)."""
    c = cos_theta_i[..., None]
    cos2 = sqr(c)
    sin2 = 1.0 - cos2
    sin4 = sqr(sin2)
    temp_1 = sqr(eta_r) - sqr(eta_i) - sin2
    a_2_pb_2 = safe_sqrt(sqr(temp_1) + 4.0 * sqr(eta_i * eta_r))
    a = safe_sqrt(0.5 * (a_2_pb_2 + temp_1))
    term_1 = a_2_pb_2 + cos2
    term_2 = 2.0 * c * a
    r_s = (term_1 - term_2) / (term_1 + term_2)
    term_3 = a_2_pb_2 * cos2 + sin4
    term_4 = term_2 * sin2
    r_p = r_s * (term_3 - term_4) / (term_3 + term_4)
    return 0.5 * (r_s + r_p)


def mis_weight(pdf1: torch.Tensor, pdf2: torch.Tensor) -> torch.Tensor:
    """Power-2 MIS heuristic."""
    w1 = sqr(pdf1)
    w2 = sqr(pdf2)
    return w1 / (w1 + w2)


def scrub_nonfinite(x: torch.Tensor) -> torch.Tensor:
    """Replace non-finite entries with zero."""
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))
