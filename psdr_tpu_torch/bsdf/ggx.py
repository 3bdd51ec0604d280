"""Anisotropic GGX microfacet distribution with visible-normal sampling.
Counterpart of ``psdr_tpu/bsdf/ggx.py``; every function takes per-lane
alpha_u / alpha_v tensors."""
from __future__ import annotations

import torch

from ..core import warp
from ..core.constants import Pi
from ..core.frame import cos_theta
from ..core.math import dot, normalize, safe_sqrt, sqr


def ggx_eval(alpha_u: torch.Tensor, alpha_v: torch.Tensor,
             m: torch.Tensor) -> torch.Tensor:
    ct = cos_theta(m)
    alpha_uv = alpha_u * alpha_v
    denom = Pi * alpha_uv * sqr(sqr(m[..., 0] / alpha_u)
                                + sqr(m[..., 1] / alpha_v)
                                + sqr(m[..., 2]))
    # m = 0 (the half vector of a masked lane) has denom = 0 and ct = 0 and
    # evaluates to 0 either way; dividing by 1 there keeps inf out of the
    # backward
    result = 1.0 / torch.where(denom > 0.0, denom, 1.0)
    return torch.where(result * ct > 1e-5, result, 0.0)


def ggx_smith_g1(alpha_u: torch.Tensor, alpha_v: torch.Tensor,
                 v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    xy_alpha_2 = sqr(alpha_u * v[..., 0]) + sqr(alpha_v * v[..., 1])
    # a horizontal v (masked lanes carry the zero vector) is zeroed by the
    # last select either way; dividing by 1 there keeps 0/0 and x/0 out of
    # the backward, where a zero cotangent times inf would be NaN
    vz2 = sqr(v[..., 2])
    tan_theta_alpha_2 = xy_alpha_2 / torch.where(vz2 > 0.0, vz2, 1.0)
    result = 2.0 / (1.0 + torch.sqrt(1.0 + tan_theta_alpha_2))
    result = torch.where(xy_alpha_2 == 0.0, 1.0, result)
    return torch.where(dot(v, m) * cos_theta(v) <= 0.0, 0.0, result)


def ggx_G(alpha_u, alpha_v, wi, wo, m) -> torch.Tensor:
    return (ggx_smith_g1(alpha_u, alpha_v, wi, m)
            * ggx_smith_g1(alpha_u, alpha_v, wo, m))


def _sample_visible_11(cos_theta_i: torch.Tensor,
                       sample2: torch.Tensor) -> torch.Tensor:
    """GGX visible-normal slope sampling for alpha = 1."""
    p = warp.square_to_uniform_disk_concentric(sample2)
    s = 0.5 * (1.0 + cos_theta_i)
    x = p[..., 0]
    y = safe_sqrt(1.0 - sqr(x)) * (1.0 - s) + p[..., 1] * s
    z = safe_sqrt(1.0 - (sqr(x) + sqr(y)))
    sin_theta_i = safe_sqrt(1.0 - sqr(cos_theta_i))
    norm_f = 1.0 / torch.clamp(sin_theta_i * y + cos_theta_i * z, min=1e-20)
    return torch.stack([(cos_theta_i * y - sin_theta_i * z) * norm_f,
                        x * norm_f], dim=-1)


def ggx_sample(alpha_u: torch.Tensor, alpha_v: torch.Tensor,
               wi: torch.Tensor, sample2: torch.Tensor) -> torch.Tensor:
    """Sample a visible micro-normal m for incident direction wi."""
    wi_p = normalize(torch.stack([alpha_u * wi[..., 0],
                                  alpha_v * wi[..., 1],
                                  wi[..., 2]], dim=-1))
    st2 = torch.clamp(sqr(wi_p[..., 0]) + sqr(wi_p[..., 1]), min=1e-20)
    inv_st = torch.rsqrt(st2)
    # sin/cos phi of wi_p; a (nearly) vertical direction takes phi = 0
    sp = torch.where(st2 <= 4e-5, 0.0,
                     torch.clamp(wi_p[..., 1] * inv_st, -1.0, 1.0))
    cp = torch.where(st2 <= 4e-5, 1.0,
                     torch.clamp(wi_p[..., 0] * inv_st, -1.0, 1.0))
    slope = _sample_visible_11(cos_theta(wi_p), sample2)
    sx = (cp * slope[..., 0] - sp * slope[..., 1]) * alpha_u
    sy = (sp * slope[..., 0] + cp * slope[..., 1]) * alpha_v
    return normalize(torch.stack([-sx, -sy, torch.ones_like(sx)], dim=-1))
