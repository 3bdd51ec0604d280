"""Sample-warping functions (square -> disk / hemisphere / triangle).
Counterpart of ``psdr_tpu/core/warp.py``."""
from __future__ import annotations

import torch

from .constants import Pi, InvPi
from .math import safe_sqrt, squared_norm


def square_to_uniform_disk_concentric(sample: torch.Tensor) -> torch.Tensor:
    """Shirley's low-distortion concentric map; sample shape (..., 2)."""
    x = 2.0 * sample[..., 0] - 1.0
    y = 2.0 * sample[..., 1] - 1.0

    is_zero = (x == 0.0) & (y == 0.0)
    quadrant_1_or_3 = torch.abs(x) < torch.abs(y)

    r = torch.where(quadrant_1_or_3, y, x)
    rp = torch.where(quadrant_1_or_3, x, y)

    phi = 0.25 * Pi * rp / torch.where(r == 0.0, torch.ones_like(r), r)
    phi = torch.where(quadrant_1_or_3, 0.5 * Pi - phi, phi)
    phi = torch.where(is_zero, torch.zeros_like(phi), phi)

    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def square_to_cosine_hemisphere(sample: torch.Tensor) -> torch.Tensor:
    p = square_to_uniform_disk_concentric(sample)
    z = safe_sqrt(1.0 - squared_norm(p))
    return torch.cat([p, z[..., None]], dim=-1)


def square_to_cosine_hemisphere_pdf(v: torch.Tensor) -> torch.Tensor:
    return InvPi * v[..., 2]


def square_to_uniform_triangle(sample: torch.Tensor) -> torch.Tensor:
    """Square sample -> barycentric (u, v) uniform over the unit triangle."""
    t = safe_sqrt(1.0 - sample[..., 0])
    return torch.stack([1.0 - t, t * sample[..., 1]], dim=-1)


def square_to_uniform_triangle_pdf(p: torch.Tensor) -> torch.Tensor:
    return torch.full(p.shape[:-1], 2.0, dtype=p.dtype, device=p.device)


def square_to_uniform_sphere(sample: torch.Tensor) -> torch.Tensor:
    """Uniform direction on S^2 from (..., 2) in [0,1)^2."""
    z = 1.0 - 2.0 * sample[..., 1]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * Pi * sample[..., 0]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_uniform_sphere_pdf() -> float:
    return 1.0 / (4.0 * Pi)
