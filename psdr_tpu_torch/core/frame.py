"""Orthonormal shading frames (Duff et al. basis). Counterpart of
``psdr_tpu/core/frame.py``."""
from __future__ import annotations

from typing import NamedTuple

import torch

from .constants import Epsilon
from .math import dot, safe_sqrt, sqr


class Frame(NamedTuple):
    """s/t/n shape (..., 3); n is the frame's +z axis."""
    s: torch.Tensor
    t: torch.Tensor
    n: torch.Tensor


def coordinate_system(n: torch.Tensor):
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    s = torch.stack([
        sign * sqr(n[..., 0]) * a + 1.0,
        sign * b,
        -sign * n[..., 0],
    ], dim=-1)
    t = torch.stack([b, sign + sqr(n[..., 1]) * a, -n[..., 1]], dim=-1)
    return s, t


def make_frame(n: torch.Tensor) -> Frame:
    s, t = coordinate_system(n)
    return Frame(s=s, t=t, n=n)


def to_local(f: Frame, v: torch.Tensor) -> torch.Tensor:
    return torch.stack([dot(v, f.s), dot(v, f.t), dot(v, f.n)], dim=-1)


def to_world(f: Frame, v: torch.Tensor) -> torch.Tensor:
    return f.s * v[..., 0:1] + f.t * v[..., 1:2] + f.n * v[..., 2:3]


def cos_theta(v: torch.Tensor) -> torch.Tensor:
    return v[..., 2]


def cos_theta_2(v: torch.Tensor) -> torch.Tensor:
    return sqr(v[..., 2])


def sin_theta_2(v: torch.Tensor) -> torch.Tensor:
    return sqr(v[..., 0]) + sqr(v[..., 1])


def sin_theta(v: torch.Tensor) -> torch.Tensor:
    return safe_sqrt(sin_theta_2(v))


def tan_theta(v: torch.Tensor) -> torch.Tensor:
    return safe_sqrt(1.0 - sqr(v[..., 2])) / v[..., 2]


def tan_theta_2(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - sqr(v[..., 2]), min=0.0) / sqr(v[..., 2])


def sin_phi(v: torch.Tensor) -> torch.Tensor:
    s2 = sin_theta_2(v)
    inv = torch.rsqrt(torch.clamp(s2, min=1e-20))
    return torch.where(torch.abs(s2) <= 4.0 * Epsilon, 0.0,
                       torch.clamp(v[..., 1] * inv, -1.0, 1.0))


def cos_phi(v: torch.Tensor) -> torch.Tensor:
    s2 = sin_theta_2(v)
    inv = torch.rsqrt(torch.clamp(s2, min=1e-20))
    return torch.where(torch.abs(s2) <= 4.0 * Epsilon, 1.0,
                       torch.clamp(v[..., 0] * inv, -1.0, 1.0))
