"""Orthonormal shading frames (Duff et al. basis). Counterpart of
``psdr_tpu/core/frame.py``."""
from __future__ import annotations

from typing import NamedTuple

import torch

from .math import dot, sqr


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
