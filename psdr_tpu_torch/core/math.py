"""Vectorized geometry and shading math; the last axis carries vector
components. Counterpart of ``psdr_tpu/core/math.py``, forward only: the
bounded derivative of ``safe_sqrt`` waits for slice 2 (the backward), so
it refuses tensors that require grad."""
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


def _forward_only(x: torch.Tensor, name: str) -> None:
    if x.requires_grad:
        raise NotImplementedError(
            f"{name}'s bounded derivative waits for slice 2 (the backward)")


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    _forward_only(x, "safe_sqrt")
    return torch.sqrt(torch.clamp(x, min=0.0))


def sqr(x):
    return x * x


def bilinear(p0, e1, e2, st):
    """p0 + e1*s + e2*t with st shape (..., 2)."""
    return p0 + e1 * st[..., 0:1] + e2 * st[..., 1:2]


def rgb2luminance(rgb: torch.Tensor) -> torch.Tensor:
    return rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722


def scrub_nonfinite(x: torch.Tensor) -> torch.Tensor:
    """Replace non-finite entries with zero."""
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))
