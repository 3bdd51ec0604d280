"""Differentiable textures: constants and bilinearly interpolated images
with uv wrap-around. Counterpart of ``psdr_tpu/core/bitmap.py``; the data
layout is a dense (H, W, C) array, C is 1 or 3."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .gather import gather_rows_offsets


class Bitmap(NamedTuple):
    """data shape (H, W, C). (1, 1, C) means a constant texture."""
    data: object  # numpy on the host, a tensor once the scene is built

    @property
    def resolution(self):
        return (self.data.shape[1], self.data.shape[0])  # (width, height)

    @property
    def channels(self) -> int:
        return self.data.shape[2]


def constant(value, channels: int | None = None) -> Bitmap:
    v = np.atleast_1d(np.asarray(value, np.float32))
    if channels is not None and v.shape[0] != channels:
        v = np.broadcast_to(v, (channels,))
    return Bitmap(data=v.reshape(1, 1, -1))


def from_array(arr) -> Bitmap:
    """Host-side constructor: a (H, W) or (H, W, C) image, kept as it is
    when it is a tensor already and as float32 numpy otherwise."""
    if isinstance(arr, torch.Tensor):
        arr = arr.to(torch.float32)
    else:
        arr = np.asarray(arr, np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    return Bitmap(data=arr)


def eval_bitmap(bm: Bitmap, uv: torch.Tensor, flip_v: bool = False,
                active: torch.Tensor | None = None) -> torch.Tensor:
    """Evaluate at uv (..., 2); returns (..., C). Differentiable in both
    ``bm.data`` and ``uv``. Coordinates scale by (resolution - 1), with no
    half-texel offset, and the upper-left texel clamps to resolution - 2.

    The four texels of a lookup are four row gathers of the flat (H*W, C)
    table at offsets (0, 1, W, W + 1), at every size: their backward is a
    fixed-order segmented sum of the lanes sorted once (``core.gather``),
    never the serial walk of ``table[idx]``'s.

    ``active`` (..., bool, optional) names the lanes whose value the caller
    keeps. The others read texels spread over the image instead of the one
    their uv names: the BSDF dispatch evaluates every material on every
    lane, and the lanes of a mesh without uv all name texel 0, where the
    backward's atomic adds of their zero cotangents would pile up."""
    h, w, c = bm.data.shape
    if h == 1 and w == 1:
        return bm.data[0, 0].expand(uv.shape[:-1] + (c,))

    u = uv[..., 0]
    v = uv[..., 1]
    if flip_v:
        v = -v
    u = u - torch.floor(u)
    v = v - torch.floor(v)
    x = u * (w - 1)
    y = v * (h - 1)
    x0 = torch.clamp(torch.floor(x.detach()).to(torch.int64), max=w - 2)
    y0 = torch.clamp(torch.floor(y.detach()).to(torch.int64), max=h - 2)
    wx1 = x - x0.to(x.dtype)
    wy1 = y - y0.to(y.dtype)
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1

    idx = y0 * w + x0
    if active is not None:
        spread = torch.arange(idx.numel(), device=idx.device).reshape(
            idx.shape) % (h * w - w - 1)
        idx = torch.where(active, idx, spread)
    v00, v10, v01, v11 = gather_rows_offsets(
        bm.data.reshape(h * w, c), idx, (0, 1, w, w + 1))

    v0 = wx0[..., None] * v00 + wx1[..., None] * v10
    v1 = wx0[..., None] * v01 + wx1[..., None] * v11
    return wy0[..., None] * v0 + wy1[..., None] * v1
