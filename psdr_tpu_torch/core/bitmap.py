"""Textures. Counterpart of ``psdr_tpu/core/bitmap.py`` for constant
textures; image textures (bilinear lookup) wait for slice 4."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Bitmap(NamedTuple):
    """data shape (H, W, C). (1, 1, C) means a constant texture."""
    data: object  # numpy on the host, a tensor once the scene is built

    @property
    def channels(self) -> int:
        return self.data.shape[2]


def constant(value, channels: int | None = None) -> Bitmap:
    v = np.atleast_1d(np.asarray(value, np.float32))
    if channels is not None and v.shape[0] != channels:
        v = np.broadcast_to(v, (channels,))
    return Bitmap(data=v.reshape(1, 1, -1))


def eval_bitmap(bm: Bitmap, uv: torch.Tensor) -> torch.Tensor:
    """Evaluate at uv (..., 2); returns (..., C)."""
    h, w, c = bm.data.shape
    if h != 1 or w != 1:
        raise NotImplementedError("image textures wait for slice 4")
    return bm.data[0, 0].expand(uv.shape[:-1] + (c,))
