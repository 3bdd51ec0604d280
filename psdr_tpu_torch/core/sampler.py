"""Random-sample streams and the scrambled (0,2)-sequence.

Counterpart of ``psdr_tpu/core/sampler.py``. A stream is a base key; every
draw folds an incrementing counter into it (``core/threefry.py``), so the
draws equal the JAX package's bit for bit. uint32 values are held in int64
tensors.
"""
from __future__ import annotations

import torch

from .. import profiling
from . import threefry

_M32 = 0xFFFFFFFF


class RngStream:
    """Each ``next_*`` call derives a fresh subkey by folding an
    incrementing counter into the base key, then draws on ``device``. A
    base key in the tensor-word mode (``threefry.on_device``) derives its
    subkeys a block at a time, ``split(key, n)`` in one vectorised hash,
    whose row i is ``fold_in(key, i)``: the same keys for a fraction of the
    launches.

    The interior renderer attaches the lane structure that downstream
    samplers use: ``vis_spp`` (lanes per pixel, for NEE visibility reuse)
    ``ld`` (sample index + per-pixel scramble words of the (0,2)-sequence
    for the first NEE and BSDF samples) and ``strata`` (sample index, spp,
    the (a, b) jitter grid and the per-pixel NEE and BSDF rotations of the
    stratified sampler)."""

    BLOCK = 8   # subkeys a tensor-word stream derives at once

    def __init__(self, key: torch.Tensor, salt: int | None = None,
                 device=None):
        self.key = threefry.fold_in(key, salt) if salt is not None else key
        self.device = device
        self._i = 0
        self._block = None
        self.vis_spp: int | None = None
        self.ld: tuple | None = None
        self.strata: tuple | None = None

    def _subkey(self) -> torch.Tensor:
        i = self._i
        self._i += 1
        if not threefry.on_device(self.key):
            return threefry.fold_in(self.key, i)
        if self._block is None or i >= self._block.shape[0]:
            n = self.BLOCK * (i // self.BLOCK + 1)
            self._block = threefry.split(self.key, n)
        return self._block[i]

    def next_1d(self, shape) -> torch.Tensor:
        if isinstance(shape, int):
            shape = (shape,)
        return threefry.uniform(self._subkey(), shape, self.device)

    def next_2d(self, n: int) -> torch.Tensor:
        return self.next_1d((n, 2))

    def next_3d(self, n: int) -> torch.Tensor:
        return self.next_1d((n, 3))

    def next_nd(self, n: int, d: int) -> torch.Tensor:
        return self.next_1d((n, d))


def make_streams(seed: int, n: int = 3) -> list[torch.Tensor]:
    """The scene's independent sampler streams (interior, primary edges,
    secondary edges): ``n`` keys split from ``PRNGKey(seed)``."""
    return list(threefry.split(threefry.PRNGKey(seed), n))


# Larcher-Pillichshammer column vectors: v_{k+1} = v_k ^ (v_k >> 1)
_LP_V = []
_v = 1 << 31
for _ in range(32):
    _LP_V.append(_v)
    _v ^= _v >> 1
del _v


def _bit_reverse32(x: torch.Tensor) -> torch.Tensor:
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) & _M32) | (x >> 16)


def _lp32(n: torch.Tensor) -> torch.Tensor:
    x = torch.zeros_like(n)
    for k in range(32):
        x = torch.where((n >> k) & 1 == 1, x ^ _LP_V[k], x)
    return x


@profiling.span("rng")
def ld_2d(index: torch.Tensor, scramble_x: torch.Tensor,
          scramble_y: torch.Tensor) -> torch.Tensor:
    """Scrambled (0,2)-sequence point for each ``index``; the scramble words
    are per-lane (or broadcastable) uint32 values in int64. Returns (..., 2)
    float32 in [0, 1]: a word that rounds up to 2^32 in float32 gives 1.0,
    exactly as the JAX package does."""
    i = index.to(torch.int64) & _M32
    x = _bit_reverse32(i) ^ scramble_x
    y = _lp32(i) ^ scramble_y
    inv = 2.3283064365386963e-10  # 2^-32
    return torch.stack([x.to(torch.float32) * inv,
                        y.to(torch.float32) * inv], dim=-1)
