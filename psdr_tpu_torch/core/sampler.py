"""Random-sample streams and the scrambled (0,2)-sequence.

Counterpart of ``psdr_tpu/core/sampler.py``. A stream is a base key; every
draw folds an incrementing counter into it (``core/threefry.py``), so the
draws equal the JAX package's bit for bit. uint32 values are held in int64
tensors. A scrambled (0,2)-point on CUDA tensors is one launch of
``csrc/rng.cu`` (``psdr_ld2d``; counted in ``launches.rng``), whose plain
version is the tensor code here (``ld_2d_plain``).
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
    ``ld`` (sample index, pixel id and the pixel's six scramble words of
    the (0,2)-sequence, ``ld_2d_scrambled``'s arguments: words 2, 3 for the
    first NEE sample, 4, 5 for the first BSDF sample) and ``strata``
    (sample index, spp, the (a, b) jitter grid and the per-pixel NEE and
    BSDF rotations of the stratified sampler)."""

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


@profiling.span("rng")
def _pix_hash(idx: torch.Tensor, word) -> torch.Tensor:
    """Per-pixel 32-bit hash of (pixel id, word), as the JAX package's
    scramble words (uint32 in int64); ``word`` is an int or a 0-dim
    tensor."""
    h = (idx & _M32) ^ word
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & _M32
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & _M32
    return h ^ (h >> 16)


@profiling.span("rng")
def ld_2d_scrambled(index: torch.Tensor, pixel: torch.Tensor,
                    words: torch.Tensor, k: int) -> torch.Tensor:
    """The (0,2)-point of each sample ``index`` under its pixel's scramble
    words k and k + 1 (``ld_2d_plain``). ``words`` is a 1-D tensor of
    words in [0, 2^32) (``randint``'s int32 words); on the card it may lie
    there, and is then read at launch."""
    if pixel.is_cuda:
        return _ld_cuda(index, pixel, words, k)
    return ld_2d_plain(index, pixel, words, k)


def ld_2d_plain(index: torch.Tensor, pixel: torch.Tensor,
                words: torch.Tensor, k: int) -> torch.Tensor:
    """``ld_2d(index, _pix_hash(pixel, words[k]), _pix_hash(pixel,
    words[k + 1]))``: ``psdr_ld2d``'s plain version, on any device."""
    return ld_2d(index, _pix_hash(pixel, words[k]),
                 _pix_hash(pixel, words[k + 1]))


# -- the CUDA kernel (csrc/rng.cu) ----------------------------------------------

def _ld_cuda(index: torch.Tensor, pixel: torch.Tensor, words: torch.Tensor,
             k: int) -> torch.Tensor:
    """One launch of ``psdr_ld2d`` on the pixel's device: the (..., 2)
    float32 points."""
    from ..accel import intersect as lib_mod
    dev, shape = pixel.device, tuple(pixel.shape)
    if index.device != dev or tuple(index.shape) != shape:
        raise ValueError(f"ld2d: index {tuple(index.shape)} on "
                         f"{index.device}, pixel {shape} on {dev}")
    if words.dim() != 1 or not 0 <= k <= words.shape[0] - 2:
        raise ValueError(f"ld2d: words {tuple(words.shape)} hold no word "
                         f"{k + 1}")
    pixel = pixel.to(torch.int64).contiguous()
    index = index.to(torch.int64).contiguous()
    out = torch.empty(shape + (2,), dtype=torch.float32, device=dev)
    n = pixel.numel()
    if n == 0:
        return out
    if words.is_cuda:
        # int64 words in [0, 2^32) keep their low 32 bits as int32
        words = words.to(dev, torch.int32).contiguous()
        ptr, w0, w1 = words[k:].data_ptr(), 0, 0
    else:
        ptr = None
        w0, w1 = (int(v) & _M32 for v in words[k:k + 2].tolist())
    lib = lib_mod.load_library()
    lib_mod._launch("ld2d", lib.psdr_ld2d, index.data_ptr(),
                    pixel.data_ptr(), n, ptr, w0, w1, out.data_ptr(),
                    dev=dev)
    lib_mod.RNG_LAUNCHES["rng"] += 1
    return out
