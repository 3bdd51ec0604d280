"""Threefry-2x32 keys and draws, bit-equal to ``jax.random`` as
``psdr_tpu`` calls it (``threefry2x32`` with ``jax_threefry_partitionable``
on, the jax default).

A key is a ``(2,)`` int64 tensor holding two uint32 words; ``split`` returns
``(n, 2)``. Keys live on the host: deriving one is scalar work, so
``PRNGKey``, ``fold_in`` and ``split`` run in plain Python integers, and
only the draws (``uniform``, ``randint``) run as tensor code on the device
the caller names. uint32 arithmetic is emulated in int64 with
``& 0xFFFFFFFF`` after every operation that can carry.

Follows jax/_src/prng.py (``threefry_seed``, ``_threefry2x32_lowering``,
``iota_2x32_shape``, ``_threefry_split_foldlike``, ``_threefry_fold_in``,
``_threefry_random_bits_partitionable``) and jax/_src/random.py
(``_uniform``, ``_randint``).
"""
from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _hash(k0: int, k1: int, x0, x1, mask, rotl):
    """The 20-round Threefry-2x32 block on counters (x0, x1); the counter
    type and its wrap are supplied by the caller (ints or int64 tensors)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = mask(x0 + ks[0])
    x1 = mask(x1 + ks[1])
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = mask(x0 + x1)
            x1 = rotl(x1, r) ^ x0
        x0 = mask(x0 + ks[(i + 1) % 3])
        x1 = mask(x1 + ks[(i + 2) % 3] + i + 1)
    return x0, x1


def _int_rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def _tensor_rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def _hash_ints(k0: int, k1: int, x0: int, x1: int) -> tuple[int, int]:
    return _hash(k0, k1, x0, x1, lambda v: v & _M32, _int_rotl)


def _words(key) -> tuple[int, int]:
    k = [int(v) for v in torch.as_tensor(key).reshape(-1).tolist()]
    if len(k) != 2:
        raise ValueError(f"a key holds 2 words, got shape {tuple(key.shape)}")
    return k[0] & _M32, k[1] & _M32


def _key(k0: int, k1: int) -> torch.Tensor:
    return torch.tensor([k0, k1], dtype=torch.int64)


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: words (0, seed)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError("seed must fit in int32")
    return _key(0, seed & _M32)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of counters (0, data) under key."""
    return _key(*_hash_ints(*_words(key), 0, int(data) & _M32))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (fold-like form): row i hashes counters (0, i)."""
    k0, k1 = _words(key)
    return torch.tensor([list(_hash_ints(k0, k1, 0, i)) for i in range(num)],
                        dtype=torch.int64)


def random_bits(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """32 random bits per element (int64 in [0, 2^32)): the hash of the
    flat element index as a (hi=0, lo=i) counter, words XORed."""
    shape = tuple(shape)
    n = math.prod(shape)
    if n >= (1 << 32):
        raise NotImplementedError("draws of 2^32 or more elements")
    k0, k1 = _words(key)
    lo = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = _hash(k0, k1, torch.zeros_like(lo), lo,
                   lambda v: v & _M32, _tensor_rotl)
    return (b0 ^ b1).reshape(shape)


def uniform(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` in [0, 1): the top 23
    bits as a mantissa under exponent 0, minus one."""
    bits = (random_bits(key, shape, device) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def randint(key: torch.Tensor, shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)``, including
    its modular reduction of two 32-bit draws (whose 2^32 % span multiplier
    wraps in uint32)."""
    if not (-(1 << 31) <= minval < (1 << 31)
            and -(1 << 31) <= maxval < (1 << 31)):
        raise ValueError("randint bounds must fit in int32")
    k_hi, k_lo = split(key, 2)
    hi = random_bits(k_hi, shape, device)
    lo = random_bits(k_lo, shape, device)
    span = 1 if maxval <= minval else (maxval - minval) & _M32
    mult = (1 << 16) % span
    mult = ((mult * mult) & _M32) % span
    off = (((hi % span) * mult) & _M32) + (lo % span)
    off = (off & _M32) % span
    return (minval + off).to(torch.int32)
