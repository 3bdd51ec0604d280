"""Threefry-2x32 keys and draws, bit-equal to ``jax.random`` as
``psdr_tpu`` calls it (``threefry2x32`` with ``jax_threefry_partitionable``
on, the jax default).

A key is a ``(2,)`` int64 tensor holding two uint32 words; ``split`` returns
``(n, 2)``. A key has two modes, one Threefry (``_hash``) under both:

* host words, a key on the CPU: deriving one is scalar work, so
  ``PRNGKey``, ``fold_in`` and ``split`` run in plain Python integers, and
  only the draws (``uniform``, ``randint``) run on the device the caller
  names; reading the words back costs a host read;
* tensor words, a key on a CUDA device (or any key inside
  ``tensor_words()``): the words stay on the key's device and every
  derivation and draw runs there, so nothing reads back to the host and a
  captured program (``program.py``) takes its key as an input instead of
  baking the words in. ``split`` derives n keys in one vectorised hash;
  row i of ``split(key, n)`` is ``fold_in(key, i)``.

Where the result lies on a CUDA device (a derivation from a key there, a
draw onto one) the work is one launch of ``csrc/rng.cu`` in native uint32
(``psdr_threefry``, ``psdr_randint``; counted in ``launches.rng``), which
reads a key on the card from device memory and takes host words as
arguments. Everything else runs the tensor code below, the kernels' plain
version (``fold_in_plain``, ``split_plain``, ``random_bits_plain``,
``uniform_plain``, ``randint_plain``; they run on any device): uint32
arithmetic emulated in int64 with ``& 0xFFFFFFFF`` after every operation
that can carry.

Follows jax/_src/prng.py (``threefry_seed``, ``_threefry2x32_lowering``,
``iota_2x32_shape``, ``_threefry_split_foldlike``, ``_threefry_fold_in``,
``_threefry_random_bits_partitionable``) and jax/_src/random.py
(``_uniform``, ``_randint``).
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch

from .. import profiling

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


_TENSOR_WORDS = contextvars.ContextVar("tensor_words", default=False)


@contextlib.contextmanager
def tensor_words():
    """Run every key, CPU keys included, in the tensor-word mode inside the
    block: how the CPU rehearses a captured program's key handling."""
    token = _TENSOR_WORDS.set(True)
    try:
        yield
    finally:
        _TENSOR_WORDS.reset(token)


def on_device(key: torch.Tensor) -> bool:
    """Whether ``key`` runs in the tensor-word mode."""
    return key.device.type != "cpu" or _TENSOR_WORDS.get()


def _check_key(key) -> None:
    if tuple(key.shape) != (2,):
        raise ValueError(f"a key holds 2 words, got shape {tuple(key.shape)}")


def _host_words(key) -> tuple[int, int]:
    k0, k1 = key.tolist()
    return int(k0) & _M32, int(k1) & _M32


def _words(key):
    """The key's two uint32 words: Python ints (host words) or 0-dim int64
    views of the key (tensor words; every key this module makes holds words
    in [0, 2^32), so they need no mask and cost no launch)."""
    _check_key(key)
    if on_device(key):
        return key[0], key[1]
    return _host_words(key)


def _key(k0: int, k1: int, device=None) -> torch.Tensor:
    return torch.tensor([k0, k1], dtype=torch.int64, device=device)


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: words (0, seed), on
    ``device`` (the CPU by default)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError("seed must fit in int32")
    return _key(0, seed & _M32, device)


@profiling.span("rng")
def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of counters (0, data) under key."""
    if key.is_cuda:
        return _threefry_cuda(key, 1, _KEYS, key.device, base=data)[0]
    return fold_in_plain(key, data)


def fold_in_plain(key: torch.Tensor, data: int) -> torch.Tensor:
    """``fold_in``'s plain version, on a key on any device."""
    k0, k1 = _words(key)
    if on_device(key):
        return torch.stack(_hash(k0, k1, 0, int(data) & _M32,
                                 lambda v: v & _M32, _tensor_rotl))
    return _key(*_hash_ints(k0, k1, 0, int(data) & _M32))


@profiling.span("rng")
def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (fold-like form): row i hashes counters (0, i)."""
    if key.is_cuda:
        return _threefry_cuda(key, num, _KEYS, key.device)
    return split_plain(key, num)


def split_plain(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``split``'s plain version, on a key on any device."""
    k0, k1 = _words(key)
    if on_device(key):
        i = torch.arange(num, dtype=torch.int64, device=key.device)
        return torch.stack(_hash(k0, k1, torch.zeros_like(i), i,
                                 lambda v: v & _M32, _tensor_rotl), dim=-1)
    return torch.tensor([list(_hash_ints(k0, k1, 0, i)) for i in range(num)],
                        dtype=torch.int64)


def _bits(k0, k1, n: int, device) -> torch.Tensor:
    """32 random bits for each of ``n`` counters under words (k0, k1);
    tensor words of shape (m, 1) draw m rows in one hash."""
    lo = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = _hash(k0, k1, torch.zeros_like(lo), lo,
                   lambda v: v & _M32, _tensor_rotl)
    return b0 ^ b1


def _count(shape) -> tuple[tuple, int]:
    shape = tuple(shape)
    n = math.prod(shape)
    if n >= (1 << 32):
        raise NotImplementedError("draws of 2^32 or more elements")
    return shape, n


def _draw_device(key: torch.Tensor, device) -> torch.device:
    return key.device if device is None else torch.device(device)


@profiling.span("rng")
def random_bits(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """32 random bits per element (int64 in [0, 2^32)): the hash of the
    flat element index as a (hi=0, lo=i) counter, words XORed."""
    shape, n = _count(shape)
    dev = _draw_device(key, device)
    if dev.type == "cuda":
        return _threefry_cuda(key, n, _BITS, dev).reshape(shape)
    return random_bits_plain(key, shape, dev)


def random_bits_plain(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``random_bits``' plain version, on any device."""
    shape, n = _count(shape)
    k0, k1 = _words(key)
    return _bits(k0, k1, n, _draw_device(key, device)).reshape(shape)


@profiling.span("rng")
def uniform(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` in [0, 1): the top 23
    bits as a mantissa under exponent 0, minus one."""
    shape, n = _count(shape)
    dev = _draw_device(key, device)
    if dev.type == "cuda":
        return _threefry_cuda(key, n, _UNIFORM, dev).reshape(shape)
    return uniform_plain(key, shape, dev)


def uniform_plain(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``uniform``'s plain version, on any device."""
    bits = (random_bits_plain(key, shape, device) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def _span(minval: int, maxval: int) -> tuple[int, int]:
    """``randint``'s span and its 2^32 % span multiplier (which wraps in
    uint32)."""
    if not (-(1 << 31) <= minval < (1 << 31)
            and -(1 << 31) <= maxval < (1 << 31)):
        raise ValueError("randint bounds must fit in int32")
    span = 1 if maxval <= minval else (maxval - minval) & _M32
    mult = (1 << 16) % span
    return span, ((mult * mult) & _M32) % span


@profiling.span("rng")
def randint(key: torch.Tensor, shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)``, including
    its modular reduction of two 32-bit draws."""
    span, mult = _span(minval, maxval)
    shape, n = _count(shape)
    dev = _draw_device(key, device)
    if dev.type == "cuda":
        return _randint_cuda(key, n, span, mult, minval, dev).reshape(shape)
    return randint_plain(key, shape, minval, maxval, dev)


def randint_plain(key: torch.Tensor, shape, minval: int, maxval: int,
                  device=None) -> torch.Tensor:
    """``randint``'s plain version, on any device."""
    span, mult = _span(minval, maxval)
    shape, n = _count(shape)
    dev = _draw_device(key, device)
    k = split_plain(key, 2)   # rows: the keys of the high and the low draw
    if on_device(key):
        # both draws in one hash, a row each
        hi, lo = _bits(k[:, 0:1], k[:, 1:2], n, dev).reshape((2,) + shape)
    else:
        hi = random_bits_plain(k[0], shape, dev)
        lo = random_bits_plain(k[1], shape, dev)
    off = (((hi % span) * mult) & _M32) + (lo % span)
    off = (off & _M32) % span
    return (minval + off).to(torch.int32)


# -- the CUDA kernels (csrc/rng.cu) ---------------------------------------------

_BITS, _UNIFORM, _KEYS = 0, 1, 2    # psdr_threefry's output forms


def _key_args(key: torch.Tensor, dev: torch.device):
    """``key`` as the kernels take it: (its pointer, 0, 0) where it lies on
    the card, read at launch, so a captured graph reads it at each replay;
    (None, k0, k1), the host's words, where it lies on the CPU. Returns the
    tensor behind the pointer too, which the caller holds over the
    launch."""
    _check_key(key)
    if not key.is_cuda:
        return None, (None, *_host_words(key))
    key = key.to(dev, torch.int64).contiguous()
    return key, (key.data_ptr(), 0, 0)


def _threefry_cuda(key: torch.Tensor, n: int, form: int, dev,
                   base: int = 0) -> torch.Tensor:
    """One launch of ``psdr_threefry`` on ``dev``'s current stream: element
    i hashes counters (0, base + i) under ``key`` and is written in ``form``:
    int64 bits (n,), float32 uniforms (n,) or int64 keys (n, 2)."""
    from ..accel import intersect as lib_mod
    shape, dtype = ((n, 2), torch.int64) if form == _KEYS else (
        (n,), torch.float32 if form == _UNIFORM else torch.int64)
    out = torch.empty(shape, dtype=dtype, device=dev)
    if n == 0:
        return out
    key, args = _key_args(key, out.device)
    lib = lib_mod.load_library()
    lib_mod._launch("threefry", lib.psdr_threefry, *args, int(base) & _M32, n,
                    form, out.data_ptr(), dev=out.device)
    lib_mod.RNG_LAUNCHES["rng"] += 1
    return out


def _randint_cuda(key: torch.Tensor, n: int, span: int, mult: int,
                  minval: int, dev) -> torch.Tensor:
    """One launch of ``psdr_randint``: ``randint``'s key split, both draws
    and the modular reduction, an int32 a thread."""
    from ..accel import intersect as lib_mod
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    key, args = _key_args(key, out.device)
    lib = lib_mod.load_library()
    lib_mod._launch("randint", lib.psdr_randint, *args, n, span, mult, minval,
                    out.data_ptr(), dev=out.device)
    lib_mod.RNG_LAUNCHES["rng"] += 1
    return out
