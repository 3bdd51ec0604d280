"""The port's random streams equal jax.random's bit for bit: keys,
fold_in, split, float32 uniform and int32 randint (threefry2x32 with
jax_threefry_partitionable on), in both key modes (host words, and the
tensor words a captured program runs on, ``threefry.tensor_words``), the
scrambled (0,2)-sequence and the per-pixel scramble hash."""
import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from psdr_tpu.core import sampler as jsampler
from psdr_tpu_torch.core import sampler as tsampler
from psdr_tpu_torch.core import threefry
from psdr_tpu_torch.integrator.base import _pix_hash

torch.set_num_threads(2)

SEEDS = [0, 1, 12345, 2**31 - 1]


def _key_eq(jk, tk):
    np.testing.assert_array_equal(np.asarray(jk).astype(np.int64), tk.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_fold_in_split(seed):
    jk, tk = jax.random.PRNGKey(seed), threefry.PRNGKey(seed)
    _key_eq(jk, tk)
    for data in (0, 7, 2**31 - 1):
        _key_eq(jax.random.fold_in(jk, data), threefry.fold_in(tk, data))
    _key_eq(jax.random.split(jk, 5), threefry.split(tk, 5))
    _key_eq(jax.random.split(jk), threefry.split(tk))


@pytest.mark.parametrize("shape", [(7,), (1000, 2), (333, 3), (4, 5, 6)])
def test_uniform_bit_equal(shape):
    for seed in (3, 99):
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
        tk = threefry.fold_in(threefry.PRNGKey(seed), 11)
        a = np.asarray(jax.random.uniform(jk, shape, dtype=jnp.float32))
        b = threefry.uniform(tk, shape).numpy()
        assert b.dtype == np.float32 and b.shape == shape
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("lo,hi,shape", [(0, 2**31 - 1, (6,)),
                                         (-5, 1000, (9, 2)), (3, 4, (10,))])
def test_randint_equal(lo, hi, shape):
    for seed in (0, 5):
        jk, tk = jax.random.PRNGKey(seed), threefry.PRNGKey(seed)
        a = np.asarray(jax.random.randint(jk, shape, lo, hi, jnp.int32))
        b = threefry.randint(tk, shape, lo, hi).numpy()
        np.testing.assert_array_equal(a, b)


def test_rng_stream_matches_jax():
    jr = jsampler.RngStream(jax.random.PRNGKey(4), salt=0)
    tr = tsampler.RngStream(threefry.PRNGKey(4), salt=0)
    for draw in ("next_1d", "next_2d", "next_3d", "next_2d"):
        a = np.asarray(getattr(jr, draw)(257))
        b = getattr(tr, draw)(257).numpy()
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("seed", list(range(10)))
def test_tensor_words_equal_jax_and_host_words(seed):
    """The tensor-word mode (0-dim words on the key's device, every
    derivation tensor code) against jax.random and the host-word path:
    keys, fold_in, split, uniform and randint bit for bit."""
    jk, hk = jax.random.PRNGKey(seed), threefry.PRNGKey(seed)
    ju = jax.random.fold_in(jk, 11)
    want = {"fold_in": [jax.random.fold_in(jk, d) for d in (0, 7, 2**31 - 1)],
            "split": [jax.random.split(jk, 5), jax.random.split(ju, 3)],
            "uniform": np.asarray(jax.random.uniform(ju, (333, 3))),
            "randint": [np.asarray(jax.random.randint(jk, (6,), 0, 2**31 - 1,
                                                      jnp.int32)),
                        np.asarray(jax.random.randint(ju, (9, 2), -5, 1000,
                                                      jnp.int32))]}
    for mode in ("host", "tensor"):
        with (threefry.tensor_words() if mode == "tensor"
              else contextlib.nullcontext()):
            tu = threefry.fold_in(hk, 11)
            got = {"fold_in": [threefry.fold_in(hk, d)
                               for d in (0, 7, 2**31 - 1)],
                   "split": [threefry.split(hk, 5), threefry.split(tu, 3)],
                   "uniform": threefry.uniform(tu, (333, 3)).numpy(),
                   "randint": [threefry.randint(hk, (6,), 0, 2**31 - 1),
                               threefry.randint(tu, (9, 2), -5, 1000)]}
        for j, t in zip(want["fold_in"] + want["split"],
                        got["fold_in"] + got["split"]):
            _key_eq(j, t)
        np.testing.assert_array_equal(want["uniform"].view(np.int32),
                                      got["uniform"].view(np.int32))
        for j, t in zip(want["randint"], got["randint"]):
            np.testing.assert_array_equal(j, t.numpy())


def test_rng_stream_tensor_words_match_jax():
    """A tensor-word stream derives its subkeys a block at a time
    (``split``, whose row i is ``fold_in``'s): 20 draws, past two blocks,
    equal the host stream's and JAX's."""
    jr = jsampler.RngStream(jax.random.PRNGKey(4), salt=2)
    hr = tsampler.RngStream(threefry.PRNGKey(4), salt=2)
    with threefry.tensor_words():
        tr = tsampler.RngStream(threefry.PRNGKey(4), salt=2)
        draws = [tr.next_2d(65).numpy() for _ in range(20)]
    assert tr._block.shape == (3 * tsampler.RngStream.BLOCK, 2)
    for b in draws:
        a = np.asarray(jr.next_2d(65))
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
        np.testing.assert_array_equal(hr.next_2d(65).numpy(), b)


def test_ld_2d_equal():
    rng = np.random.default_rng(0)
    idx = np.concatenate([np.arange(600), rng.integers(0, 2**32, 400)]
                         ).astype(np.uint32)
    sx = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    sy = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    a = np.asarray(jsampler.ld_2d(jnp.asarray(idx), jnp.asarray(sx),
                                  jnp.asarray(sy)))
    b = tsampler.ld_2d(*(torch.from_numpy(x.astype(np.int64))
                         for x in (idx, sx, sy))).numpy()
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_pixel_scramble_hash_equal():
    """The per-pixel scramble of psdr_tpu/integrator/base.py:235-239."""
    idx = np.arange(0, 512 * 512, 37, dtype=np.int32)
    for word in (0, 1, 0x9E3779B9, 2**32 - 1):
        h = jnp.asarray(idx).astype(jnp.uint32) ^ jnp.uint32(word)
        h = (h ^ (h >> 16)) * jnp.uint32(0x45D9F3B)
        h = (h ^ (h >> 16)) * jnp.uint32(0x45D9F3B)
        a = np.asarray(h ^ (h >> 16)).astype(np.int64)
        b = _pix_hash(torch.from_numpy(idx.astype(np.int64)), word).numpy()
        np.testing.assert_array_equal(a, b)
