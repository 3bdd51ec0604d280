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


def _jax_pixel_scramble(idx, word):
    h = jnp.asarray(idx).astype(jnp.uint32) ^ jnp.uint32(word)
    h = (h ^ (h >> 16)) * jnp.uint32(0x45D9F3B)
    h = (h ^ (h >> 16)) * jnp.uint32(0x45D9F3B)
    return h ^ (h >> 16)


@pytest.mark.parametrize("k", [0, 2, 4])
def test_scrambled_ld_2d_and_pixel_scramble_equal_jax(k):
    """``ld_2d_scrambled`` (the (0,2)-point under the pixel's scramble words
    k and k + 1, as the interior render and ``_stratify2`` take it) and
    the pixel scramble ``_pix_hash`` against the JAX package's ``ld_2d``
    of its per-pixel hashes, on randint's words; sample indices up to
    2^32 - 1."""
    rng = np.random.default_rng(k)
    n = 2000
    idx = np.concatenate([np.arange(n // 2),
                          rng.integers(2**32 - 4096, 2**32, n // 2)]
                         ).astype(np.uint32)
    pix = rng.integers(0, 384 * 384, n).astype(np.int32)
    jw = np.asarray(jax.random.randint(jax.random.PRNGKey(k), (6,), 0,
                                       2**31 - 1, jnp.int32))
    tw = threefry.randint(threefry.PRNGKey(k), (6,), 0, 2**31 - 1)
    np.testing.assert_array_equal(jw, tw.numpy())
    hx, hy = (_jax_pixel_scramble(pix, int(jw[k + j])) for j in (0, 1))
    a = np.asarray(jsampler.ld_2d(jnp.asarray(idx), hx, hy))
    t_idx = torch.from_numpy(idx.astype(np.int64))
    t_pix = torch.from_numpy(pix.astype(np.int64))
    b = tsampler.ld_2d_scrambled(t_idx, t_pix, tw, k).numpy()
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    np.testing.assert_array_equal(
        np.asarray(hx).astype(np.int64),
        tsampler._pix_hash(t_pix, tw[k]).numpy())


@pytest.mark.parametrize("mode", ["host", "tensor"])
def test_cpu_draws_take_the_tensor_code(mode, monkeypatch):
    """CPU keys, in both key modes, and CPU lanes run the tensor code: no
    draw, derivation or (0,2)-point loads the kernel library,
    and ``launches.rng`` stays where it was."""
    from psdr_tpu_torch import profiling
    from psdr_tpu_torch.accel import intersect

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU draw reached the kernel library")

    monkeypatch.setattr(intersect, "load_library", refuse)
    before = profiling.counters().get("launches.rng", 0)
    with (threefry.tensor_words() if mode == "tensor"
          else contextlib.nullcontext()):
        key = threefry.fold_in(threefry.PRNGKey(3), 11)
        threefry.split(key, 5)
        threefry.random_bits(key, (4, 2))
        threefry.uniform(key, (9, 3))
        words = threefry.randint(key, (6,), 0, 2**31 - 1)
        stream = tsampler.RngStream(key, salt=0)
        stream.next_2d(10)
        stream.next_3d(10)
        pix = torch.arange(64) // 4
        tsampler.ld_2d_scrambled(torch.arange(64) % 4, pix, words, 2)
    assert profiling.counters().get("launches.rng", 0) == before


def test_rng_kernels_build_with_the_library():
    """``csrc/rng.cu`` is one of the library's sources, and its launches
    have their counter, ``launches.rng``."""
    from psdr_tpu_torch import profiling
    from psdr_tpu_torch.accel import intersect
    src = intersect._CSRC / "rng.cu"
    assert src in intersect._SOURCES and src.is_file()
    text = src.read_text()
    for fn in ("psdr_threefry", "psdr_randint", "psdr_ld2d"):
        assert f'extern "C" int {fn}(' in text
    assert list(intersect.RNG_LAUNCHES) == ["rng"]
    assert "launches.rng" in profiling.counters()


def test_ld2d_launcher_refuses_what_the_kernel_cannot_read():
    """``psdr_ld2d``'s launcher checks its lanes and words before it loads
    the library: indices and pixels of other shapes, and a word index past
    the words, raise."""
    words = threefry.randint(threefry.PRNGKey(1), (6,), 0, 2**31 - 1)
    pix = torch.arange(8)
    with pytest.raises(ValueError, match="index"):
        tsampler._ld_cuda(torch.arange(7), pix, words, 0)
    with pytest.raises(ValueError, match="no word 6"):
        tsampler._ld_cuda(pix % 4, pix, words, 5)
    with pytest.raises(ValueError, match="no word 1"):
        tsampler._ld_cuda(pix % 4, pix, words.reshape(2, 3), 0)


# -- csrc/rng.cu's arithmetic on the CPU --------------------------------------
# The kernels' source compiled by g++ after a prelude that stands in for the
# CUDA types and intrinsics, each launch a loop over blocks and threads:
# their integer and float arithmetic held against the tensor code here, on
# CPU pointers (the card tests hold the built kernels against it there).

_PRELUDE = r"""
#include <stdint.h>
#include <string.h>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(n)
#define __restrict__
typedef void* cudaStream_t;
struct uint2 { uint32_t x, y; };
struct longlong2 { long long x, y; };
struct float2 { float x, y; };
inline uint2 make_uint2(uint32_t x, uint32_t y) { return {x, y}; }
inline longlong2 make_longlong2(long long x, long long y) { return {x, y}; }
inline float2 make_float2(float x, float y) { return {x, y}; }
struct Index { unsigned x; };
static Index blockIdx, threadIdx;
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t s) {
  s &= 31u;
  return s ? (hi << s) | (lo >> (32u - s)) : hi;
}
inline uint32_t __brev(uint32_t x) {
  uint32_t r = 0;
  for (int k = 0; k < 32; ++k) r |= ((x >> k) & 1u) << (31 - k);
  return r;
}
inline float __uint2float_rn(uint32_t x) { return static_cast<float>(x); }
inline float __uint_as_float(uint32_t x) {
  float f;
  memcpy(&f, &x, 4);
  return f;
}
inline int cudaGetLastError() { return 0; }
#define LAUNCH(grid, block, kernel, ...)                          \
  do {                                                            \
    for (unsigned b_ = 0; b_ < (grid); ++b_)                      \
      for (unsigned t_ = 0; t_ < (block); ++t_) {                 \
        blockIdx.x = b_;                                          \
        threadIdx.x = t_;                                         \
        kernel(__VA_ARGS__);                                      \
      }                                                           \
  } while (0)
"""


@pytest.fixture(scope="module")
def rng_host_lib(tmp_path_factory):
    import ctypes
    import re
    import shutil
    import subprocess
    from psdr_tpu_torch.accel import intersect
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable")
    src = (intersect._CSRC / "rng.cu").read_text()
    src = src.replace("#include <cuda_runtime.h>", _PRELUDE)
    src, launches = re.subn(
        r"([\w<>]+?)<<<(.+?), (\w+), 0, (.+?)>>>\(\s*",
        r"LAUNCH(\2, \3, \1, ", src, flags=re.S)
    assert launches == 5
    d = tmp_path_factory.mktemp("rng_host")
    (d / "rng.cpp").write_text(src)
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-o", str(d / "librng.so"),
                    str(d / "rng.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "librng.so"))
    ptr, u32, i32, i64 = (ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int32,
                          ctypes.c_int64)
    lib.psdr_threefry.argtypes = [ptr, u32, u32, u32, i64, i32, ptr, ptr]
    lib.psdr_randint.argtypes = [ptr, u32, u32, i64, u32, u32, i32, ptr, ptr]
    lib.psdr_ld2d.argtypes = [ptr, ptr, i64, ptr, u32, u32, ptr, ptr]
    return lib


def _host_key_args(key, by_pointer):
    """psdr_threefry's key arguments: the key's pointer, or its words."""
    k0, k1 = (int(v) for v in key.tolist())
    return (key.data_ptr(), 0, 0) if by_pointer else (None, k0, k1)


@pytest.mark.parametrize("n", [1, 7, 4099])
@pytest.mark.parametrize("by_pointer", [True, False])
def test_rng_cu_draws_equal_the_tensor_code_on_the_cpu(rng_host_lib, n,
                                                       by_pointer):
    """``psdr_threefry`` in its three forms (int64 bits, float32 uniforms,
    int64 keys at a counter base) and ``psdr_randint`` over five bounds,
    the key read through its pointer or passed as words, against
    ``random_bits``, ``uniform``, ``split`` / ``fold_in`` and ``randint``
    on the CPU."""
    key = threefry.fold_in(threefry.PRNGKey(2024), 5)
    args = _host_key_args(key, by_pointer)
    bits = torch.empty(n, dtype=torch.int64)
    uni = torch.empty(n, dtype=torch.float32)
    keys = torch.empty((n, 2), dtype=torch.int64)
    lib = rng_host_lib
    assert lib.psdr_threefry(*args, 0, n, 0, bits.data_ptr(), None) == 0
    assert lib.psdr_threefry(*args, 0, n, 1, uni.data_ptr(), None) == 0
    assert lib.psdr_threefry(*args, 2**32 - 2, n, 2, keys.data_ptr(),
                             None) == 0
    assert torch.equal(bits, threefry.random_bits(key, (n,)))
    assert torch.equal(uni.view(torch.int32),
                       threefry.uniform(key, (n,)).view(torch.int32))
    want = torch.stack([threefry.fold_in(key, (2**32 - 2 + i) % 2**32)
                        for i in range(min(n, 7))])
    assert torch.equal(keys[:7], want)
    if n > 2:
        assert torch.equal(keys[2:2 + 5], threefry.split(key, 5))
    for lo, hi in ((0, 2**31 - 1), (-5, 1000), (3, 4), (-2**31, 2**31 - 1),
                   (9, 2)):
        span, mult = threefry._span(lo, hi)
        got = torch.empty(n, dtype=torch.int32)
        assert lib.psdr_randint(*args, n, span, mult, lo, got.data_ptr(),
                                None) == 0
        assert torch.equal(got, threefry.randint(key, (n,), lo, hi))


@pytest.mark.parametrize("by_pointer", [True, False])
def test_rng_cu_points_equal_the_tensor_code_on_the_cpu(rng_host_lib,
                                                        by_pointer):
    """``psdr_ld2d``, words read through their pointer or passed as
    words, against ``ld_2d_plain``: sample indices up to 2^32 - 1 and
    points whose coordinate rounds to 1.0."""
    rng = np.random.default_rng(9)
    n = 4099
    idx = torch.from_numpy(np.concatenate([
        np.arange(n // 2), rng.integers(2**32 - 2**20, 2**32, n - n // 2)]))
    pix = torch.from_numpy(rng.integers(0, 384 * 384, n))
    words = threefry.randint(threefry.PRNGKey(4), (6,), 0, 2**31 - 1)
    # the first 256 lanes: bitrev(i) ^ h(p, w2) = 2^32 - 1 - j
    h = tsampler._pix_hash(pix[:256], words[2])
    x = (2**32 - 1 - torch.arange(256)) ^ h
    idx[:256] = torch.tensor([int(f"{v:032b}"[::-1], 2) for v in x.tolist()])
    for k in range(5):
        got = torch.empty((n, 2), dtype=torch.float32)
        w = words[k:]
        wargs = ((w.data_ptr(), 0, 0) if by_pointer
                 else (None, int(w[0]), int(w[1])))
        assert rng_host_lib.psdr_ld2d(idx.data_ptr(), pix.data_ptr(), n,
                                      *wargs, got.data_ptr(), None) == 0
        want = tsampler.ld_2d_plain(idx, pix, words, k)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        if k == 2:
            assert int((got[:256, 0] == 1.0).sum()) == 128
