// The random stream in native uint32: Threefry-2x32 draws and key
// derivations (core/threefry.py) and the scrambled (0,2)-sequence with its
// per-pixel scramble (core/sampler.py). It is no TPU kernel's port: the JAX
// package leaves jax.random and its bit arithmetic to XLA, which fuses a
// whole hash into one loop over native uint32. The port's tensor code
// emulates uint32 in int64 with a mask after every op that can carry, one
// kernel an op over the whole draw (~170 launches a Threefry block, ~180 a
// (0,2)-point); these kernels do the same arithmetic in registers, one
// thread an element, and write only the result.
//
// Contract: bit for bit the tensor code's, which is jax.random's
// (threefry2x32 with jax_threefry_partitionable on) and the JAX package's
// sampler:
// * psdr_threefry: element i hashes counters (0, base + i) under the key
//   and writes the form its caller needs: the two words as an int64 key row
//   (split, fold_in), their XOR as int64 bits in [0, 2^32) (random_bits),
//   or a float32 uniform in [0, 1), the top 23 bits as a mantissa under
//   exponent 0, minus one (uniform).
// * psdr_randint: jax.random.randint's two draws under split(key, 2) and
//   its modular reduction, an int32 a thread.
// * psdr_ld2d: the point (bitrev(i) ^ h(p, w0), LP(i) ^ h(p, w1)) * 2^-32
//   for sample index i and pixel p, h the per-pixel scramble hash
//   (core/sampler.py _pix_hash), LP the Larcher-Pillichshammer matrix.
// A key or the scramble words come from device memory (so a captured
// graph reads them at replay: a program's key stays an input) or, where
// the pointer is null, from scalar arguments (host words).
//
// What bounds it on an H100: a Threefry block is 79 32-bit operations
// (the key schedule's 2 xors, 2 + 15 adds of key words, 20 rounds of an
// add, a funnel-shift rotation and an xor) against 4 to 16 bytes written,
// so the instruction rate bounds uniform, random_bits and split, not device
// memory; randint hashes four blocks an element on a few elements. The
// (0,2)-point is 89 operations (the bit reversal, the LP matrix's 32 bit
// tests and 32 xors, two 9-operation scramble hashes, two xors, two
// conversions and two scalings) against 16 bytes read and 8 written:
// device memory bounds it. Nothing is staged: no shared memory, no
// barrier, no atomics, so a launch repeats itself bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum Form { kBits = 0, kUniform = 1, kKeys = 2 };

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
}

// The 20-round Threefry-2x32 block of core/threefry.py _hash.
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    if (i % 2 == 0) {
      mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
    } else {
      mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return make_uint2(x0, x1);
}

__device__ __forceinline__ uint2 key_words(const int64_t* key, uint32_t k0,
                                           uint32_t k1) {
  // a key's words lie in [0, 2^32): the low half of each int64
  return key ? make_uint2(static_cast<uint32_t>(key[0]),
                          static_cast<uint32_t>(key[1]))
             : make_uint2(k0, k1);
}

template <int F>
__global__ void __launch_bounds__(kThreads)
threefry_kernel(const int64_t* __restrict__ key, uint32_t k0, uint32_t k1,
                uint32_t base, int64_t n, void* __restrict__ out) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (i >= n) return;
  const uint2 k = key_words(key, k0, k1);
  const uint2 x = threefry2x32(k.x, k.y, 0u, base + static_cast<uint32_t>(i));
  if (F == kKeys) {
    static_cast<longlong2*>(out)[i] = make_longlong2(x.x, x.y);
  } else if (F == kBits) {
    static_cast<int64_t*>(out)[i] = x.x ^ x.y;
  } else {
    const uint32_t m = ((x.x ^ x.y) >> 9) | 0x3F800000u;
    static_cast<float*>(out)[i] = __uint_as_float(m) - 1.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
randint_kernel(const int64_t* __restrict__ key, uint32_t k0, uint32_t k1,
               int64_t n, uint32_t span, uint32_t mult, int32_t minval,
               int32_t* __restrict__ out) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (i >= n) return;
  const uint2 k = key_words(key, k0, k1);
  const uint2 hk = threefry2x32(k.x, k.y, 0u, 0u);   // split(key, 2)[0]
  const uint2 lk = threefry2x32(k.x, k.y, 0u, 1u);   // split(key, 2)[1]
  const uint2 h = threefry2x32(hk.x, hk.y, 0u, static_cast<uint32_t>(i));
  const uint2 l = threefry2x32(lk.x, lk.y, 0u, static_cast<uint32_t>(i));
  const uint32_t off = ((h.x ^ h.y) % span) * mult + (l.x ^ l.y) % span;
  out[i] = static_cast<int32_t>(static_cast<uint32_t>(minval) + off % span);
}

// core/sampler.py _pix_hash
__device__ __forceinline__ uint32_t pix_hash(uint32_t p, uint32_t word) {
  uint32_t h = p ^ word;
  h = (h ^ (h >> 16)) * 0x45D9F3Bu;
  h = (h ^ (h >> 16)) * 0x45D9F3Bu;
  return h ^ (h >> 16);
}

// core/sampler.py _lp32: column k is v_k, v_0 = 2^31, v_{k+1} = v_k ^ v_k >> 1
__device__ __forceinline__ uint32_t lp32(uint32_t n) {
  uint32_t x = 0u, v = 0x80000000u;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    x ^= v & (0u - ((n >> k) & 1u));
    v ^= v >> 1;
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
ld2d_kernel(const int64_t* __restrict__ index,
            const int64_t* __restrict__ pixel, int64_t n,
            const int32_t* __restrict__ words, uint32_t w0, uint32_t w1,
            float2* __restrict__ out) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (i >= n) return;
  if (words) {
    w0 = static_cast<uint32_t>(words[0]);
    w1 = static_cast<uint32_t>(words[1]);
  }
  const uint32_t p = static_cast<uint32_t>(pixel[i]);
  const uint32_t s = static_cast<uint32_t>(index[i]);
  const uint32_t x = __brev(s) ^ pix_hash(p, w0);
  const uint32_t y = lp32(s) ^ pix_hash(p, w1);
  // round to nearest float32 first, then scale: a word that rounds up to
  // 2^32 gives 1.0, as the tensor code's int64 -> float32 does
  const float inv = 2.3283064365386963e-10f;   // 2^-32
  out[i] = make_float2(__uint2float_rn(x) * inv, __uint2float_rn(y) * inv);
}

inline unsigned blocks(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int psdr_threefry(const int64_t* key, uint32_t k0, uint32_t k1,
                             uint32_t base, int64_t n, int form, void* out,
                             void* stream) {
  if (n > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (form == kKeys)
      threefry_kernel<kKeys><<<blocks(n), kThreads, 0, s>>>(key, k0, k1,
                                                           base, n, out);
    else if (form == kBits)
      threefry_kernel<kBits><<<blocks(n), kThreads, 0, s>>>(key, k0, k1,
                                                           base, n, out);
    else
      threefry_kernel<kUniform><<<blocks(n), kThreads, 0, s>>>(key, k0, k1,
                                                              base, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int psdr_randint(const int64_t* key, uint32_t k0, uint32_t k1,
                            int64_t n, uint32_t span, uint32_t mult,
                            int32_t minval, int32_t* out, void* stream) {
  if (n > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    randint_kernel<<<blocks(n), kThreads, 0, s>>>(key, k0, k1, n, span, mult,
                                                  minval, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int psdr_ld2d(const int64_t* index, const int64_t* pixel,
                         int64_t n, const int32_t* words, uint32_t w0,
                         uint32_t w1, float2* out, void* stream) {
  if (n > 0)
    ld2d_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        index, pixel, n, words, w0, w1, out);
  return static_cast<int>(cudaGetLastError());
}
