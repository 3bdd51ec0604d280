// segsum: a sum of value rows into table rows by key, in one fixed order
// whatever the scheduling: the reduction behind the port's gather backward,
// its image accumulation and its guiding masses (core/segsum.py). It is no
// TPU kernel's port: on the TPU these sums are XLA scatter-adds, which run
// in one order there; on the card an atomic scatter-add (index_add_) sums in
// another order on every run.
//
// Input: n lanes sorted by key (int32; a key below 0 is dropped, and the
// lanes of one key are contiguous), each with a row of c float32 values,
// read through a permutation `order` (the sort's) where one is given. Output:
// out[key] (num_rows, c), written or added to.
//
// Order of the sum. The lanes fall into chunks of kChunk. Inside a chunk a
// segmented Hillis-Steele scan (log2 kChunk steps; at step s a lane adds the
// lane s before it where both carry its key) leaves at each run's last lane
// the run's sum within the chunk. A run that starts in the chunk is owned by
// it: the owner stores that sum into out (or adds it, at a later level). The
// chunk's first run, where it began in an earlier chunk, is handed on as the
// chunk's head (key, row; key -1 where there is none). The heads, one a
// chunk, are again lanes sorted by key: the next level (launch) sums them in
// the same way and adds each row's sum to out, until one chunk is left. So a
// row's value is ((owner's sum + level 2's) + level 3's) + ..., each a fixed
// tree over fixed lanes. core/segsum.py segsum_plain is the same order in
// tensor code, and equals this kernel bit for bit.
//
// What bounds it on an H100: every value is read once, every key once and
// every output row written once, with a handful of adds a value, so device
// memory bounds it: the gather backward's (2^21, 32) float cotangent is
// 268 MB, 80 us at 3.35 TB/s. A thread keeps one lane; the chunk's values sit
// in shared memory, kGroup channels at a time (a second grid axis for
// more), so a lane's row is read as one coalesced segment.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 256;   // lanes a chunk = threads a CTA
constexpr int kGroup = 32;    // channels a CTA
constexpr int kStride = kGroup + 1;

__global__ void __launch_bounds__(kChunk)
segsum_kernel(const int32_t* __restrict__ keys,
              const int64_t* __restrict__ order,
              const float* __restrict__ vals, int n, int c,
              float* __restrict__ out, int accumulate,
              int32_t* __restrict__ head_keys,
              float* __restrict__ head_vals) {
  __shared__ float tile[kChunk * kStride];
  __shared__ int32_t skey[kChunk + 1];   // skey[0]: the key before the chunk
  const int t = threadIdx.x;
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * kGroup;
  const int cg = min(kGroup, c - c0);
  const int64_t start = static_cast<int64_t>(b) * kChunk;
  const int64_t i = start + t;
  const int32_t key = i < n ? keys[i] : -1;
  skey[1 + t] = key;
  if (t == 0) skey[0] = start > 0 ? keys[start - 1] : -1;
  for (int e = t; e < kChunk * cg; e += kChunk) {
    const int lane = e / cg, ch = e - (e / cg) * cg;
    const int64_t li = start + lane;
    float v = 0.0f;
    if (li < n) {
      const int64_t row = order != nullptr ? order[li] : li;
      v = vals[row * c + c0 + ch];
    }
    tile[lane * kStride + ch] = v;
  }
  __syncthreads();

  float prev[kGroup];
  for (int s = 1; s < kChunk; s <<= 1) {
    const bool same = t >= s && skey[1 + t - s] == key;
#pragma unroll
    for (int ch = 0; ch < kGroup; ++ch)
      if (same && ch < cg) prev[ch] = tile[(t - s) * kStride + ch];
    __syncthreads();
#pragma unroll
    for (int ch = 0; ch < kGroup; ++ch)
      if (same && ch < cg) tile[t * kStride + ch] += prev[ch];
    __syncthreads();
  }

  // the chunk's first run (a kept key) began in an earlier chunk; its
  // lanes are the only ones of their key here
  const bool open = skey[1] >= 0 && skey[0] == skey[1];
  const bool run_end = t == kChunk - 1 || skey[2 + t] != key;
  const bool head = open && key == skey[1];
  if (head_keys != nullptr && t == 0 && !open) {
    if (blockIdx.y == 0) head_keys[b] = -1;
    for (int ch = 0; ch < cg; ++ch)
      head_vals[static_cast<int64_t>(b) * c + c0 + ch] = 0.0f;
  }
  if (!run_end) return;
  if (head) {
    if (blockIdx.y == 0) head_keys[b] = key;
    for (int ch = 0; ch < cg; ++ch)
      head_vals[static_cast<int64_t>(b) * c + c0 + ch] =
          tile[t * kStride + ch];
  } else if (key >= 0) {
    float* row = out + static_cast<int64_t>(key) * c + c0;
    for (int ch = 0; ch < cg; ++ch)
      row[ch] = accumulate ? row[ch] + tile[t * kStride + ch]
                           : tile[t * kStride + ch];
  }
}

}  // namespace

// One level: chunks of kChunk lanes of `keys` (n, sorted; `order` (n,) int64
// or null), values `vals` (rows of c), into `out` (rows of c; stored where
// `accumulate` is 0, added to otherwise) and, where there is more than one
// chunk, the heads `head_keys` (one a chunk) and `head_vals` (chunks, c),
// which the next level takes as its lanes.
extern "C" int psdr_segsum(const int32_t* keys, const int64_t* order,
                           const float* vals, int n, int c, float* out,
                           int accumulate, int32_t* head_keys,
                           float* head_vals, void* stream) {
  if (n > 0 && c > 0) {
    const dim3 grid((n + kChunk - 1) / kChunk, (c + kGroup - 1) / kGroup);
    segsum_kernel<<<grid, kChunk, 0, static_cast<cudaStream_t>(stream)>>>(
        keys, order, vals, n, c, out, accumulate, head_keys, head_vals);
  }
  return static_cast<int>(cudaGetLastError());
}
