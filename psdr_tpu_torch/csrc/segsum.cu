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
// Order of the sum. A level cuts its lanes into blocks of kBlock, and a
// block into kSpans spans of kSpan lanes.
// 1. Span: inside a span each run of equal keys is added left to right,
//    starting from its first lane in the span (at most kSpan - 1 adds).
// 2. Block: the spans' last pieces (the sum at each span's last lane, key
//    the last lane's) go through a segmented Hillis-Steele scan over the
//    block's spans (log2 kSpans steps; at step s span j adds span j - s's
//    value where the two keys are equal). A run that entered span j from
//    span j - 1 has the sum (scan at span j - 1) + (its first piece in
//    span j), taken where it ends in span j; every other run's sum is its
//    piece.
// 3. Levels: a run that starts in the block is owned by it: the owner
//    stores its sum into out (adds it, at a later level). The block's first
//    run, where it began in an earlier block, is handed on as the block's
//    head (key, row; key -1 where there is none). The heads, one a block,
//    are again lanes sorted by key: the next level (launch) sums them in
//    the same way, until one block is left. So a row's value is ((owner's
//    sum + level 2's) + level 3's) + ..., two launches up to kBlock^2 lanes.
// core/segsum.py segsum_plain is the same order in tensor code, and equals
// this kernel bit for bit. No chain of adds is longer than kSpan - 1; above
// it the adds form a tree.
//
// What bounds it on an H100: every value is read once, every key once and
// every output row written once, with one add a value, so device memory
// bounds it: the gather backward's (2^21, 32) float cotangent is 268 MB,
// 80 us at 3.35 TB/s. A span is a group of W threads, W = the channels
// rounded up to a power of two (at most kGroup; a second grid axis takes
// the channels above), one channel a thread, so a lane's row is one
// coalesced read; a warp adds 32 / W spans at once. A later level (the
// heads: a few blocks) runs a channel a CTA (W = 1), so that its lanes
// spread over c CTAs. A warp first stages
// the keys and rows of all its spans in shared memory (all the loads at
// once), then each thread issues its span's kSpan loads together (at a
// later level with the out rows they add to) and adds them in registers:
// no block barrier in the lane loop. The scan runs in warp shuffles, a
// channel a warp; two block barriers a block in all. A small sum (a few
// blocks) is bound by these few dependent loads, not by bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSpan = 32;                 // lanes a span: one chain of adds
constexpr int kSpans = 64;                // spans a block (two a scan lane)
constexpr int kBlock = kSpan * kSpans;    // lanes a block = a CTA
constexpr int kGroup = 32;                // channels a CTA, at most
constexpr int kThreads = 256;
constexpr int kPad = kSpan + 1;           // rows of shared memory, padded
constexpr unsigned kAll = 0xffffffffu;

__host__ __device__ inline int span_width(int channels) {
  int w = 1;
  while (w < channels) w <<= 1;
  return w;
}

__device__ __forceinline__ int32_t key_at(const int32_t* keys, int64_t i,
                                          int n) {
  return i < n ? keys[i] : -1;
}

struct Shared {
  int32_t key[kSpans][kPad];
  int32_t row[kSpans][kPad];      // value row of a lane, -1: none
  float tail[kSpans][kPad];       // last pieces, then their scan
  float head[kSpans][kPad];       // first pieces of entered runs
  int32_t defer[kSpans];          // a span's first piece waits for the scan
};

// Block blockIdx.x of one level, channels [c0, c0 + W), c0 = blockIdx.y *
// W, W threads a span (the order above). kLater: a level after the first,
// which adds to out's rows; it loads them with the values.
template <int W, bool kLater>
__global__ void __launch_bounds__(kThreads)
segsum_kernel(const int32_t* __restrict__ keys,
              const int64_t* __restrict__ order,
              const float* __restrict__ vals, int n, int c,
              float* __restrict__ out, int32_t* __restrict__ head_keys,
              float* __restrict__ head_vals) {
  constexpr int kWarps = (kSpans * W < kThreads ? kSpans * W : kThreads) / 32;
  constexpr int kAtOnce = 32 / W;          // spans a warp adds at once
  constexpr int kOwn = kSpans / kWarps;    // spans a warp, contiguous
  __shared__ Shared sm;
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * W;
  const int cg = min(W, c - c0);
  const int warp = threadIdx.x / 32, t = threadIdx.x % 32;
  const int64_t start = static_cast<int64_t>(b) * kBlock;
  const int32_t kfirst = key_at(keys, start, n);
  const bool open = start > 0 && kfirst >= 0 && keys[start - 1] == kfirst;

  // a run's sum within the block, final here: the head where it is the
  // block's open first run, else the owner's (added to `old`, out's row as
  // the earlier levels left it, at a later level)
  auto finish = [&](int32_t k, float val, int ch, float old) {
    if (open && k == kfirst) {
      head_vals[static_cast<int64_t>(b) * c + c0 + ch] = val;
      if (c0 == 0 && ch == 0) head_keys[b] = k;
    } else if (k >= 0) {
      out[static_cast<int64_t>(k) * c + c0 + ch] = kLater ? old + val : val;
    }
  };
  if (head_keys != nullptr && !open) {
    if (c0 == 0 && threadIdx.x == 0) head_keys[b] = -1;
    for (int ch = threadIdx.x; ch < cg; ch += blockDim.x)
      head_vals[static_cast<int64_t>(b) * c + c0 + ch] = 0.0f;
  }

  // 1. spans. The warp stages its spans' keys and rows (all loads at once)
#pragma unroll
  for (int r = 0; r < kOwn; ++r) {
    const int span = warp * kOwn + r;
    const int64_t i = start + span * kSpan + t;
    const int32_t k = key_at(keys, i, n);
    const int64_t row = i < n ? (order != nullptr ? order[i] : i) : -1;
    sm.key[span][t] = k;
    sm.row[span][t] = k < 0 ? -1 : static_cast<int32_t>(row);
  }
  __syncwarp();
  const int g = t / W, ch = t % W;
  const bool live = ch < cg;
#pragma unroll 1
  for (int p = 0; p < kOwn / kAtOnce; ++p) {
    const int span = warp * kOwn + p * kAtOnce + g;
    float v[kSpan];
    float old[kLater ? kSpan : 1];
#pragma unroll
    for (int j = 0; j < kSpan; ++j) {
      const int32_t row = sm.row[span][j];
      v[j] = live && row >= 0
                 ? vals[static_cast<int64_t>(row) * c + c0 + ch]
                 : 0.0f;
      if (kLater) {
        const int32_t k = sm.key[span][j];
        old[kLater ? j : 0] =
            live && k >= 0 ? out[static_cast<int64_t>(k) * c + c0 + ch]
                           : 0.0f;
      }
    }
    const int64_t lane0 = start + span * kSpan;
    const int32_t before = span > 0 ? key_at(keys, lane0 - 1, n) : -2;
    const int32_t after =
        span < kSpans - 1 ? key_at(keys, lane0 + kSpan, n) : -2;
    const bool entered = before == sm.key[span][0];
    bool first = true, defer = false;
    float acc = 0.0f;
    int32_t kp = -2;
#pragma unroll
    for (int j = 0; j < kSpan; ++j) {
      const int32_t k = sm.key[span][j];
      acc = k == kp ? acc + v[j] : v[j];
      kp = k;
      const int32_t kn = j < kSpan - 1 ? sm.key[span][j + 1] : after;
      if (kn != k) {                      // lane j ends a run in the block
        if (first && entered) {
          if (live) sm.head[span][ch] = acc;
          defer = true;
        } else if (live) {
          finish(k, acc, ch, old[kLater ? j : 0]);
        }
        first = false;
      }
    }
    if (live) sm.tail[span][ch] = acc;
    if (ch == 0) sm.defer[span] = defer;
  }
  __syncthreads();

  // 2. the segmented scan of the last pieces, a channel a warp: lane t
  // holds spans t and t + 32
  for (int chn = warp; chn < cg; chn += kWarps) {
    float x = sm.tail[t][chn], y = sm.tail[t + 32][chn];
    const int32_t kx = sm.key[t][kSpan - 1], ky = sm.key[t + 32][kSpan - 1];
    for (int s = 1; s < 32; s <<= 1) {
      const float xu = __shfl_up_sync(kAll, x, s);
      const float yu = __shfl_up_sync(kAll, y, s);
      const float xw = __shfl_sync(kAll, x, (t - s) & 31);
      const int32_t kxu = __shfl_up_sync(kAll, kx, s);
      const int32_t kyu = __shfl_up_sync(kAll, ky, s);
      const int32_t kxw = __shfl_sync(kAll, kx, (t - s) & 31);
      if (t >= s && kxu == kx) x = x + xu;
      if ((t >= s ? kyu : kxw) == ky) y = y + (t >= s ? yu : xw);
    }
    if (kx == ky) y = y + x;              // step 32: span t + 32 adds span t
    sm.tail[t][chn] = x;
    sm.tail[t + 32][chn] = y;
  }
  __syncthreads();

  // 3. the runs that entered their last span from the span before it
  for (int e = threadIdx.x; e < kSpans * cg; e += blockDim.x) {
    const int j = e / cg, chn = e - j * cg;
    if (sm.defer[j]) {
      const int32_t k = sm.key[j][0];
      finish(k, sm.tail[j - 1][chn] + sm.head[j][chn], chn,
             kLater && k >= 0 ? out[static_cast<int64_t>(k) * c + c0 + chn]
                              : 0.0f);
    }
  }
}

void launch(int w, dim3 grid, cudaStream_t stream, const int32_t* keys,
            const int64_t* order, const float* vals, int n, int c,
            float* out, int32_t* head_keys, float* head_vals) {
  const int threads = kSpans * w < kThreads ? kSpans * w : kThreads;
  auto kernel = segsum_kernel<32, false>;
  switch (w) {
    case 1: kernel = segsum_kernel<1, false>; break;
    case 2: kernel = segsum_kernel<2, false>; break;
    case 4: kernel = segsum_kernel<4, false>; break;
    case 8: kernel = segsum_kernel<8, false>; break;
    case 16: kernel = segsum_kernel<16, false>; break;
  }
  kernel<<<grid, threads, 0, stream>>>(keys, order, vals, n, c, out,
                                       head_keys, head_vals);
}

}  // namespace

// One level: blocks of kBlock lanes of `keys` (n, sorted; `order` (n,)
// int64 or null, its rows below 2^31), values `vals` (rows of c), into
// `out` (rows of c; stored where `accumulate` is 0, added to otherwise)
// and, where there is more than one block, the heads `head_keys` (one a
// block) and `head_vals` (blocks, c), which the next level takes as its
// lanes.
extern "C" int psdr_segsum(const int32_t* keys, const int64_t* order,
                           const float* vals, int n, int c, float* out,
                           int accumulate, int32_t* head_keys,
                           float* head_vals, void* stream) {
  if (n > 0 && c > 0) {
    // a later level has few lanes (the heads): a channel a CTA spreads them
    // over c CTAs
    const int w = accumulate ? 1 : span_width(c < kGroup ? c : kGroup);
    const dim3 grid((n + kBlock - 1) / kBlock, (c + w - 1) / w);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (accumulate)
      segsum_kernel<1, true><<<grid, kSpans, 0, s>>>(
          keys, order, vals, n, c, out, head_keys, head_vals);
    else
      launch(w, grid, s, keys, order, vals, n, c, out, head_keys, head_vals);
  }
  return static_cast<int>(cudaGetLastError());
}
