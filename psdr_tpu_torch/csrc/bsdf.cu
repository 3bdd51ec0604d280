// Materials in one pass: a whole call of the BSDF dispatch of bsdf/__init__.py
// (eval_bsdf, pdf_bsdf, sample_bsdf), one thread a lane. It replaces no TPU
// kernel: the JAX package leaves this arithmetic to XLA, which fuses it into
// its loops. The port's tensor code pays a graph node for every operation
// instead, and runs every BSDF of the scene's list on every lane and blends
// the results by bsdf_id: some 80 nodes a call for four diffuse BSDFs, some
// 130 for a rough conductor. Here each lane reads its bsdf_id and runs that
// BSDF's arithmetic alone.
//
// Contract: bit for bit the tensor code's on the card. Each kind follows its
// tensor code's operations in their order (bsdf/diffuse.py,
// bsdf/roughconductor.py, bsdf/ggx.py with _sample_visible_11, core/warp.py's
// concentric and cosine-hemisphere maps, core/math.py's fresnel_conductor,
// normalize, safe_sqrt and safe_rsqrt, core/bitmap.py's eval_bitmap), with
// the same divide-by-1 guards, cut-offs and clamps. Built with --fmad=false,
// so no product and sum fuse; square roots and quotients are IEEE, and
// rsqrtf, sinf and cosf are the ones PyTorch's CUDA kernels call. A Python
// number divided by a tensor is PyTorch's reciprocal times the number
// (Tensor.__rdiv__), and is written so here; a number times a tensor is the
// number rounded to float32 first. torch.sum over a last dimension of three
// (dot, squared_norm) is PSDR_SUM3 below.
//
// A lane that is masked, or whose bsdf_id is -1, comes out as the dispatch
// leaves it: zeros from eval and pdf; valid false, pdf 0 and wo 0 from
// sample. A sampled lane of a BSDF keeps that BSDF's pdf and wo where its
// sample is not valid, as the dispatch's blend does.
//
// The scene's BSDF list comes by value in the launch's arguments, a table of
// up to kMaxBsdfs entries: each a kind and its parameter maps, each map an
// (h, w, c) float32 array, contiguous; a 1x1 map is a constant. Lane inputs
// come with their strides, so no caller copies them to make them contiguous.
//
// What bounds it on an H100: device memory. A lane reads its mask (1 byte),
// its bsdf_id (4), wi (12), uv (8, where a map is textured) and wo (12) or
// the sample's first two numbers (8), and writes 12 (eval), 4 (pdf) or 17
// bytes (sample: valid, pdf, wo): some 40 to 50 bytes against 50 to 250
// float operations (a rough conductor's sample is the most: the concentric
// map, the visible-normal sampling, two normalizations, the pdf's GGX term
// and Smith factor). Nothing is staged: no shared memory, no barrier; the
// table is read through the constant bank, where every lane of a warp that
// reads the same entry reads it at once.

#include <cuda_runtime.h>
#include <stdint.h>

// torch.sum over a last dimension of three, as PyTorch's CUDA reduction
// takes it: two threads a row, the first holding elements 0 and 2, each
// starting from the identity 0.
#ifndef PSDR_SUM3
#define PSDR_SUM3(a0, a1, a2) ((((a0) + (a2)) + (a1)) + 0.0f)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBsdfs = 32;
constexpr int kMaps = 5;

enum Mode { kEval = 0, kPdf = 1, kSample = 2 };
enum Kind { kDiffuse = 0, kRoughConductor = 1 };
// a rough conductor's maps, in this order; a diffuse BSDF's only map is its
// reflectance
enum ConductorMap { kAlphaU = 0, kAlphaV = 1, kEta = 2, kK = 3, kSpecular = 4 };

// the tensor code's Python numbers rounded to float32, written exactly
constexpr float kPi = 3.1415927410125732f;
constexpr float kInvPi = 0.31830987334251404f;
constexpr float kQuarterPi = 0.7853981852531433f;   // 0.25 * Pi
constexpr float kHalfPi = 1.5707963705062866f;      // 0.5 * Pi

}  // namespace

// The launch's arguments (bsdf/kernel.py builds the same layout with ctypes).
struct PsdrBsdfMap {
  const float* data;   // (h, w, c), contiguous
  int32_t h, w;
};

struct PsdrBsdfEntry {
  PsdrBsdfMap map[kMaps];
  int32_t kind;
  uint8_t channels[kMaps];
  uint8_t textured;    // a map of the entry is larger than 1x1
};

struct PsdrBsdfTable {
  PsdrBsdfEntry bsdf[kMaxBsdfs];
  int32_t count;
};

// lane i of an (N, k) input is at ptr[i * s[0] + j * s[1]]; of an (N,) one
// at ptr[i * s]
struct PsdrBsdfLanes {
  const float* wi;       // (N, 3)
  const float* uv;       // (N, 2)
  const float* x;        // wo (N, 3) for eval and pdf, the sample (N, 3)
  const int32_t* id;     // (N,)
  const bool* active;    // (N,)
  int64_t wi_s[2], uv_s[2], x_s[2], id_s, active_s;
  int64_t n;
};

struct PsdrBsdfOut {
  float* f;      // eval's value or sample's wo, (N, 3), contiguous
  float* pdf;    // (N,)
  bool* valid;   // (N,)
};

namespace {

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float sqr(float x) { return x * x; }

__device__ __forceinline__ float dot(V3 a, V3 b) {
  return PSDR_SUM3(a.x * b.x, a.y * b.y, a.z * b.z);
}

// torch.clamp: NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float safe_sqrt(float x) {
  return __fsqrt_rn(clamp_min(x, 0.0f));
}

__device__ __forceinline__ V3 normalize(V3 a) {
  const float r = rsqrtf(clamp_min(dot(a, a), 1e-20f));
  return {a.x * r, a.y * r, a.z * r};
}

__device__ __forceinline__ V3 load3(const float* p, const int64_t* s,
                                    int64_t i) {
  p += i * s[0];
  return {p[0], p[s[1]], p[2 * s[1]]};
}

// eval_bitmap at one lane: channels [0, nch) of map m, each channel k read
// from channel 0 where the map has one channel (the tensor code's
// broadcast). Scale by resolution - 1, no half-texel offset, the upper-left
// texel clamped to resolution - 2.
__device__ __forceinline__ void eval_map(const PsdrBsdfMap& m, int c,
                                         float u, float v, int nch,
                                         float* out) {
  if (m.h == 1 && m.w == 1) {
    for (int k = 0; k < nch; ++k) out[k] = m.data[c == 1 ? 0 : k];
    return;
  }
  u = u - floorf(u);
  v = v - floorf(v);
  const float x = u * static_cast<float>(m.w - 1);
  const float y = v * static_cast<float>(m.h - 1);
  int64_t x0 = static_cast<int64_t>(floorf(x));
  int64_t y0 = static_cast<int64_t>(floorf(y));
  if (x0 > m.w - 2) x0 = m.w - 2;
  if (y0 > m.h - 2) y0 = m.h - 2;
  const float wx1 = x - static_cast<float>(x0);
  const float wy1 = y - static_cast<float>(y0);
  const float wx0 = 1.0f - wx1;
  const float wy0 = 1.0f - wy1;
  const float* t = m.data + (y0 * m.w + x0) * c;
  const int64_t row = static_cast<int64_t>(m.w) * c;
  for (int k = 0; k < nch; ++k) {
    const int ck = c == 1 ? 0 : k;
    const float v0 = wx0 * t[ck] + wx1 * t[c + ck];
    const float v1 = wx0 * t[row + ck] + wx1 * t[row + c + ck];
    out[k] = wy0 * v0 + wy1 * v1;
  }
}

__device__ __forceinline__ float map1(const PsdrBsdfEntry& b, int j, float u,
                                      float v) {
  float out;
  eval_map(b.map[j], b.channels[j], u, v, 1, &out);
  return out;
}

// -- core/warp.py -------------------------------------------------------------

__device__ __forceinline__ void concentric(float s0, float s1, float* px,
                                           float* py) {
  const float x = 2.0f * s0 - 1.0f;
  const float y = 2.0f * s1 - 1.0f;
  const bool is_zero = x == 0.0f && y == 0.0f;
  const bool q13 = fabsf(x) < fabsf(y);
  const float r = q13 ? y : x;
  const float rp = q13 ? x : y;
  float phi = kQuarterPi * rp / (r == 0.0f ? 1.0f : r);
  phi = q13 ? kHalfPi - phi : phi;
  phi = is_zero ? 0.0f : phi;
  *px = r * cosf(phi);
  *py = r * sinf(phi);
}

// -- bsdf/diffuse.py ------------------------------------------------------------

__device__ __forceinline__ void eval_diffuse(const PsdrBsdfEntry& b, V3 wi,
                                             float u, float v, V3 wo,
                                             float* f) {
  float refl[3];
  eval_map(b.map[0], b.channels[0], u, v, 3, refl);
  const float s = kInvPi * wo.z;
  const bool ok = wi.z > 0.0f && wo.z > 0.0f;
  for (int k = 0; k < 3; ++k) f[k] = ok ? refl[k] * s : 0.0f;
}

__device__ __forceinline__ float pdf_diffuse(V3 wi, V3 wo) {
  return wi.z > 0.0f && wo.z > 0.0f ? kInvPi * wo.z : 0.0f;
}

__device__ __forceinline__ bool sample_diffuse(V3 wi, float s0, float s1,
                                               float* pdf, V3* wo) {
  float px, py;
  concentric(s0, s1, &px, &py);
  const float z = safe_sqrt(1.0f - (px * px + py * py));
  *wo = {px, py, z};
  *pdf = kInvPi * z;
  return wi.z > 0.0f;
}

// -- bsdf/ggx.py ----------------------------------------------------------------

__device__ __forceinline__ float ggx_eval(float au, float av, V3 m) {
  const float alpha_uv = au * av;
  const float t = (sqr(m.x / au) + sqr(m.y / av)) + sqr(m.z);
  const float denom = (kPi * alpha_uv) * sqr(t);
  const float result = 1.0f / (denom > 0.0f ? denom : 1.0f);
  return result * m.z > 1e-5f ? result : 0.0f;
}

__device__ __forceinline__ float ggx_smith_g1(float au, float av, V3 v,
                                              V3 m) {
  const float xy_alpha_2 = sqr(au * v.x) + sqr(av * v.y);
  const float vz2 = sqr(v.z);
  const float tan_theta_alpha_2 = xy_alpha_2 / (vz2 > 0.0f ? vz2 : 1.0f);
  float result =
      (1.0f / (1.0f + __fsqrt_rn(1.0f + tan_theta_alpha_2))) * 2.0f;
  result = xy_alpha_2 == 0.0f ? 1.0f : result;
  return dot(v, m) * v.z <= 0.0f ? 0.0f : result;
}

// GGX visible-normal slope sampling for alpha = 1
__device__ __forceinline__ void sample_visible_11(float cos_theta_i, float s0,
                                                  float s1, float* sx,
                                                  float* sy) {
  float px, py;
  concentric(s0, s1, &px, &py);
  const float s = 0.5f * (1.0f + cos_theta_i);
  const float x = px;
  const float y = safe_sqrt(1.0f - sqr(x)) * (1.0f - s) + py * s;
  const float z = safe_sqrt(1.0f - (sqr(x) + sqr(y)));
  const float sin_theta_i = safe_sqrt(1.0f - sqr(cos_theta_i));
  const float norm_f =
      1.0f / clamp_min(sin_theta_i * y + cos_theta_i * z, 1e-20f);
  *sx = (cos_theta_i * y - sin_theta_i * z) * norm_f;
  *sy = x * norm_f;
}

__device__ __forceinline__ V3 ggx_sample(float au, float av, V3 wi, float s0,
                                         float s1) {
  const V3 wi_p = normalize({au * wi.x, av * wi.y, wi.z});
  const float st2 = clamp_min(sqr(wi_p.x) + sqr(wi_p.y), 1e-20f);
  const float inv_st = rsqrtf(st2);
  // sin/cos phi of wi_p; a (nearly) vertical direction takes phi = 0
  const bool vertical = st2 <= 4e-5f;
  const float sp = vertical ? 0.0f : clamp(wi_p.y * inv_st, -1.0f, 1.0f);
  const float cp = vertical ? 1.0f : clamp(wi_p.x * inv_st, -1.0f, 1.0f);
  float sl0, sl1;
  sample_visible_11(wi_p.z, s0, s1, &sl0, &sl1);
  const float sx = (cp * sl0 - sp * sl1) * au;
  const float sy = (sp * sl0 + cp * sl1) * av;
  return normalize({-sx, -sy, 1.0f});
}

// core/math.py fresnel_conductor, one channel
__device__ __forceinline__ float fresnel_conductor(float eta_r, float eta_i,
                                                   float c) {
  const float cos2 = sqr(c);
  const float sin2 = 1.0f - cos2;
  const float sin4 = sqr(sin2);
  const float temp_1 = (sqr(eta_r) - sqr(eta_i)) - sin2;
  const float a_2_pb_2 = safe_sqrt(sqr(temp_1) + 4.0f * sqr(eta_i * eta_r));
  const float a = safe_sqrt(0.5f * (a_2_pb_2 + temp_1));
  const float term_1 = a_2_pb_2 + cos2;
  const float term_2 = 2.0f * c * a;
  const float r_s = (term_1 - term_2) / (term_1 + term_2);
  const float term_3 = a_2_pb_2 * cos2 + sin4;
  const float term_4 = term_2 * sin2;
  const float r_p = r_s * (term_3 - term_4) / (term_3 + term_4);
  return 0.5f * (r_s + r_p);
}

// -- bsdf/roughconductor.py -----------------------------------------------------

__device__ __forceinline__ void eval_roughconductor(const PsdrBsdfEntry& b,
                                                    V3 wi, float u, float v,
                                                    V3 wo, float* f) {
  const float cti = wi.z;
  bool active = cti > 0.0f && wo.z > 0.0f;
  const float au = map1(b, kAlphaU, u, v), av = map1(b, kAlphaV, u, v);
  const V3 h = normalize({wo.x + wi.x, wo.y + wi.y, wo.z + wi.z});
  const float d = ggx_eval(au, av, h);
  active = active && d != 0.0f;
  const float g = ggx_smith_g1(au, av, wi, h) * ggx_smith_g1(au, av, wo, h);
  const float result = d * g / (active ? 4.0f * cti : 1.0f);
  float eta[3], k[3], spec[3];
  eval_map(b.map[kEta], b.channels[kEta], u, v, 3, eta);
  eval_map(b.map[kK], b.channels[kK], u, v, 3, k);
  const float c = dot(wi, h);
  eval_map(b.map[kSpecular], b.channels[kSpecular], u, v, 3, spec);
  for (int j = 0; j < 3; ++j)
    f[j] = active ? fresnel_conductor(eta[j], k[j], c) * result * spec[j]
                  : 0.0f;
}

__device__ __forceinline__ float pdf_roughconductor(float au, float av, V3 wi,
                                                    V3 wo) {
  const float cti = wi.z;
  const V3 m = normalize({wo.x + wi.x, wo.y + wi.y, wo.z + wi.z});
  const bool active = cti > 0.0f && wo.z > 0.0f && dot(wi, m) > 0.0f &&
                      dot(wo, m) > 0.0f;
  const float result = ggx_eval(au, av, m) * ggx_smith_g1(au, av, wi, m) /
                       (active ? 4.0f * cti : 1.0f);
  return active ? result : 0.0f;
}

__device__ __forceinline__ bool sample_roughconductor(float au, float av,
                                                      V3 wi, float s0,
                                                      float s1, float* pdf,
                                                      V3* wo) {
  const V3 m = ggx_sample(au, av, wi, s0, s1);
  const float d2 = 2.0f * dot(wi, m);
  *wo = {m.x * d2 - wi.x, m.y * d2 - wi.y, m.z * d2 - wi.z};
  *pdf = pdf_roughconductor(au, av, wi, *wo);
  return wi.z > 0.0f && *pdf != 0.0f && wo->z > 0.0f;
}

// -- the dispatch -----------------------------------------------------------------

template <int M>
__global__ void __launch_bounds__(kThreads)
bsdf_kernel(const __grid_constant__ PsdrBsdfTable table,
            const __grid_constant__ PsdrBsdfLanes in, const PsdrBsdfOut out) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (i >= in.n) return;
  const int32_t id = in.active[i * in.active_s] ? in.id[i * in.id_s] : -1;
  if (id < 0 || id >= table.count) {
    if (M == kPdf) {
      out.pdf[i] = 0.0f;
    } else {
      out.f[3 * i] = out.f[3 * i + 1] = out.f[3 * i + 2] = 0.0f;
      if (M == kSample) {
        out.pdf[i] = 0.0f;
        out.valid[i] = false;
      }
    }
    return;
  }
  const PsdrBsdfEntry& b = table.bsdf[id];
  const V3 wi = load3(in.wi, in.wi_s, i);
  // the texture coordinates, read only where a map needs them
  float u = 0.0f, v = 0.0f;
  if (b.textured && !(M == kSample && b.kind == kDiffuse)) {
    const float* p = in.uv + i * in.uv_s[0];
    u = p[0];
    v = p[in.uv_s[1]];
  }
  if (M == kSample) {
    const float* p = in.x + i * in.x_s[0];
    const float s0 = p[0], s1 = p[in.x_s[1]];
    float pdf;
    V3 wo;
    bool valid;
    if (b.kind == kDiffuse) {
      valid = sample_diffuse(wi, s0, s1, &pdf, &wo);
    } else {
      valid = sample_roughconductor(map1(b, kAlphaU, u, v),
                                    map1(b, kAlphaV, u, v), wi, s0, s1, &pdf,
                                    &wo);
    }
    out.valid[i] = valid;
    out.pdf[i] = pdf;
    out.f[3 * i] = wo.x;
    out.f[3 * i + 1] = wo.y;
    out.f[3 * i + 2] = wo.z;
    return;
  }
  const V3 wo = load3(in.x, in.x_s, i);
  // the dispatch adds each BSDF's masked value to zeros: 0 + value
  if (M == kPdf) {
    const float pdf =
        b.kind == kDiffuse
            ? pdf_diffuse(wi, wo)
            : pdf_roughconductor(map1(b, kAlphaU, u, v),
                                 map1(b, kAlphaV, u, v), wi, wo);
    out.pdf[i] = 0.0f + pdf;
    return;
  }
  float f[3];
  if (b.kind == kDiffuse)
    eval_diffuse(b, wi, u, v, wo, f);
  else
    eval_roughconductor(b, wi, u, v, wo, f);
  out.f[3 * i] = 0.0f + f[0];
  out.f[3 * i + 1] = 0.0f + f[1];
  out.f[3 * i + 2] = 0.0f + f[2];
}

inline unsigned blocks(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int psdr_bsdf(int mode, const PsdrBsdfTable* table,
                         const PsdrBsdfLanes* lanes, const PsdrBsdfOut* out,
                         void* stream) {
  if (lanes->n > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (mode == kEval)
      bsdf_kernel<kEval><<<blocks(lanes->n), kThreads, 0, s>>>(*table, *lanes,
                                                                *out);
    else if (mode == kPdf)
      bsdf_kernel<kPdf><<<blocks(lanes->n), kThreads, 0, s>>>(*table, *lanes,
                                                               *out);
    else
      bsdf_kernel<kSample><<<blocks(lanes->n), kThreads, 0, s>>>(
          *table, *lanes, *out);
  }
  return static_cast<int>(cudaGetLastError());
}
