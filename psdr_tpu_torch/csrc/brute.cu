// K2: dense brute-force closest hit, every ray against every triangle, one
// thread per ray.
//
// Replaces psdr_tpu/accel/pallas_kernel.py, ray_intersect_pallas / _kernel:
// the TPU kernel keeps a ray block's (t, id, u, v) accumulator resident in
// VMEM while (9, T) triangle chunks stream past it over a sequential grid
// axis. Here each thread keeps its ray's accumulator in registers and the
// CTA streams the triangles through shared memory in tiles of kTile, the
// loop inside the block taking the place of the TPU's sequential grid axis.
//
// What bounds it on an H100: on the main path (the emitter-first bounce
// sweep, 2 emitter faces per 2^21 rays) it reads 29 bytes of ray and
// writes 16 bytes of hit per thread, so it is bound by device-memory
// bandwidth; the triangle tile costs one shared-memory load per triangle
// component, broadcast to the warp. With many triangles (the small-scene
// fallback of a closest-hit query) the Moller-Trumbore arithmetic bounds
// it: some 40 flops per (ray, triangle) pair, from shared memory.
//
// Contract: the HitRecord of accel/bruteforce.py brute_plain, bit for bit.
// The Moller-Trumbore runs operation for operation as moller_trumbore_tile
// and is built with --fmad=false, so it rounds as the tensor code does;
// triangles are visited in ascending id and a hit replaces the best only
// at a strictly smaller t, so ties go to the lowest id.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kRayEpsilon = 1e-3f;
constexpr int kTile = 256;  // triangles per shared-memory tile = CTA size

__global__ void __launch_bounds__(kTile)
k2_kernel(const float* __restrict__ p0, const float* __restrict__ e1,
          const float* __restrict__ e2, int n_tris,
          const float* __restrict__ ray_o, const float* __restrict__ ray_d,
          const float* __restrict__ tmax, const uint8_t* __restrict__ active,
          int n_rays, float* __restrict__ out_t, int32_t* __restrict__ out_tri,
          float* __restrict__ out_uv) {
  __shared__ float tile[9][kTile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < n_rays;
  const bool live = in_range && active[i];

  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float t_best = 0.f;
  if (live) {
    ox = ray_o[3 * i]; oy = ray_o[3 * i + 1]; oz = ray_o[3 * i + 2];
    dx = ray_d[3 * i]; dy = ray_d[3 * i + 1]; dz = ray_d[3 * i + 2];
    t_best = tmax[i];
  }
  int best = -1;
  float best_u = 0.f, best_v = 0.f;

  for (int base = 0; base < n_tris; base += kTile) {
    const int k = base + threadIdx.x;
    __syncthreads();  // the previous tile is consumed
    if (k < n_tris) {
      for (int c = 0; c < 3; ++c) {
        tile[c][threadIdx.x] = p0[3 * k + c];
        tile[3 + c][threadIdx.x] = e1[3 * k + c];
        tile[6 + c][threadIdx.x] = e2[3 * k + c];
      }
    }
    __syncthreads();
    const int count = min(kTile, n_tris - base);
    if (!live) continue;
    for (int j = 0; j < count; ++j) {
      const float p0x = tile[0][j], p0y = tile[1][j], p0z = tile[2][j];
      const float e1x = tile[3][j], e1y = tile[4][j], e1z = tile[5][j];
      const float e2x = tile[6][j], e2y = tile[7][j], e2z = tile[8][j];
      const float hx = dy * e2z - dz * e2y;
      const float hy = dz * e2x - dx * e2z;
      const float hz = dx * e2y - dy * e2x;
      float a = e1x * hx + e1y * hy + e1z * hz;
      a = fabsf(a) < 1e-20f ? 1e-20f : a;
      const float f = 1.0f / a;
      const float sx = ox - p0x, sy = oy - p0y, sz = oz - p0z;
      const float u = f * (sx * hx + sy * hy + sz * hz);
      const float qx = sy * e1z - sz * e1y;
      const float qy = sz * e1x - sx * e1z;
      const float qz = sx * e1y - sy * e1x;
      const float v = f * (dx * qx + dy * qy + dz * qz);
      const float t = f * (e2x * qx + e2y * qy + e2z * qz);
      if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > kRayEpsilon &&
          t < t_best) {
        t_best = t;
        best = base + j;
        best_u = u;
        best_v = v;
      }
    }
  }

  if (!in_range) return;
  out_t[i] = best >= 0 ? t_best : __int_as_float(0x7f800000);  // +inf
  out_tri[i] = best;
  out_uv[2 * i] = best_u;
  out_uv[2 * i + 1] = best_v;
}

}  // namespace

// Launches K2 on `stream` and returns cudaGetLastError() (0 = launched).
// p0/e1/e2 are (n_tris, 3) float32, rays (n_rays, 3); bools one byte each;
// every pointer is device memory.
extern "C" int psdr_k2_brute(const float* p0, const float* e1, const float* e2,
                             int n_tris, const float* ray_o,
                             const float* ray_d, const float* tmax,
                             const uint8_t* active, int n_rays, float* out_t,
                             int32_t* out_tri, float* out_uv, void* stream) {
  if (n_rays > 0) {
    const int blocks = (n_rays + kTile - 1) / kTile;
    k2_kernel<<<blocks, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
        p0, e1, e2, n_tris, ray_o, ray_d, tmax, active, n_rays, out_t, out_tri,
        out_uv);
  }
  return static_cast<int>(cudaGetLastError());
}
