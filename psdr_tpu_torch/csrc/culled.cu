// K3: block-culled closest hit. Tensor code (accel/intersect.py k3_cuda)
// slab-culls every block of R rays against every leaf block of T slots of
// the refit BVH and compacts each ray block's occupied leaf blocks, in
// ascending order, into a CSR list (starts, blocks); this kernel runs one
// CTA of R threads per ray block, one thread per ray, over that list.
//
// Replaces psdr_tpu/accel/pallas_kernel.py, ray_intersect_pallas_culled /
// _culled_kernel: the TPU kernel DMAs each occupied (16, T) triangle row
// into VMEM, double-buffered, and runs a dense (T, R) Moller-Trumbore tile
// per block. Here the CTA stages each occupied block's 9 components and
// validity (10 x T floats) in shared memory and every thread tests its ray
// against the T triangles from there. Blocks of a ray block are visited in
// the list's ascending order and slots within a block in ascending order;
// a hit replaces the best only at a strictly smaller t, so ties go to the
// lowest slot, as in the plain version (k1_plain) and the TPU kernel.
//
// What bounds it on an H100: arithmetic, some 40 flops per (ray, slot)
// pair over every slot of every occupied block, dense as on the TPU; the
// staged rows are reused R times from shared memory, so device-memory
// traffic is small. The two __syncthreads per block and the load of 10 x T
// floats by R threads are its fixed cost. Double buffering the rows
// (cp.async) is left for later work.
//
// Rounding: the Moller-Trumbore is operation for operation as
// accel/bruteforce.py moller_trumbore_tile, built with --fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kRayEpsilon = 1e-3f;

__global__ void k3_kernel(const float* __restrict__ leaf_tris,
                          const uint8_t* __restrict__ tri_valid,
                          const int32_t* __restrict__ perm, int leaf_size,
                          int tri_block, const int32_t* __restrict__ starts,
                          const int32_t* __restrict__ blocks,
                          const float* __restrict__ ray_o,
                          const float* __restrict__ ray_d,
                          const float* __restrict__ tmax,
                          const uint8_t* __restrict__ active, int n_rays,
                          float* __restrict__ out_t,
                          int32_t* __restrict__ out_tri,
                          float* __restrict__ out_uv) {
  extern __shared__ float rows[];  // (10, tri_block): p0 e1 e2 xyz, valid
  const int T = tri_block, L = leaf_size;
  const int rb = blockIdx.x;
  const int i = rb * blockDim.x + threadIdx.x;
  const bool in_range = i < n_rays;
  const bool live = in_range && active[i];

  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float t_best = 0.f;
  if (live) {
    ox = ray_o[3 * i]; oy = ray_o[3 * i + 1]; oz = ray_o[3 * i + 2];
    dx = ray_d[3 * i]; dy = ray_d[3 * i + 1]; dz = ray_d[3 * i + 2];
    t_best = tmax[i];
  }
  int best_slot = -1;
  float best_u = 0.f, best_v = 0.f;

  const int first = starts[rb], last = starts[rb + 1];
  for (int q = first; q < last; ++q) {
    const int blk = blocks[q];
    __syncthreads();  // the previous block's rows are consumed
    for (int k = threadIdx.x; k < T; k += blockDim.x) {
      const int slot = blk * T + k;
      const int leaf = slot / L, j = slot - leaf * L;
      const float* row = leaf_tris + (size_t)leaf * 9 * L + j;
      for (int c = 0; c < 9; ++c) rows[c * T + k] = row[c * L];
      rows[9 * T + k] = tri_valid[slot] ? 1.0f : 0.0f;
    }
    __syncthreads();
    if (!live) continue;
    for (int k = 0; k < T; ++k) {
      if (rows[9 * T + k] == 0.0f) continue;
      const float p0x = rows[k], p0y = rows[T + k], p0z = rows[2 * T + k];
      const float e1x = rows[3 * T + k], e1y = rows[4 * T + k],
                  e1z = rows[5 * T + k];
      const float e2x = rows[6 * T + k], e2y = rows[7 * T + k],
                  e2z = rows[8 * T + k];
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
        best_slot = blk * T + k;
        best_u = u;
        best_v = v;
      }
    }
  }

  if (!in_range) return;
  if (best_slot >= 0) {
    out_t[i] = t_best;
    out_tri[i] = perm[best_slot];
  } else {
    out_t[i] = __int_as_float(0x7f800000);  // +inf
    out_tri[i] = -1;
  }
  out_uv[2 * i] = best_u;
  out_uv[2 * i + 1] = best_v;
}

}  // namespace

// Launches K3 on `stream` and returns cudaGetLastError() (0 = launched).
// leaf_tris (P, 9L) and tri_valid (P, L) as accel/bvh.py lays them out;
// starts (n_ray_blocks + 1) and blocks (starts[n_ray_blocks]) the CSR list
// of occupied leaf blocks of tri_block slots; ray_block threads per CTA;
// bools one byte each; every pointer is device memory.
extern "C" int psdr_k3_culled(const float* leaf_tris, const uint8_t* tri_valid,
                              const int32_t* perm, int leaf_size,
                              int tri_block,
                              const int32_t* starts, const int32_t* blocks,
                              int n_ray_blocks, int ray_block,
                              const float* ray_o, const float* ray_d,
                              const float* tmax, const uint8_t* active,
                              int n_rays, float* out_t, int32_t* out_tri,
                              float* out_uv, void* stream) {
  if (n_rays > 0) {
    const size_t smem = sizeof(float) * 10 * (size_t)tri_block;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          k3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    k3_kernel<<<n_ray_blocks, ray_block, smem,
                static_cast<cudaStream_t>(stream)>>>(
        leaf_tris, tri_valid, perm, leaf_size, tri_block, starts, blocks,
        ray_o, ray_d, tmax, active, n_rays, out_t, out_tri, out_uv);
  }
  return static_cast<int>(cudaGetLastError());
}
