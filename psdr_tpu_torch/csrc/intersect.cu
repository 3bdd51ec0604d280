// K1: closest-hit and any-hit ray / triangle intersection against the
// refit implicit BVH (psdr_tpu_torch/accel/bvh.py), one thread per ray.
//
// Replaces psdr_tpu/accel/pallas_kernel.py, ray_intersect_pallas_culled2 /
// _culled2_kernel: the TPU kernel culls whole ray blocks against leaf-block
// AABBs, compacts the candidate blocks with a prefix-sum matmul and streams
// (16, T) triangle rows through a DMA ring, because a per-lane gather walk
// is latency-bound on the TPU's vector unit. A GPU thread walks a tree
// cheaply, so this kernel keeps the contract (same HitRecord, same
// Moller-Trumbore arithmetic, same tie rule) and drops the block schedule.
//
// What bounds it on an H100: dependent loads. Each traversal step reads one
// 24-byte node AABB, a mask byte and a skip link, and each visited leaf 4
// triangles of 36 bytes; the arithmetic per step is a few dozen flops. The
// tree of the 20k-triangle bench scene (16k nodes, ~1.3 MB with its leaf
// rows) sits in the 50 MB L2 after the first ray blocks, so a walk is bound
// by L2 latency and by warp divergence, not by HBM bandwidth. The design
// answers with what is cheap: a stackless walk (one int of state, so the
// thread keeps all of its state in registers), early termination in any-hit
// mode, and the running best t as the far end of every slab test.
// Wide nodes, treelets, ray sorting or a warp-cooperative cull are for
// later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC
// --fmad=false keeps a*b+c as two rounded operations, so the kernel rounds
// exactly as the plain PyTorch version in accel/intersect.py does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kRayEpsilon = 1e-3f;

__device__ __forceinline__ float guarded_inv(float d) {
  // same guard as the JAX package: |d| < 1e-20 -> +-1e-20 before 1/d
  float g = fabsf(d) < 1e-20f ? (d < 0.0f ? -1e-20f : 1e-20f) : d;
  return 1.0f / g;
}

__global__ void k1_kernel(const float* __restrict__ nodes,
                          const uint8_t* __restrict__ node_mask,
                          const int32_t* __restrict__ skip,
                          const float* __restrict__ leaf_tris,
                          const uint8_t* __restrict__ tri_valid,
                          const int32_t* __restrict__ perm,
                          int num_leaves, int leaf_size,
                          const float* __restrict__ ray_o,
                          const float* __restrict__ ray_d,
                          const float* __restrict__ tmax,
                          const uint8_t* __restrict__ active,
                          int n_rays, int any_hit,
                          float* __restrict__ out_t,
                          int32_t* __restrict__ out_tri,
                          float* __restrict__ out_uv) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;

  float t_best = tmax[i];
  int best_slot = -1;
  float best_u = 0.0f, best_v = 0.0f;

  if (active[i]) {
    const float ox = ray_o[3 * i], oy = ray_o[3 * i + 1], oz = ray_o[3 * i + 2];
    const float dx = ray_d[3 * i], dy = ray_d[3 * i + 1], dz = ray_d[3 * i + 2];
    const float ix = guarded_inv(dx), iy = guarded_inv(dy), iz = guarded_inv(dz);
    const int L = leaf_size;
    int node = 1;
    while (node > 0) {
      bool hit = false;
      if (node_mask[node]) {
        const float* b = nodes + 6 * node;
        float t0 = (b[0] - ox) * ix, t1 = (b[3] - ox) * ix;
        float tn = fmaxf(kRayEpsilon, fminf(t0, t1));
        float tf = fminf(t_best, fmaxf(t0, t1));
        t0 = (b[1] - oy) * iy; t1 = (b[4] - oy) * iy;
        tn = fmaxf(tn, fminf(t0, t1)); tf = fminf(tf, fmaxf(t0, t1));
        t0 = (b[2] - oz) * iz; t1 = (b[5] - oz) * iz;
        tn = fmaxf(tn, fminf(t0, t1)); tf = fminf(tf, fmaxf(t0, t1));
        hit = tn <= tf;
      }
      if (hit && node < num_leaves) {
        node = 2 * node;
        continue;
      }
      if (hit) {
        const int leaf = node - num_leaves;
        const float* row = leaf_tris + (size_t)leaf * 9 * L;
        bool done = false;
        for (int j = 0; j < L; ++j) {
          if (!tri_valid[(size_t)leaf * L + j]) continue;
          const float p0x = row[j], p0y = row[L + j], p0z = row[2 * L + j];
          const float e1x = row[3 * L + j], e1y = row[4 * L + j],
                      e1z = row[5 * L + j];
          const float e2x = row[6 * L + j], e2y = row[7 * L + j],
                      e2z = row[8 * L + j];
          // Moller-Trumbore, operation for operation as
          // accel/bruteforce.py moller_trumbore_tile
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
            best_slot = leaf * L + j;
            best_u = u;
            best_v = v;
            if (any_hit) {
              done = true;
              break;
            }
          }
        }
        if (done) break;
      }
      node = skip[node];
    }
  }

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

// Launches K1 on `stream` and returns cudaGetLastError() (0 = launched).
// Every pointer is device memory; bools are one byte each.
extern "C" int psdr_k1_intersect(
    const float* nodes, const uint8_t* node_mask, const int32_t* skip,
    const float* leaf_tris, const uint8_t* tri_valid, const int32_t* perm,
    int num_leaves, int leaf_size, const float* ray_o, const float* ray_d,
    const float* tmax, const uint8_t* active, int n_rays, int any_hit,
    float* out_t, int32_t* out_tri, float* out_uv, void* stream) {
  if (n_rays > 0) {
    const int threads = 128;
    const int blocks = (n_rays + threads - 1) / threads;
    k1_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        nodes, node_mask, skip, leaf_tris, tri_valid, perm, num_leaves,
        leaf_size, ray_o, ray_d, tmax, active, n_rays, any_hit, out_t,
        out_tri, out_uv);
  }
  return static_cast<int>(cudaGetLastError());
}
