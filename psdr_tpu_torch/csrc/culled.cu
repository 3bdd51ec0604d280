// K3: block-culled closest hit, the cull and the sweep in one kernel. One
// CTA of R threads owns a block of R rays, one thread per ray, and walks
// the B leaf blocks of T slots of the refit BVH (psdr_tpu_torch/accel/
// bvh.py) in ascending order: every thread slab-tests its ray against the
// leaf block's AABB (the heap level with B nodes), the CTA votes, and only
// a block that some ray enters is staged and swept.
//
// Replaces psdr_tpu/accel/pallas_kernel.py, ray_intersect_pallas_culled /
// _culled_kernel: the TPU version culls in tensor code, compacts each ray
// block's occupied leaf blocks into a list, DMAs each listed (16, T)
// triangle row into VMEM, double-buffered, and runs a dense (T, R)
// Moller-Trumbore tile per block. Here there is no list: the boxes and
// mask bits of up to kBoxChunk leaf blocks at a time sit in shared memory,
// the vote is a __syncthreads_or, and an occupied block's 9 components and
// validity (10 x T floats) are staged with 16-byte loads and read back as
// 16-byte broadcasts, four triangles at a time. Blocks and the slots
// within them are visited in ascending order and a hit replaces the best
// only at a strictly smaller t, so ties go to the lowest slot, as in the
// plain version (k1_plain) and the TPU kernel.
//
// The far end of a ray's slab test is its running best t (times kCullMargin,
// because the slab test and the triangle's t round differently), not its
// tmax as in the plain version's cull: later blocks hold higher slots, so a
// block that the ray enters beyond its best t cannot change the result
// (as long as a hit's computed t is no further than that margin below the
// box's entry distance: see the note on ties in intersect.cu).
//
// What bounds it on an H100: operations, none of them fused multiply-adds
// (--fmad=false). Per ray, B slab tests of 25 flops (the min/max form), and
// 25 to 51 flops per (ray, valid slot) pair, as far as the test goes, over
// every block that a ray of its ray block enters, dense as on the TPU; the
// staged rows are reused R times from shared memory, so device-memory
// traffic is small (the rays and hits, 94 MB per 2^21 rays: 0.029 ms). On
// the same rays it shares K1's bound; its own dense arithmetic stands above
// that by design (chip_smoke.py phase 7 prints both). Every live thread
// sweeps every block that the CTA voted in: on the bench scene's first
// camera chunk every ray enters the few blocks that hold a wall triangle,
// and letting a thread skip the blocks its own ray misses measured no
// faster there (4.38 ms with, 4.32 ms without; PERF.md). Every thread, live
// or not, reaches every barrier.
//
// Rounding: the Moller-Trumbore is operation for operation as
// accel/bruteforce.py moller_trumbore_tile, built with --fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kRayEpsilon = 1e-3f;
constexpr float kCullMargin = 1.0001f;
constexpr int kBoxChunk = 1024;  // leaf-block boxes staged at a time (28 KB)

__device__ __forceinline__ float guarded_inv(float d) {
  // same guard as the JAX package: |d| < 1e-20 -> +-1e-20 before 1/d
  float g = fabsf(d) < 1e-20f ? (d < 0.0f ? -1e-20f : 1e-20f) : d;
  return 1.0f / g;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

struct Best {
  float t, u, v;
  int slot;
};

__device__ __forceinline__ void test_triangle(
    float p0x, float p0y, float p0z, float e1x, float e1y, float e1z,
    float e2x, float e2y, float e2z, int slot, const Ray& r, Best& best) {
  const float hx = r.dy * e2z - r.dz * e2y;
  const float hy = r.dz * e2x - r.dx * e2z;
  const float hz = r.dx * e2y - r.dy * e2x;
  float a = e1x * hx + e1y * hy + e1z * hz;
  a = fabsf(a) < 1e-20f ? 1e-20f : a;
  const float f = 1.0f / a;
  const float sx = r.ox - p0x, sy = r.oy - p0y, sz = r.oz - p0z;
  const float u = f * (sx * hx + sy * hy + sz * hz);
  if (!(u >= 0.0f)) return;  // most triangles end here or on v
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float v = f * (r.dx * qx + r.dy * qy + r.dz * qz);
  if (!(v >= 0.0f && u + v <= 1.0f)) return;
  const float t = f * (e2x * qx + e2y * qy + e2z * qz);
  if (t > kRayEpsilon && t < best.t) {
    best.t = t;
    best.u = u;
    best.v = v;
    best.slot = slot;
  }
}

__device__ __forceinline__ float lane4(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// ray_block may be 1024: at most 64 registers a thread
__global__ void __launch_bounds__(1024)
k3_kernel(const float* __restrict__ nodes,
                          const uint8_t* __restrict__ node_mask,
                          const float* __restrict__ leaf_tris,
                          const uint8_t* __restrict__ tri_valid,
                          const int32_t* __restrict__ perm, int leaf_size,
                          int tri_block, int n_blocks,
                          const float* __restrict__ ray_o,
                          const float* __restrict__ ray_d,
                          const float* __restrict__ tmax,
                          const uint8_t* __restrict__ active, int n_rays,
                          float* __restrict__ out_t,
                          int32_t* __restrict__ out_tri,
                          float* __restrict__ out_uv) {
  // shared memory: rows (10, T): p0 e1 e2 xyz, valid; then the staged
  // chunk's boxes (7 floats each: lo xyz, hi xyz, mask)
  extern __shared__ float4 smem[];
  float* rows = reinterpret_cast<float*>(smem);
  const int T = tri_block, L = leaf_size, B = n_blocks;
  float* boxes = rows + 10 * T;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < n_rays;
  const bool live = in_range && active[i];

  Ray r = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float ix = 0.f, iy = 0.f, iz = 0.f;
  Best best = {0.f, 0.f, 0.f, -1};
  if (live) {
    r.ox = ray_o[3 * (size_t)i]; r.oy = ray_o[3 * (size_t)i + 1];
    r.oz = ray_o[3 * (size_t)i + 2];
    r.dx = ray_d[3 * (size_t)i]; r.dy = ray_d[3 * (size_t)i + 1];
    r.dz = ray_d[3 * (size_t)i + 2];
    ix = guarded_inv(r.dx); iy = guarded_inv(r.dy); iz = guarded_inv(r.dz);
    best.t = tmax[i];
  }

  for (int b0 = 0; b0 < B; b0 += kBoxChunk) {
    const int n_box = min(kBoxChunk, B - b0);
    __syncthreads();  // the previous chunk's boxes are consumed
    for (int k = threadIdx.x; k < n_box; k += blockDim.x) {
      // the leaf blocks are the heap nodes B .. 2B - 1
      const float* box = nodes + 6 * (size_t)(B + b0 + k);
      for (int c = 0; c < 6; ++c) boxes[7 * k + c] = box[c];
      boxes[7 * k + 6] = node_mask[B + b0 + k] ? 1.0f : 0.0f;
    }
    __syncthreads();
    for (int q = 0; q < n_box; ++q) {
      const float* box = boxes + 7 * q;
      bool enters = false;
      if (live && box[6] != 0.0f) {
        float t0 = (box[0] - r.ox) * ix, t1 = (box[3] - r.ox) * ix;
        float tn = fmaxf(kRayEpsilon, fminf(t0, t1));
        float tf = fminf(best.t * kCullMargin, fmaxf(t0, t1));
        t0 = (box[1] - r.oy) * iy; t1 = (box[4] - r.oy) * iy;
        tn = fmaxf(tn, fminf(t0, t1)); tf = fminf(tf, fmaxf(t0, t1));
        t0 = (box[2] - r.oz) * iz; t1 = (box[5] - r.oz) * iz;
        tn = fmaxf(tn, fminf(t0, t1)); tf = fminf(tf, fmaxf(t0, t1));
        enters = tn <= tf;
      }
      // the barrier of the vote also says: the previous rows are consumed
      if (!__syncthreads_or(enters)) continue;
      const int slot0 = (b0 + q) * T;
      if (L == 4) {
        // a leaf row is 9 float4; a block's rows are contiguous
        const float4* src =
            reinterpret_cast<const float4*>(leaf_tris) + 9 * (size_t)(slot0 / 4);
        for (int k = threadIdx.x; k < 9 * (T / 4); k += blockDim.x) {
          const int leaf = k / 9, c = k - 9 * leaf;
          *reinterpret_cast<float4*>(rows + c * T + 4 * leaf) = __ldg(src + k);
        }
        for (int k = threadIdx.x; k < T; k += blockDim.x)
          rows[9 * T + k] = tri_valid[slot0 + k] ? 1.0f : 0.0f;
      } else {
        for (int k = threadIdx.x; k < T; k += blockDim.x) {
          const int slot = slot0 + k;
          const int leaf = slot / L, j = slot - leaf * L;
          const float* row = leaf_tris + (size_t)leaf * 9 * L + j;
          for (int c = 0; c < 9; ++c) rows[c * T + k] = row[c * L];
          rows[9 * T + k] = tri_valid[slot] ? 1.0f : 0.0f;
        }
      }
      __syncthreads();
      if (!live) continue;
      if ((T & 3) == 0) {
        for (int k = 0; k < T; k += 4) {
          float4 c[10];
#pragma unroll
          for (int m = 0; m < 10; ++m)
            c[m] = *reinterpret_cast<const float4*>(rows + m * T + k);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (lane4(c[9], j) == 0.0f) continue;
            test_triangle(lane4(c[0], j), lane4(c[1], j), lane4(c[2], j),
                          lane4(c[3], j), lane4(c[4], j), lane4(c[5], j),
                          lane4(c[6], j), lane4(c[7], j), lane4(c[8], j),
                          slot0 + k + j, r, best);
          }
        }
      } else {
        for (int k = 0; k < T; ++k) {
          if (rows[9 * T + k] == 0.0f) continue;
          test_triangle(rows[k], rows[T + k], rows[2 * T + k],
                        rows[3 * T + k], rows[4 * T + k], rows[5 * T + k],
                        rows[6 * T + k], rows[7 * T + k], rows[8 * T + k],
                        slot0 + k, r, best);
        }
      }
    }
  }

  if (!in_range) return;
  if (best.slot >= 0) {
    out_t[i] = best.t;
    out_tri[i] = perm[best.slot];
  } else {
    out_t[i] = __int_as_float(0x7f800000);  // +inf
    out_tri[i] = -1;
  }
  reinterpret_cast<float2*>(out_uv)[i] = make_float2(best.u, best.v);
}

}  // namespace

// Launches K3 on `stream` and returns cudaGetLastError() (0 = launched).
// nodes (2P, 6) and node_mask (2P), leaf_tris (P, 9L), tri_valid (P, L) and
// perm (P * L) as accel/bvh.py lays them out; n_blocks = P * L / tri_block
// leaf blocks, a power of two; ray_block threads per CTA; bools one byte
// each; every pointer is device memory.
extern "C" int psdr_k3_culled(const float* nodes, const uint8_t* node_mask,
                              const float* leaf_tris,
                              const uint8_t* tri_valid, const int32_t* perm,
                              int leaf_size, int tri_block, int n_blocks,
                              int ray_block, const float* ray_o,
                              const float* ray_d, const float* tmax,
                              const uint8_t* active, int n_rays, float* out_t,
                              int32_t* out_tri, float* out_uv, void* stream) {
  if (n_rays > 0) {
    const int n_box = n_blocks < kBoxChunk ? n_blocks : kBoxChunk;
    const size_t smem =
        sizeof(float) * (10 * (size_t)tri_block + 7 * (size_t)n_box);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          k3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int grid = (n_rays + ray_block - 1) / ray_block;
    k3_kernel<<<grid, ray_block, smem, static_cast<cudaStream_t>(stream)>>>(
        nodes, node_mask, leaf_tris, tri_valid, perm, leaf_size, tri_block,
        n_blocks, ray_o, ray_d, tmax, active, n_rays, out_t, out_tri, out_uv);
  }
  return static_cast<int>(cudaGetLastError());
}
