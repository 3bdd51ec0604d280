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
// What bounds it on an H100: operations, and with them the instructions
// around them that are no flops; not device memory. 2^21 rays move 94 MB
// of rays and hits and read the bench scene's 1.5 MB of wide nodes and leaf
// rows once: 0.029 ms at 3.35 TB/s. The same rays need (counted by the
// COUNT instantiation below on an NVIDIA H100 80GB HBM3) 68-104 slab tests
// of 19 flops and 12-26 Moller-Trumbore tests, most of which end after u
// (25 flops) or after v (43) and few of which run in full (51): some
// 0.06-0.1 ms at 67 TFLOP/s, a peak that counts a fused multiply-add as
// two, which --fmad=false forbids here. The tree sits in the 50 MB L2 and
// its top in L1; with 28 warps resident on an SM the kernel's time did not
// move with occupancy, CTA size or staging, so what is left above the
// bound is the instructions around the flops (key packing, ordering,
// stack, control) and the divergence of a warp's 32 walks.
//
// What the design does about it:
// * 4-wide nodes (BVH.wide): one 128-byte, 128-byte-aligned record holds
//   the boxes of a node's four grandchildren component by component, and
//   their mask bits. A step is seven independent 16-byte loads of one cache
//   line and four slab tests, and the walk is half as deep as the binary
//   tree's, where every step waited on three loads from three arrays.
// * Near child first: the children that the ray enters are ordered by entry
//   distance (a 5-comparator network on the distance's bits), the nearest
//   is walked next and the others go on a stack in shared memory, each with
//   its entry distance, so that a popped node is dropped without a load
//   once the best hit is nearer. The best t shrinks early, so a closest-hit
//   walk prunes more, and an any-hit walk meets its blocker sooner.
// * Ties: the order of the leaves now depends on the ray, so a hit is taken
//   at a smaller t, or at an equal t and a lower padded slot: the lowest
//   (t, slot) over all leaves, whatever the order. A subtree is skipped only
//   when the ray enters its box beyond kCullMargin times the best t: the
//   slab test and the triangle's t round differently, and a subtree that
//   holds an equal-t triangle of a lower slot must be walked. A wider cull
//   changes the cost, never the result. The record equals the plain
//   version's (which culls against tmax alone) as long as no hit's computed
//   t lies more than that margin below the distance at which the ray enters
//   the triangle's boxes. Moller-Trumbore's t is that sure except where it
//   is badly conditioned: rays that meet a triangle's plane at a sine below
//   1e-3 from hundreds of edge lengths away, where t is off by up to
//   percents and the walk may return another hit, never a nearer one
//   (tests/test_torch_intersect.py holds both sides of that line).
// * Fewer instructions a step: each axis reads the plane the ray meets
//   first and the one it meets last, chosen once per ray by the sign of its
//   direction, which gives the values of the min/max form at 6 flops an
//   axis in place of 8; a triangle that fails on u or on v is left before
//   the rest of its test is computed.
// * Leaves in a phase of their own: a ray walks wide nodes until it stands
//   at a leaf, so that the rays of a warp run the long triangle tests
//   together and not one ray's leaf beside another's node.
// * Leaves as vectors: with 4 triangles a leaf, a leaf row is nine 16-byte
//   loads and one 4-byte load of its validity bytes, started together, then
//   four Moller-Trumbore tests in registers. Other leaf sizes take scalars.
// * Rays come in through shared memory, coalesced; uv goes out as float2.
// * 128 rays a CTA and 4 CTAs an SM asked of the compiler: 64 or 256
//   threads and 8 CTAs measured within 2% or slower. Measured slower and
//   not in this source (PERF.md has the times): the top of the tree staged
//   in shared memory by every CTA, a persistent grid that loops over ray
//   tiles, children walked in slot order, and nodes and leaves in one loop.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC
// --fmad=false keeps a*b+c as two rounded operations, so the kernel rounds
// exactly as the plain PyTorch version in accel/intersect.py does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // rays (threads) per CTA
constexpr int kMinCtas = 4;    // resident CTAs per SM asked of the compiler
constexpr float kRayEpsilon = 1e-3f;
constexpr float kCullMargin = 1.0001f;
constexpr int kMiss = 0x7fffffff;

__device__ __forceinline__ float guarded_inv(float d) {
  // same guard as the JAX package: |d| < 1e-20 -> +-1e-20 before 1/d
  float g = fabsf(d) < 1e-20f ? (d < 0.0f ? -1e-20f : 1e-20f) : d;
  return 1.0f / g;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tmax;
  // which 16-byte group of a wide record holds the planes the ray meets
  // first on each axis: lo (0, 1, 2) for a positive direction, else hi
  int nx, ny, nz;
};

struct Best {
  float t, u, v;
  int slot;
};

// Slab test of one child box over (RayEpsilon, far), given the planes the
// ray meets first (n) and last (f) on each axis: the values of the min/max
// form, (lo - o) * i against (hi - o) * i, at 6 flops an axis in place of
// 8: 19 flops, 3 x (2 sub, 2 mul, a min, a max) and the compare. Returns
// the sort key of an entered child, its entry distance's bits with the
// child's number in the two lowest (distances are positive, so their bits
// order as they do), or kMiss.
__device__ __forceinline__ int slab_key(float nx, float ny, float nz,
                                        float fx, float fy, float fz,
                                        float mask, const Ray& r, float far,
                                        int c) {
  float tn = fmaxf(kRayEpsilon, (nx - r.ox) * r.ix);
  float tf = fminf(far, (fx - r.ox) * r.ix);
  tn = fmaxf(tn, (ny - r.oy) * r.iy); tf = fminf(tf, (fy - r.oy) * r.iy);
  tn = fmaxf(tn, (nz - r.oz) * r.iz); tf = fminf(tf, (fz - r.oz) * r.iz);
  return (mask != 0.0f && tn <= tf) ? ((__float_as_int(tn) & ~3) | c) : kMiss;
}

// How far a triangle test went, with the flops it had done by then: left
// after u (25: the arithmetic up to u and one compare), left after v (43),
// run in full (51: 45 of arithmetic, 6 of the accept test) and the hit
// rejected, or taken.
enum Stage { kLeftAtU = 0, kLeftAtV = 1, kRejected = 2, kTaken = 3 };

// Moller-Trumbore, operation for operation as accel/bruteforce.py
// moller_trumbore_tile, and the accept test with the tie rule; a triangle
// that fails on u or on v is left before the rest is computed.
__device__ __forceinline__ Stage test_triangle(
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
  if (!(u >= 0.0f)) return kLeftAtU;
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float v = f * (r.dx * qx + r.dy * qy + r.dz * qz);
  if (!(v >= 0.0f && u + v <= 1.0f)) return kLeftAtV;
  const float t = f * (e2x * qx + e2y * qy + e2z * qz);
  if (t > kRayEpsilon && t < r.tmax &&
      (t < best.t || (t == best.t && slot < best.slot))) {
    best.t = t;
    best.u = u;
    best.v = v;
    best.slot = slot;
    return kTaken;
  }
  return kRejected;
}

__device__ __forceinline__ float lane4(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// What the counting instantiation adds up for a ray: n[0] slab tests of
// non-empty children, n[1 + s] triangle tests that went as far as stage s
// (rejected and taken together).
struct Counts {
  unsigned long long n[4];
};

// One wide node: four slab tests over (RayEpsilon, far); the entered
// children but the nearest go on the stack, farthest first, each with its
// entry distance's bits; returns the nearest's id, or -1.
template <bool COUNT>
__device__ __forceinline__ int visit(const float4* __restrict__ rec,
                                     int child0, const Ray& r, float far,
                                     int2*& st, Counts& counts) {
  // near and far planes of the four children on x, y, z, and their masks
  const int at[7] = {r.nx, r.ny, r.nz, 3 - r.nx, 5 - r.ny, 7 - r.nz, 6};
  float4 b[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) b[k] = __ldg(rec + at[k]);
  int k0 = slab_key(b[0].x, b[1].x, b[2].x, b[3].x, b[4].x, b[5].x, b[6].x,
                    r, far, 0);
  int k1 = slab_key(b[0].y, b[1].y, b[2].y, b[3].y, b[4].y, b[5].y, b[6].y,
                    r, far, 1);
  int k2 = slab_key(b[0].z, b[1].z, b[2].z, b[3].z, b[4].z, b[5].z, b[6].z,
                    r, far, 2);
  int k3 = slab_key(b[0].w, b[1].w, b[2].w, b[3].w, b[4].w, b[5].w, b[6].w,
                    r, far, 3);
  if (COUNT)
    counts.n[0] += (b[6].x != 0.0f) + (b[6].y != 0.0f) + (b[6].z != 0.0f) +
                   (b[6].w != 0.0f);
  // ascending keys: the nearest entered child first, misses last
  const int a0 = min(k0, k1), a1 = max(k0, k1);
  const int a2 = min(k2, k3), a3 = max(k2, k3);
  const int m0 = max(a0, a2), m1 = min(a1, a3);
  k0 = min(a0, a2); k3 = max(a1, a3);
  k1 = min(m0, m1); k2 = max(m0, m1);
  if (k3 != kMiss) {
    *st = make_int2(child0 + (k3 & 3), k3 & ~3);
    st += kThreads;
  }
  if (k2 != kMiss) {
    *st = make_int2(child0 + (k2 & 3), k2 & ~3);
    st += kThreads;
  }
  if (k1 != kMiss) {
    *st = make_int2(child0 + (k1 & 3), k1 & ~3);
    st += kThreads;
  }
  return k0 != kMiss ? child0 + (k0 & 3) : -1;
}

// One leaf: its valid triangles in slot order, up to the first hit taken in
// any-hit mode. Returns whether a hit was taken.
template <bool COUNT>
__device__ __forceinline__ bool test_leaf(
    int leaf, int L, const float* __restrict__ leaf_tris,
    const uint8_t* __restrict__ tri_valid, int any_hit, const Ray& r,
    Best& best, Counts& counts) {
  bool taken = false;
  if (L == 4) {
    const float4* row =
        reinterpret_cast<const float4*>(leaf_tris) + 9 * (size_t)leaf;
    float4 c[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) c[k] = __ldg(row + k);
    const uint32_t ok =
        __ldg(reinterpret_cast<const uint32_t*>(tri_valid) + leaf);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!((ok >> (8 * j)) & 0xffu) || (any_hit && taken)) continue;
      const Stage s = test_triangle(
          lane4(c[0], j), lane4(c[1], j), lane4(c[2], j), lane4(c[3], j),
          lane4(c[4], j), lane4(c[5], j), lane4(c[6], j), lane4(c[7], j),
          lane4(c[8], j), leaf * 4 + j, r, best);
      if (COUNT) ++counts.n[1 + min((int)s, (int)kRejected)];
      taken |= s == kTaken;
    }
  } else {
    const float* row = leaf_tris + (size_t)leaf * 9 * L;
    for (int j = 0; j < L && !(any_hit && taken); ++j) {
      if (!tri_valid[(size_t)leaf * L + j]) continue;
      const Stage s = test_triangle(
          row[j], row[L + j], row[2 * L + j], row[3 * L + j], row[4 * L + j],
          row[5 * L + j], row[6 * L + j], row[7 * L + j], row[8 * L + j],
          leaf * L + j, r, best);
      if (COUNT) ++counts.n[1 + min((int)s, (int)kRejected)];
      taken |= s == kTaken;
    }
  }
  return taken;
}

// One CTA per tile of kThreads rays. COUNT: the counting instantiation adds
// every ray's Counts to out_counts[0 .. 3].
template <bool COUNT>
__global__ void __launch_bounds__(kThreads, kMinCtas)
k1_kernel(const float4* __restrict__ wide, int n_wide, int n_roots,
          const float* __restrict__ leaf_tris,
          const uint8_t* __restrict__ tri_valid,
          const int32_t* __restrict__ perm, int leaf_size,
          const float* __restrict__ ray_o, const float* __restrict__ ray_d,
          const float* __restrict__ tmax, const uint8_t* __restrict__ active,
          int n_rays, int any_hit, float* __restrict__ out_t,
          int32_t* __restrict__ out_tri, float2* __restrict__ out_uv,
          unsigned long long* __restrict__ out_counts) {
  // shared memory: [this tile's rays][the stacks, entry k of thread tid at
  // k * kThreads + tid]
  extern __shared__ float4 smem[];
  float* s_ray = reinterpret_cast<float*>(smem);
  int2* stack = reinterpret_cast<int2*>(s_ray + 6 * kThreads);
  const int tid = threadIdx.x;
  const int base = blockIdx.x * kThreads;
  const int cnt = min(kThreads, n_rays - base);
  for (int k = tid; k < 3 * cnt; k += kThreads) {
    s_ray[k] = ray_o[3 * (size_t)base + k];
    s_ray[3 * kThreads + k] = ray_d[3 * (size_t)base + k];
  }
  __syncthreads();  // the last barrier: a thread without a ray may idle

  Counts counts = {{0, 0, 0, 0}};
  if (tid < cnt) {
    const int i = base + tid;
    Ray r;
    r.tmax = tmax[i];
    Best best = {r.tmax, 0.0f, 0.0f, -1};
    if (active[i]) {
      r.ox = s_ray[3 * tid]; r.oy = s_ray[3 * tid + 1];
      r.oz = s_ray[3 * tid + 2];
      r.dx = s_ray[3 * kThreads + 3 * tid];
      r.dy = s_ray[3 * kThreads + 3 * tid + 1];
      r.dz = s_ray[3 * kThreads + 3 * tid + 2];
      r.ix = guarded_inv(r.dx); r.iy = guarded_inv(r.dy);
      r.iz = guarded_inv(r.dz);
      r.nx = r.ix >= 0.0f ? 0 : 3;
      r.ny = r.iy >= 0.0f ? 1 : 4;
      r.nz = r.iz >= 0.0f ? 2 : 5;

      // ids below n_wide are wide nodes, the others leaves (id - n_wide);
      // -1: pop the next id
      int2* st = stack + tid;
      if (n_roots == 2) {
        *st = make_int2(1, __float_as_int(kRayEpsilon));
        st += kThreads;
      }
      int cur = 0;
      for (;;) {
        // walk wide nodes until the ray stands at a leaf or its stack is
        // empty: the warp's rays then test their leaves together
        while (cur < n_wide) {
          if (cur < 0) {
            if (st == stack + tid) break;
            st -= kThreads;
            const int2 e = *st;
            if (__int_as_float(e.y) <= best.t * kCullMargin) cur = e.x;
            continue;
          }
          cur = visit<COUNT>(wide + 8 * (size_t)cur, 4 * cur + n_roots, r,
                             best.t * kCullMargin, st, counts);
        }
        if (cur < 0) break;
        const bool taken = test_leaf<COUNT>(cur - n_wide, leaf_size,
                                            leaf_tris, tri_valid, any_hit, r,
                                            best, counts);
        if (any_hit && taken) break;
        cur = -1;
      }
    }

    if (best.slot >= 0) {
      out_t[i] = best.t;
      out_tri[i] = perm[best.slot];
    } else {
      out_t[i] = __int_as_float(0x7f800000);  // +inf
      out_tri[i] = -1;
    }
    out_uv[i] = make_float2(best.u, best.v);
  }

  if (COUNT) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      unsigned long long n = counts.n[k];
      for (int s = 16; s > 0; s >>= 1)
        n += __shfl_down_sync(0xffffffffu, n, s);
      if ((tid & 31) == 0) atomicAdd(out_counts + k, n);
    }
  }
}

}  // namespace

// Launches K1 on `stream` and returns cudaGetLastError() (0 = launched).
// wide: the (n_wide, 32) records of BVH.wide, whose walk starts from ids
// 0 .. n_roots - 1 and is n_levels wide levels deep; leaf_tris (P, 9L),
// tri_valid (P, L) and perm (P * L) as accel/bvh.py lays them out. counts:
// null, or four 64-bit counters that the counting instantiation adds this
// launch's slab tests and its triangle tests left after u, left after v and
// run in full to. Every pointer is device memory; bools are one byte each.
extern "C" int psdr_k1_intersect(
    const float* wide, int n_wide, int n_roots, int n_levels,
    const float* leaf_tris, const uint8_t* tri_valid, const int32_t* perm,
    int leaf_size, const float* ray_o, const float* ray_d, const float* tmax,
    const uint8_t* active, int n_rays, int any_hit, float* out_t,
    int32_t* out_tri, float* out_uv, unsigned long long* counts,
    void* stream) {
  if (n_rays > 0) {
    // a visit pops one id and pushes at most three
    const int stack_cap = 3 * n_levels + n_roots;
    const size_t smem = sizeof(float) * 6 * kThreads +
                        sizeof(int2) * (size_t)stack_cap * kThreads;
    auto kernel = counts ? k1_kernel<true> : k1_kernel<false>;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int grid = (n_rays + kThreads - 1) / kThreads;
    kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(wide), n_wide, n_roots, leaf_tris,
        tri_valid, perm, leaf_size, ray_o, ray_d, tmax, active, n_rays,
        any_hit, out_t, out_tri, reinterpret_cast<float2*>(out_uv), counts);
  }
  return static_cast<int>(cudaGetLastError());
}
