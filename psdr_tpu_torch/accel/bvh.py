"""BVH over Morton-sorted triangle chunks: a complete implicit binary tree.
Counterpart of ``psdr_tpu/accel/bvh.py``: the topology, the refit and the
two public traversals, ``ray_intersect_culled`` (K3 on the card) and
``ray_intersect_bvh`` (K1 on the card).

* Static topology, dynamic refit. The tree is complete over ``P``
  (power-of-two) leaves of ``L`` Morton-sorted triangles. The triangle
  permutation and the preorder skip links depend only on the geometry at
  build time and are made once on the host; a new scene build only refits
  the AABBs.
* Heap indexing + skip links. Node ``i`` has children ``2i, 2i+1``; leaves
  live at ``[P, 2P)``. ``skip[i]`` is the next preorder node after subtree
  ``i`` (0 = done), so a stackless traversal carries one node index. The
  plain version of the kernels (``accel/intersect.py`` ``k1_plain``) and K3
  read the binary ``nodes`` and ``node_mask``.
* Wide nodes. K1's CUDA kernel walks the same tree collapsed into 4-wide
  nodes, ``BVH.wide``: one 128-byte record per node that holds the boxes
  and mask bits of its four grandchildren in the binary tree, so a step of
  the walk is one record and four slab tests and the depth halves. The
  tree is complete, so the collapse is a reshape of the refit's per-level
  boxes (``wide_layout``, ``_wide_nodes``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class BVHTopology(NamedTuple):
    """Host-built part: depends on triangle order, not positions."""
    perm: np.ndarray        # (P*L,) int32: padded slot -> original tri id, -1 pad
    skip: np.ndarray        # (2P,) int32: preorder skip links, 0 = done
    num_leaves: int         # P (power of two)
    leaf_size: int          # L
    num_faces: int          # original (unpadded) triangle count


class BVH(NamedTuple):
    """Refit result consumed by traversal (all detached)."""
    nodes: torch.Tensor      # (2P, 6) heap order: [lo.xyz, hi.xyz]; row 0 unused
    node_mask: torch.Tensor  # (2P,) bool: subtree holds a real triangle. An
                             # empty (+inf, -inf) AABB turns into (-inf, +inf)
                             # under the slab min/max swap and would hit
                             # every ray, so traversal tests the mask first.
    leaf_tris: torch.Tensor  # (P, 9L) per leaf [p0x*L, p0y*L, p0z*L, e1x*L, ...]
    tri_valid: torch.Tensor  # (P, L) bool
    perm: torch.Tensor       # (P*L,) int32 (-1 for padding)
    skip: torch.Tensor       # (2P,) int32 preorder skip links
    wide: torch.Tensor       # (max(W, 1), 32) float32 4-wide nodes, see
                             # ``wide_layout``: [lo.x*4, lo.y*4, lo.z*4,
                             # hi.x*4, hi.y*4, hi.z*4, mask*4 (1.0 / 0.0),
                             # 0*4], child c in column c of each group

    @property
    def num_leaves(self) -> int:
        return self.nodes.shape[0] // 2

    @property
    def leaf_size(self) -> int:
        return self.leaf_tris.shape[1] // 9


class WideLayout(NamedTuple):
    """The 4-wide collapse of a complete binary tree over P = 2^D leaves.

    Wide level k stands for the binary nodes of level D % 2 + 2k; its
    children are their grandchildren. With an odd D the binary root is
    left out and the walk starts from its two children (``roots`` = 2).
    Levels are stored one after the other, so that wide node w has the
    children 4w + roots + c, c = 0..3; an id of ``nodes`` or more is the
    leaf ``id - nodes``. P = 1 and P = 2 have no wide node: their roots
    are the leaves themselves."""
    roots: int     # 1 or 2 ids the walk starts from: 0 .. roots - 1
    levels: int    # wide levels: D // 2
    nodes: int     # W = roots * (4^levels - 1) / 3


def wide_layout(num_leaves: int) -> WideLayout:
    depth = num_leaves.bit_length() - 1
    if num_leaves < 1 or 1 << depth != num_leaves:
        raise ValueError("the tree is complete: num_leaves is a power of two")
    roots, levels = 1 + depth % 2, depth // 2
    return WideLayout(roots, levels, roots * (4 ** levels - 1) // 3)


def _wide_nodes(levels_lo, levels_hi, levels_mask) -> torch.Tensor:
    """Pack ``refit_bvh``'s per-level boxes and masks (leaves first, root
    last) into the (max(W, 1), 32) records of ``BVH.wide``."""
    depth = len(levels_lo) - 1
    dev = levels_lo[0].device
    recs = []
    for k in range(depth // 2):
        i = depth - (depth % 2 + 2 * k + 2)     # the children's level
        lo, hi = (x[i].reshape(-1, 4, 3).transpose(1, 2).reshape(-1, 12)
                  for x in (levels_lo, levels_hi))
        mask = levels_mask[i].reshape(-1, 4).to(lo.dtype)
        recs.append(torch.cat([lo, hi, mask, torch.zeros_like(mask)], dim=-1))
    if not recs:
        return torch.zeros((1, 32), device=dev)
    return torch.cat(recs).contiguous()


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10-bit per-axis quantized coords into 30-bit codes."""
    def expand(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v
    return (expand(x[:, 0]) << np.uint64(2)) | (expand(x[:, 1]) << np.uint64(1)) \
        | expand(x[:, 2])


def build_bvh_topology(p0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                       leaf_size: int = 4) -> BVHTopology:
    """Host build: Morton-sort triangle centroids, chunk into power-of-two
    leaves, precompute the preorder skip table."""
    f = p0.shape[0]
    centroid = p0 + (e1 + e2) / 3.0
    lo = centroid.min(axis=0)
    extent = np.maximum(centroid.max(axis=0) - lo, 1e-12)
    q = np.clip(((centroid - lo) / extent) * 1023.0, 0, 1023).astype(np.uint32)
    order = np.argsort(_morton3(q), kind="stable").astype(np.int32)

    num_leaves = _next_pow2(-(-f // leaf_size))
    perm = np.full(num_leaves * leaf_size, -1, np.int32)
    perm[:f] = order

    n = 2 * num_leaves
    skip = np.zeros(n, np.int32)
    for i in range(1, n):
        k = i
        while (k & 1) and k > 1:
            k >>= 1
        skip[i] = 0 if k <= 1 else k + 1
    return BVHTopology(perm=perm, skip=skip, num_leaves=num_leaves,
                       leaf_size=leaf_size, num_faces=f)


def refit_bvh(topo: BVHTopology, p0: torch.Tensor, e1: torch.Tensor,
              e2: torch.Tensor) -> BVH:
    """AABB refit: leaf AABBs from permuted triangles, internal levels by
    pairwise min/max up the complete tree, and the same boxes packed into
    4-wide nodes. All detached."""
    p0, e1, e2 = p0.detach(), e1.detach(), e2.detach()
    dev = p0.device
    inf = float("inf")
    perm = torch.as_tensor(topo.perm, device=dev)
    idx = torch.clamp(perm, min=0).long()
    valid = perm >= 0
    vcol = valid[:, None]
    # padded-slot degenerate tris: p0 at +inf never hits nor affects AABBs
    tp0 = torch.where(vcol, p0[idx], inf)
    te1 = torch.where(vcol, e1[idx], 0.0)
    te2 = torch.where(vcol, e2[idx], 0.0)

    P, L = topo.num_leaves, topo.leaf_size
    v1 = torch.where(vcol, tp0 + te1, inf)
    v2 = torch.where(vcol, tp0 + te2, inf)
    tri_lo = torch.minimum(torch.minimum(tp0, v1), v2)
    tri_hi = torch.where(vcol, torch.maximum(torch.maximum(tp0, v1), v2), -inf)
    levels_lo = [tri_lo.reshape(P, L, 3).amin(dim=1)]
    levels_hi = [tri_hi.reshape(P, L, 3).amax(dim=1)]
    levels_mask = [valid.reshape(P, L).any(dim=1)]
    while levels_lo[-1].shape[0] > 1:
        levels_lo.append(levels_lo[-1].reshape(-1, 2, 3).amin(dim=1))
        levels_hi.append(levels_hi[-1].reshape(-1, 2, 3).amax(dim=1))
        levels_mask.append(levels_mask[-1].reshape(-1, 2).any(dim=1))
    # heap order: nodes[1] = root ... nodes[P:2P] = leaves; index 0 unused
    node_lo = torch.cat([torch.full((1, 3), inf, device=dev)]
                        + levels_lo[::-1])
    node_hi = torch.cat([torch.full((1, 3), -inf, device=dev)]
                        + levels_hi[::-1])
    node_mask = torch.cat([torch.zeros((1,), dtype=torch.bool, device=dev)]
                          + levels_mask[::-1])

    comps = [t[:, c] for t in (tp0, te1, te2) for c in range(3)]
    leaf_tris = torch.cat([c.reshape(P, L) for c in comps], dim=-1)
    return BVH(nodes=torch.cat([node_lo, node_hi], dim=-1).contiguous(),
               node_mask=node_mask, leaf_tris=leaf_tris.contiguous(),
               tri_valid=valid.reshape(P, L), perm=perm,
               skip=torch.as_tensor(topo.skip, device=dev),
               wide=_wide_nodes(levels_lo, levels_hi, levels_mask))


def _k3_blocking(bvh: BVH, ray_block: int, tri_block: int):
    """K3's (ray_block, tri_block) for the JAX package's. There a ray
    block is a (R, T) vector tile and a triangle block a (16, T) row in
    VMEM; in K3 a ray block is one CTA of threads, at most 1024, and a
    triangle block 10 x T floats staged in shared memory. Each maps to a
    quarter of the TPU's: the JAX defaults (2048, 512) give K3's own
    (512, 128). The ray block is a multiple of 32 in [32, 1024]; the
    triangle block a power-of-two count of leaves, at least one."""
    rb = min(1024, max(32, (ray_block // 4) // 32 * 32))
    leaves = max(1, (tri_block // 4) // bvh.leaf_size)
    leaves = min(1 << (leaves.bit_length() - 1), bvh.num_leaves)
    return rb, leaves * bvh.leaf_size


def ray_intersect_culled(bvh: BVH, ray_o: torch.Tensor, ray_d: torch.Tensor,
                         active: torch.Tensor | None = None,
                         tmax: torch.Tensor | None = None,
                         ray_block: int = 2048,
                         tri_block: int = 512):
    """Block-culled closest hit with t in (RayEpsilon, tmax): ray blocks
    slab-tested against the AABBs of leaf blocks, then a dense sweep of
    the blocks a ray enters, in ascending order. Returns a ``HitRecord``
    with global triangle ids; ties go to the lowest padded slot. CUDA rays
    launch K3 (``accel/intersect.py`` ``ray_intersect_k3``) at the blocking
    ``_k3_blocking`` maps ``ray_block`` and ``tri_block`` to; CPU rays take
    its plain version ``k1_plain``, whose result no blocking changes."""
    from . import intersect
    rb, tb = _k3_blocking(bvh, ray_block, tri_block)
    return intersect.ray_intersect_k3(bvh, ray_o, ray_d, active, tmax,
                                      ray_block=rb, tri_block=tb)


def ray_intersect_bvh(bvh: BVH, ray_o: torch.Tensor, ray_d: torch.Tensor,
                      active: torch.Tensor | None = None,
                      tmax: torch.Tensor | None = None,
                      ray_block: int = 8192):
    """Closest hit by a walk of the tree, with t in (RayEpsilon, tmax);
    returns a ``HitRecord`` with global triangle ids. CUDA rays launch K1
    (``accel/intersect.py`` ``k1_cuda``: a thread a ray, nearest child
    first); CPU rays take the same walk in lockstep tensor code,
    ``k1_walk_plain``. ``ray_block``, the TPU's lockstep block, has no
    counterpart: every ray walks on its own."""
    from . import intersect
    args = (bvh, *intersect._rays(ray_o, ray_d, active, tmax))
    if intersect._device_of(ray_o, "ray_intersect_bvh") == "cuda":
        return intersect.k1_cuda(*args)
    return intersect.k1_walk_plain(*args)
