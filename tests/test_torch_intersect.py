"""The port's BVH refit and intersection kernels against the JAX package:
refit exactly equal on one topology; the plain versions that CPU tensors
take (K1's and K3's ``k1_plain``, K2's ``brute_plain``) against the Pallas
kernels they replace in interpret mode (ray_intersect_pallas_culled2,
ray_intersect_pallas, ray_intersect_pallas_culled) and against brute
force, with active and tmax. Tolerances as tests/test_bvh.py:43-50: valid
exactly equal, tri_id equal except at t-ties (rtol 1e-5), t allclose
(rtol 1e-5) — XLA fuses the Moller-Trumbore arithmetic and rounds a few
ulps apart from unfused tensor code. Then the CUDA kernel's own walk, which
no CPU can run, through its mirror in tensor code: the 4-wide nodes of the
refit against the binary nodes they stand for, and ``k1_walk_plain``
(visit order, cull margin and tie rule of ``csrc/intersect.cu``) against
``k1_plain`` bit for bit."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from psdr_tpu.accel.bruteforce import ray_intersect_brute as j_brute
from psdr_tpu.accel.bvh import build_bvh_topology as j_topology
from psdr_tpu.accel.bvh import refit_bvh as j_refit
from psdr_tpu.accel.pallas_kernel import (ray_intersect_pallas,
                                          ray_intersect_pallas_culled,
                                          ray_intersect_pallas_culled2)
from psdr_tpu_torch.accel import bvh as t_bvh
from psdr_tpu_torch.accel import intersect
from psdr_tpu_torch.scene.scene import detach_flat
from psdr_tpu_torch.testing import scenes as t_scenes
from psdr_tpu_torch.testing.scenes import triangle_soup as _soup

from scenes import cbox_scene

torch.set_num_threads(2)


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _port_bvh(p0, e1, e2, leaf_size=4):
    topo = t_bvh.build_bvh_topology(p0, e1, e2, leaf_size=leaf_size)
    return topo, t_bvh.refit_bvh(topo, *_t(p0, e1, e2))


def _assert_hits_match(ref, hit, any_hit=False):
    np.testing.assert_array_equal(np.asarray(ref.valid), hit.valid.numpy())
    if any_hit:
        return
    same = np.asarray(ref.tri_id) == hit.tri_id.numpy()
    tie = np.isclose(np.asarray(ref.t), hit.t.numpy(), rtol=1e-5)
    assert np.all(same | tie)
    v = np.asarray(ref.valid)
    np.testing.assert_allclose(np.asarray(ref.t)[v], hit.t.numpy()[v],
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(ref.uv)[v & same],
                               hit.uv.numpy()[v & same], rtol=1e-4,
                               atol=1e-5)


def _cbox_tris():
    sc = cbox_scene(width=16, height=16, spp=1, occluder_subdiv=3)
    tri = sc.build(sc.params()).tri
    return tuple(np.asarray(x) for x in (tri.p0, tri.e1, tri.e2))


@pytest.mark.parametrize("geometry", ["soup", "cbox"])
def test_refit_matches_jax(geometry):
    p0, e1, e2 = _soup()[:3] if geometry == "soup" else _cbox_tris()
    jt = j_topology(p0, e1, e2, leaf_size=4)
    tt = t_bvh.build_bvh_topology(p0, e1, e2, leaf_size=4)
    np.testing.assert_array_equal(jt.perm, tt.perm)
    np.testing.assert_array_equal(jt.skip, tt.skip)
    jb = j_refit(jt, *_j(p0, e1, e2))
    tb = t_bvh.refit_bvh(t_bvh.BVHTopology(*jt), *_t(p0, e1, e2))
    for field in ("nodes", "node_mask", "leaf_tris", "tri_valid", "perm",
                  "skip"):
        np.testing.assert_array_equal(np.asarray(getattr(jb, field)),
                                      getattr(tb, field).numpy(), field)


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_k1_matches_jax_kernel(any_hit):
    p0, e1, e2, o, d, act, tmax = _soup()
    jb = j_refit(j_topology(p0, e1, e2, leaf_size=4), *_j(p0, e1, e2))
    ref = ray_intersect_pallas_culled2(jb, *_j(o, d, act), tmax=jnp.asarray(tmax),
                                       any_hit=any_hit, interpret=True)
    _, tb = _port_bvh(p0, e1, e2)
    hit = intersect.ray_intersect_k1(tb, *_t(o, d, act, tmax), any_hit=any_hit)
    _assert_hits_match(ref, hit, any_hit)
    assert not hit.valid.numpy()[~act].any()


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_k1_matches_brute(any_hit):
    p0, e1, e2, o, d, act, tmax = _soup()
    ref = j_brute(*_j(p0, e1, e2, o, d, act), tmax=jnp.asarray(tmax))
    _, tb = _port_bvh(p0, e1, e2)
    hit = intersect.ray_intersect_k1(tb, *_t(o, d, act, tmax), any_hit=any_hit)
    _assert_hits_match(ref, hit, any_hit)
    # the port's own brute force agrees with the port's plain K1 exactly
    tbr = intersect.ray_intersect_brute(*_t(p0, e1, e2, o, d, act, tmax))
    for f in ("valid", "tri_id", "t", "uv"):
        np.testing.assert_array_equal(getattr(tbr, f).numpy(),
                                      getattr(hit, f).numpy(), f)


@pytest.mark.parametrize("n_tris", [2, 24, 700])
def test_brute_matches_jax(n_tris):
    """Both brute-force paths: the unrolled one for tiny face sets (the
    emitter-first query) and the chunked one."""
    p0, e1, e2, o, d, act, tmax = _soup(n_tris=n_tris)
    ref = j_brute(*_j(p0, e1, e2, o, d, act), tmax=jnp.asarray(tmax))
    hit = intersect.ray_intersect_brute(*_t(p0, e1, e2, o, d, act, tmax))
    _assert_hits_match(ref, hit)


def test_k2_plain_matches_jax_kernel():
    """K2's plain version against ray_intersect_pallas (interpret) on the
    700-triangle soup of tests/test_bvh.py:152-166, with active and tmax."""
    p0, e1, e2, o, d, act, tmax = _soup(n_tris=700)
    ref = ray_intersect_pallas(*_j(p0, e1, e2, o, d, act),
                               tmax=jnp.asarray(tmax), interpret=True)
    hit = intersect.ray_intersect_brute(*_t(p0, e1, e2, o, d, act, tmax))
    _assert_hits_match(ref, hit)
    assert not hit.valid.numpy()[~act].any()


def test_k3_entry_matches_jax_kernel():
    """K3's entry point on CPU tensors (its plain version) against
    ray_intersect_pallas_culled (interpret) on the 2048-triangle soup of
    tests/test_bvh.py:169-183, at K3's blocking (R 512, T 128)."""
    p0, e1, e2, o, d, act, tmax = _soup()
    jb = j_refit(j_topology(p0, e1, e2, leaf_size=4), *_j(p0, e1, e2))
    ref = ray_intersect_pallas_culled(jb, *_j(o, d, act),
                                      tmax=jnp.asarray(tmax), interpret=True)
    _, tb = _port_bvh(p0, e1, e2)
    hit = intersect.ray_intersect_k3(tb, *_t(o, d, act, tmax))
    _assert_hits_match(ref, hit)
    assert not hit.valid.numpy()[~act].any()


def test_plain_k1_batching_does_not_change_results(monkeypatch):
    """Small ray blocks, tri blocks and temporary caps split the cull and
    the pair sweep into many batches; the lowest (t, slot) key per lane
    must not depend on how the pairs were batched."""
    p0, e1, e2, o, d, act, tmax = _soup()
    _, tb = _port_bvh(p0, e1, e2)
    args = (tb, *_t(o, d, act, tmax))
    full = intersect.k1_plain(*args)
    for name, value in (("RAY_BLOCK", 64), ("TRI_BLOCK", 64),
                        ("CULL_ELEMS", 1 << 12), ("PAIR_ELEMS", 1 << 13)):
        monkeypatch.setattr(intersect, name, value)
    split = intersect.k1_plain(*args)
    for f in ("valid", "tri_id", "t", "uv"):
        np.testing.assert_array_equal(getattr(full, f).numpy(),
                                      getattr(split, f).numpy(), f)



def _cbox_port(subdiv=3):
    sc = t_scenes.cbox_scene(16, 16, spp=4, occluder_subdiv=subdiv,
                             device="cpu")
    sc.prepare_accel()
    return sc, detach_flat(sc.build(sc.params()))


def _wide_bvh(tree):
    if tree == "cbox":
        return _cbox_port()[1].accel
    n_tris = {"soup": 2048, "even": 1000, "four": 13, "two": 7, "one": 3}
    return _port_bvh(*_soup(n_tris=n_tris[tree])[:3])[1]


@pytest.mark.parametrize("tree,log2_leaves", [
    ("soup", 9), ("cbox", 9), ("even", 8), ("four", 2), ("two", 1),
    ("one", 0)])
def test_wide_nodes_hold_the_binary_nodes(tree, log2_leaves):
    """Child c of wide node w is the binary node 4b + c, where b is the
    binary node w stands for: same box, same mask bit; the layout's ids
    (children of w at 4w + roots + c, leaves from W on) tile the tree."""
    bvh = _wide_bvh(tree)
    P = bvh.num_leaves
    assert P == 1 << log2_leaves
    roots, levels, W = t_bvh.wide_layout(P)
    assert roots == 1 + log2_leaves % 2 and levels == log2_leaves // 2
    assert bvh.wide.shape == (max(W, 1), 32)
    nodes, mask = bvh.nodes.numpy(), bvh.node_mask.numpy()
    wide = bvh.wide.numpy()
    off = 0
    for k in range(levels):
        n_k = roots * 4 ** k
        b = (1 << (log2_leaves % 2 + 2 * k)) + np.arange(n_k)
        child = 4 * b[:, None] + np.arange(4)              # binary ids
        rec = wide[off:off + n_k]
        np.testing.assert_array_equal(
            rec[:, 0:12].reshape(n_k, 3, 4).transpose(0, 2, 1),
            nodes[child, :3])
        np.testing.assert_array_equal(
            rec[:, 12:24].reshape(n_k, 3, 4).transpose(0, 2, 1),
            nodes[child, 3:])
        np.testing.assert_array_equal(rec[:, 24:28], mask[child])
        np.testing.assert_array_equal(rec[:, 28:], 0.0)
        # the ids of this level's children follow on from the level
        w = off + np.arange(n_k)
        np.testing.assert_array_equal(
            4 * w[:, None] + roots + np.arange(4),
            off + n_k + 4 * np.arange(n_k)[:, None] + np.arange(4))
        off += n_k
    assert off == W
    # the last level's children are the P leaves (P <= 2: the roots are)
    assert (roots * 4 ** levels) == P


# rays at a sine of 1e-4 .. 1e-2 to their triangle's plane from 20 .. 100
# away; near-parallel rays from nearby; far origins over tiny triangles
_GRAZING = {"grazing": dict(edge=0.05, dist=(20.0, 100.0), sine=(1e-4, 1e-2)),
            "grazing-near": dict(edge=0.3, dist=(2.0, 5.0), sine=(1e-5, 1e-3)),
            "far-origin": dict(edge=0.02, dist=(200.0, 1000.0),
                               sine=(1e-3, 1e-1))}


def _walk_case(rays):
    if rays == "soup" or rays in _GRAZING:
        p0, e1, e2, o, d, act, tmax = (
            _soup() if rays == "soup"
            else t_scenes.grazing_case(**_GRAZING[rays]))
        return (_port_bvh(p0, e1, e2)[1], *_t(o, d, act, tmax))
    sc, flat = _cbox_port()
    kind, sweep = rays.split("-")
    sweeps = (t_scenes.scene_rays(sc, flat, 1500, 4) if kind == "random"
              else t_scenes.tiled_camera_rays(sc, flat, 1024, 4, 4))
    ray, act, tmax = sweeps[("camera", "bounce", "shadow").index(sweep)]
    assert int(act.sum()) > 50
    return (flat.accel, *intersect._rays(ray.o, ray.d, act, tmax))


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("rays", [
    "soup", "random-camera", "random-bounce", "random-shadow",
    "tiled-camera", "tiled-bounce", "tiled-shadow", "grazing",
    "grazing-near", "far-origin"])
def test_walk_matches_plain_k1(rays, any_hit):
    """The kernel's walk, in lockstep tensor code, against k1_plain: the
    whole record bit for bit in closest-hit mode, ``valid`` in any-hit
    mode; on the soup's 600 rays (mixed active and tmax), on the cbox
    scene's camera, bounce and shadow rays, and on grazing rays and far
    origins over small triangles, where the triangle test's t is least
    sure of its last digits."""
    args = _walk_case(rays)
    plain = intersect.k1_plain(*args)
    walk = intersect.k1_walk_plain(*args, any_hit=any_hit)
    assert plain.valid.any()
    for f in ("valid",) if any_hit else ("valid", "tri_id", "t", "uv"):
        np.testing.assert_array_equal(getattr(plain, f).numpy(),
                                      getattr(walk, f).numpy(), f)


@pytest.mark.parametrize("case", [
    dict(edge=0.3, dist=(100.0, 500.0), sine=(1e-5, 1e-3)),
    dict(edge=0.3, dist=(1000.0, 5000.0), sine=(1e-6, 1e-4))])
def test_walk_differs_only_beyond_the_cull_margin(case):
    """Where the exactness ends: on rays that graze large triangles at a
    sine below 1e-3 from hundreds of edge lengths away, Moller-Trumbore's t
    is off by more than the cull margin for some hits, and the walk may
    then return another hit than k1_plain, which culls against tmax alone.
    Every such lane is one where k1_plain's winner has a computed t more
    than the margin below the distance at which the ray enters that
    triangle's leaf box; ``valid`` agrees on every lane."""
    arrs = t_scenes.grazing_case(**case)
    bvh = _port_bvh(*arrs[:3])[1]
    p0, e1, e2, o, d, act, tmax = _t(*arrs)
    plain = intersect.k1_plain(bvh, o, d, act, tmax)
    walk = intersect.k1_walk_plain(bvh, o, d, act, tmax)
    np.testing.assert_array_equal(plain.valid.numpy(), walk.valid.numpy())
    perm = bvh.perm.long()
    slot = torch.zeros(p0.shape[0], dtype=torch.int64)     # triangle -> slot
    slot[perm[perm >= 0]] = torch.arange(perm.shape[0])[perm >= 0]
    box = bvh.nodes[bvh.num_leaves + slot[plain.tri_id.long().clamp(min=0)]
                    // bvh.leaf_size]
    t0, t1 = (box[:, :3] - o) / d, (box[:, 3:] - o) / d
    enters = torch.minimum(t0, t1).amax(dim=-1)
    beyond = plain.valid & (enters > plain.t * intersect.CULL_MARGIN)
    differs = (plain.tri_id != walk.tri_id) | (plain.t != walk.t)
    assert beyond.sum() > 5 and differs.any(), "the case is too tame"
    assert not (differs & ~beyond).any()
    assert (walk.t[differs] >= plain.t[differs]).all()


@pytest.mark.parametrize("swap", [False, True])
def test_walk_ties_go_to_the_lowest_slot(swap):
    """Two coincident triangles in different leaves, rays from both sides:
    the walk meets the copy in the higher slot first from below, and the
    copy in the lower slot still wins, as in k1_plain; with ``swap`` that
    is the higher triangle id."""
    (topo, *arrs), winner = t_scenes.coincident_case(swap)
    p0, e1, e2, o, d, act, tmax = _t(*arrs)
    bvh = t_bvh.refit_bvh(topo, p0, e1, e2)
    slot = {int(i): s for s, i in enumerate(topo.perm)}
    assert slot[10] // 4 != slot[50] // 4 and slot[winner] == 10
    plain = intersect.k1_plain(bvh, o, d, act, tmax)
    walk = intersect.k1_walk_plain(bvh, o, d, act, tmax)
    for f in ("valid", "tri_id", "t", "uv"):
        np.testing.assert_array_equal(getattr(plain, f).numpy(),
                                      getattr(walk, f).numpy(), f)
    ids = walk.tri_id.numpy()
    above = np.arange(len(ids)) % 2 == 0
    assert (ids[above] == winner).sum() > 50
    assert (ids[~above] == winner).sum() > 50
    assert not (ids == 60 - winner).any()
