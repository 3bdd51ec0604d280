"""The port's BVH refit and intersection kernels against the JAX package:
refit exactly equal on one topology; the plain versions that CPU tensors
take (K1's and K3's ``k1_plain``, K2's ``brute_plain``) against the Pallas
kernels they replace in interpret mode (ray_intersect_pallas_culled2,
ray_intersect_pallas, ray_intersect_pallas_culled) and against brute
force, with active and tmax. Tolerances as tests/test_bvh.py:43-50: valid
exactly equal, tri_id equal except at t-ties (rtol 1e-5), t allclose
(rtol 1e-5) — XLA fuses the Moller-Trumbore arithmetic and rounds a few
ulps apart from unfused tensor code."""
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

