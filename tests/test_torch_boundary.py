"""The port's boundary terms (primary and secondary edges, compaction,
guiding) against the JAX package's: the same numpy inputs go through the
JAX function and its counterpart, module by module and for the slice as a
whole. The port runs on the CPU (``device="cpu"``), where the intersection
kernels take their plain versions.

Two things are carried across so that lanes can be compared one by one.
The edge tables: the port's ``build_edges`` is tested on its own, and the
meshes of a scene pair share the JAX meshes' table. The cumulative sums of
the edge distributions: XLA's scan and torch's running sum round apart in
the last place (about 1e-7 relative), and a sample that falls between the
two values picks a neighbouring edge; the lane-by-lane tests give the port
the JAX package's ``cmf`` (``convert.discrete_from_numpy``), the whole-slice
gradient tests do not and hold 1e-2 relative L2 and cosine 0.999 per leaf
(measured: below 1e-4 and 0.999999)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from psdr_tpu import DirectIntegrator as JDirect
from psdr_tpu.core import distribution as j_dist
from psdr_tpu.core import math as j_math
from psdr_tpu.integrator import direct as j_direct
from psdr_tpu.scene import scene as j_scene
from psdr_tpu.sensor import perspective as j_persp
from psdr_tpu.shape import mesh as j_mesh
from psdr_tpu.shape import primitives as j_prim
from psdr_tpu_torch import DirectIntegrator as TDirect
from psdr_tpu_torch.convert import (discrete_from_numpy, hypercube_from_numpy,
                                    params_from_numpy)
from psdr_tpu_torch.core import distribution as t_dist
from psdr_tpu_torch.core import math as t_math
from psdr_tpu_torch.core import threefry
from psdr_tpu_torch.core import transform as t_xf
from psdr_tpu_torch.integrator import direct as t_direct
from psdr_tpu_torch.scene import scene as t_scene
from psdr_tpu_torch.sensor import perspective as t_persp
from psdr_tpu_torch.shape import mesh as t_mesh
from psdr_tpu_torch.shape import primitives as t_prim
from psdr_tpu_torch.testing import scenes as t_scenes
from psdr_tpu_torch.testing.ranks import LocalRank

from scenes import cbox_scene as j_cbox
from scenes import sphere_light_scene as j_sphere

torch.set_num_threads(2)

CPU = dict(device="cpu")     # the port defaults to the card


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leaves(tree):
    """Leaves in jax.tree.leaves order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _pair(j_make, t_make, **kw):
    """The same scene in both packages, the port's meshes on the JAX
    meshes' edge tables."""
    js, ts = j_make(**kw), t_make(**kw, **CPU)
    for jm, tm in zip(js.meshes, ts.meshes):
        tm.edge_indices = jm.edge_indices
    return js, ts


def _flats(js, ts):
    """Both flat scenes at the JAX scene's parameters, the port's edge
    distributions on the JAX package's cmf."""
    jf = js.build(js.params())
    tf = ts.build(params_from_numpy(js.params(), **CPU))
    tf = tf._replace(sec_distrb=discrete_from_numpy(
        jf.sec_distrb.pmf, jf.sec_distrb.cmf, **CPU))
    sensors = []
    for j_st, t_st in zip(jf.sensors, tf.sensors):
        if t_st.edges is not None:
            t_st = t_st._replace(edges=t_st.edges._replace(
                distrb=discrete_from_numpy(j_st.edges.distrb.pmf,
                                           j_st.edges.distrb.cmf, **CPU)))
        sensors.append(t_st)
    return jf, tf._replace(sensors=tuple(sensors))


def _rows_sorted(e):
    return e[np.lexsort(e.T[::-1])]


# -- the edge table -------------------------------------------------------------

def _open_faces():
    return j_prim.make_icosphere(subdiv=2).faces[:50]


@pytest.mark.parametrize("faces", [
    lambda: j_prim.make_quad().faces,
    lambda: j_prim.make_icosphere(subdiv=3).faces,
    _open_faces], ids=["quad", "icosphere", "open"])
def test_build_edges_matches_jax_up_to_row_order(faces):
    f = faces()
    ours, ref = t_mesh.build_edges(f), j_mesh.build_edges(f)
    assert ours.dtype == np.int32 and ours.shape == ref.shape
    assert (ours[:, 0] < ours[:, 1]).all()
    from psdr_tpu import native
    if native.available():
        # the native C++ routine's table, up to row order (in fact row for row)
        np.testing.assert_array_equal(_rows_sorted(ours), _rows_sorted(ref))
    else:
        # the numpy grouping may name an edge's two faces the other way
        # round, and with them the opposite vertex
        def canon(e):
            both = e[:, 3] >= 0
            lo = np.where(both, np.minimum(e[:, 2], e[:, 3]), e[:, 2])
            hi = np.where(both, np.maximum(e[:, 2], e[:, 3]), e[:, 3])
            return _rows_sorted(np.stack([e[:, 0], e[:, 1], lo, hi], 1))
        np.testing.assert_array_equal(canon(ours), canon(ref))
    # face0 is an adjacent face, and the opposite vertex is its third one
    for v0, v1, f0, f1, opp in ours[:200]:
        assert sorted(f[f0]) == sorted([v0, v1, opp])
        assert f1 < 0 or {v0, v1} <= set(f[f1])


def test_mesh_carries_its_edge_table():
    assert t_prim.make_icosphere(subdiv=1).edge_indices.shape == (120, 5)
    assert t_prim.make_quad(enable_edges=False).edge_indices.shape == (0, 5)
    np.testing.assert_array_equal(
        t_prim.make_icosphere(subdiv=2).edge_indices,
        t_mesh.build_edges(j_prim.make_icosphere(subdiv=2).faces))


def test_mesh_uploads_its_edge_table_once():
    m = t_prim.make_icosphere(subdiv=1)
    table = m.edge_table("cpu")
    assert table.dtype == torch.int64 and m.edge_table("cpu") is table
    np.testing.assert_array_equal(table.numpy(), m.edge_indices)
    # a replaced table (as the parity tests carry one across) is taken up
    m.edge_indices = m.edge_indices[::-1].copy()
    np.testing.assert_array_equal(m.edge_table("cpu").numpy(), m.edge_indices)


@pytest.mark.parametrize("faces,match", [
    ([[0, 1, 2], [0, 1, 3], [0, 1, 4]], "more than 2 faces"),
    ([[0, 1, 0]], "Duplicated faces")])
def test_build_edges_rejects_non_manifold(faces, match):
    with pytest.raises(ValueError, match=match):
        t_mesh.build_edges(np.asarray(faces, np.int32))
    with pytest.raises(ValueError):
        j_mesh.build_edges(np.asarray(faces, np.int32))


# -- the edge tables of a built scene -------------------------------------------

def test_sec_edge_info_and_primary_edges_match_jax():
    """Every field of compute_sec_edge_info and of build_primary_edges +
    finalize_primary_edges as Scene.build stacks them, rtol 1e-6 (atol 1e-6
    for coordinates near 0), the primary edges' normal and pmf each row
    within the bound its end points' rounding gives; masks exact."""
    js, ts = _pair(j_sphere, t_scenes.sphere_light_scene, width=16, height=16,
                   spp=1, sppe=2, sppse=2, subdiv=2)
    jf = js.build(js.params())
    tf = ts.build(params_from_numpy(js.params(), **CPU))
    assert tf.sec_edge.p0.shape == (480, 3)
    for f in ("valid", "is_boundary"):
        np.testing.assert_array_equal(_np(getattr(tf.sec_edge, f)),
                                      _np(getattr(jf.sec_edge, f)))
    for f in ("p0", "e1", "n0", "n1", "p2"):
        np.testing.assert_allclose(_np(getattr(tf.sec_edge, f)),
                                   _np(getattr(jf.sec_edge, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    np.testing.assert_allclose(_np(tf.sec_distrb.pmf), _np(jf.sec_distrb.pmf),
                               rtol=1e-6)
    je, te = jf.sensors[0].edges, tf.sensors[0].edges
    np.testing.assert_array_equal(_np(te.valid), _np(je.valid))
    assert 0 < int(te.valid.sum()) < te.valid.numel()
    for f in ("p0", "p1", "edge_length"):
        np.testing.assert_allclose(_np(getattr(te, f)), _np(getattr(je, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    # edge_normal = (q1 - q0) / |q1 - q0| rotated, and the pmf is each
    # length over their sum: a rounding difference dq of the projected end
    # points moves both by up to 2 |dq| / length (absolute for the unit
    # normal, relative for the pmf), which on short edges exceeds 1e-6.
    # The 4x4 transform's last-place rounding differs between XLA builds
    # and machines, so hold each row to the bound its own inputs give.
    dq = sum(np.abs(_np(getattr(te, f)) - _np(getattr(je, f)))[:, :2]
             .max(axis=1) for f in ("p0", "p1"))
    cond = 2.0 * dq / _np(je.edge_length)
    jn = _np(je.edge_normal)
    err = np.abs(_np(te.edge_normal) - jn)
    bad = err > 1e-6 + 1e-6 * np.abs(jn) + cond[:, None]
    assert not bad.any(), (err.max(), np.argwhere(bad))
    jp = _np(je.distrb.pmf)
    err = np.abs(_np(te.distrb.pmf) - jp)
    bad = err > 1e-9 + (1e-6 + cond) * jp
    assert not bad.any(), (err.max(), np.argwhere(bad))
    np.testing.assert_allclose(float(te.distrb.total), float(je.distrb.total),
                               rtol=1e-6)


def test_scene_without_edges_gets_the_placeholder_row():
    """No mesh with edges (or no boundary samples asked for): one invalid
    secondary-edge row, no primary-edge table, and detach_flat covers the
    tables that are there."""
    ts = t_scenes.floor_light_scene(8, 8, 1, **CPU)
    ts.opts = dataclasses.replace(ts.opts, sppe=1, sppse=1)
    flat = ts.build(ts.params())
    assert flat.sec_edge.p0.shape == (1, 3) and not bool(flat.sec_edge.valid)
    assert flat.sensors[0].edges is None
    ts = t_scenes.sphere_light_scene(8, 8, 1, sppe=0, sppse=0, **CPU)
    assert ts.build(ts.params()).sec_edge.p0.shape == (1, 3)
    ts = t_scenes.sphere_light_scene(8, 8, 1, sppe=1, sppse=1, **CPU)
    p = params_from_numpy(ts.params(), **CPU, requires_grad=True)
    flat = ts.build(p)
    assert flat.sec_edge.p0.requires_grad
    assert flat.sensors[0].edges.p0.requires_grad
    det = t_scene.detach_flat(flat)
    assert not det.sec_edge.p0.requires_grad
    assert not det.sensors[0].edges.p0.requires_grad and det.detached


# -- distributions --------------------------------------------------------------

@pytest.mark.parametrize("n", [33, 1920, 5000, 30720, 300000])
def test_discrete_sample_reuse_above_32_entries_matches_jax(n):
    """torch.searchsorted against the JAX package's blocked search (two
    levels up to 262,144 entries, three above), a third of the entries
    empty. On the JAX package's cmf: idx, pdf and the remapped sample equal
    bit for bit. On the port's own cumulative sum, which differs from
    XLA's in the last place on about half the entries (up to 2.3e-7 of the
    total): idx equal on every lane whose sample lies more than 4 ulp of
    the total from a cmf entry; the rest (0.8% of lanes at 300,000 entries,
    0.1% at 30,720, under 0.01% at 1,920) land on a neighbouring non-empty
    entry."""
    rng = np.random.default_rng(n)
    pmf = rng.uniform(0, 1, n).astype(np.float32)
    pmf[rng.uniform(size=n) < 0.3] = 0.0
    u = rng.uniform(size=50000).astype(np.float32)
    d_j = j_dist.discrete_init(jnp.asarray(pmf))
    ij, pj, rj = (np.asarray(x) for x in
                  j_dist.discrete_sample_reuse(d_j, jnp.asarray(u)))
    d_t = discrete_from_numpy(pmf, np.asarray(d_j.cmf), **CPU)
    it, pt, rt = (_np(x) for x in
                  t_dist.discrete_sample_reuse(d_t, torch.from_numpy(u)))
    assert it.dtype == np.int32
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(rt, rj)

    d_own = t_dist.discrete_init(torch.from_numpy(pmf))
    cj, ct = np.asarray(d_j.cmf), _np(d_own.cmf)
    assert np.abs(cj - ct).max() <= 4e-7 * cj[-1]
    io, _, _ = (_np(x) for x in
                t_dist.discrete_sample_reuse(d_own, torch.from_numpy(u)))
    s = u.astype(np.float64) * float(cj[-1])
    k = np.clip(np.searchsorted(cj, s), 1, n - 1)
    gap = np.minimum(np.abs(cj[k] - s), np.abs(cj[k - 1] - s))
    far = gap > 4 * np.spacing(cj[-1])
    np.testing.assert_array_equal(io[far], ij[far])
    assert (io != ij).mean() <= 0.01
    # torch's running sum repeats cmf[i - 1] exactly over an empty entry,
    # so the port's own table never selects one (XLA's scan may step by an
    # ulp there, and the JAX package then does, with pdf 0)
    assert (pmf[io] > 0).all()


def test_hypercube_matches_jax():
    """cells exact; warped samples and pdf rtol 1e-6 under the same mass
    (carried across with its cmf); hypercube_pdf at the warped points; the
    all-zero mass guard degrades to the uniform distribution."""
    reso = (6, 3, 4)
    rng = np.random.default_rng(2)
    mass = rng.uniform(0, 1, 72).astype(np.float32)
    mass[rng.uniform(size=72) < 0.4] = 0.0
    u = rng.uniform(size=(4000, 3)).astype(np.float32)
    hj = j_dist.hypercube_set_mass(j_dist.hypercube_init(reso),
                                   jnp.asarray(mass))
    ht = hypercube_from_numpy(reso, hj.distrb.pmf, hj.distrb.cmf, **CPU)
    np.testing.assert_array_equal(_np(ht.cells), np.asarray(hj.cells))
    np.testing.assert_array_equal(_np(t_dist.hypercube_cells(reso, **CPU)),
                                  np.asarray(j_dist.hypercube_cells(reso)))
    assert ht.num_cells == hj.num_cells == 72 and ht.ndim == hj.ndim == 3
    np.testing.assert_allclose(_np(ht.unit), np.asarray(hj.unit), rtol=1e-7)
    wj, pj = j_dist.hypercube_sample_reuse(hj, jnp.asarray(u))
    wt, pt = t_dist.hypercube_sample_reuse(ht, torch.from_numpy(u))
    np.testing.assert_allclose(_np(wt), np.asarray(wj), rtol=1e-6)
    np.testing.assert_allclose(_np(pt), np.asarray(pj), rtol=1e-6)
    np.testing.assert_allclose(
        _np(t_dist.hypercube_pdf(ht, wt)),
        np.asarray(j_dist.hypercube_pdf(hj, wj)), rtol=1e-6)
    outside = torch.tensor([[1.5, 0.5, 0.5], [-0.1, 0.2, 0.2]])
    assert _np(t_dist.hypercube_pdf(ht, outside)).tolist() == [0.0, 0.0]
    # set_mass through the port's own cumulative sum: the same table
    own = t_dist.hypercube_set_mass(t_dist.hypercube_init(reso, **CPU),
                                    torch.from_numpy(mass))
    np.testing.assert_array_equal(_np(own.distrb.pmf),
                                  np.asarray(hj.distrb.pmf))
    np.testing.assert_allclose(_np(own.distrb.cmf), np.asarray(hj.distrb.cmf),
                               rtol=1e-6)
    # all-zero mass: uniform
    zero_t = t_dist.hypercube_set_mass(own, torch.zeros(72))
    zero_j = j_dist.hypercube_set_mass(hj, jnp.zeros(72))
    np.testing.assert_array_equal(_np(zero_t.distrb.pmf),
                                  np.asarray(zero_j.distrb.pmf))
    _, pz = t_dist.hypercube_sample_reuse(zero_t, torch.from_numpy(u))
    np.testing.assert_allclose(_np(pz), 1.0, rtol=1e-6)
    with pytest.raises(ValueError):
        t_dist.hypercube_init(reso, torch.ones(5))


# -- small math -----------------------------------------------------------------

def test_sign_eps_matches_jax():
    x = np.array([-1.0, -1e-5, -9e-6, 0.0, 9e-6, 1e-5, 2e-5, 3.0], np.float32)
    got = t_math.sign_eps(torch.from_numpy(x), 1e-5)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got),
                                  np.asarray(j_math.sign_eps(x, 1e-5)))


def test_bilinear_and_triangle_gradients_match_jax():
    """The tail of eval_secondary_edge: u2 = bilinear(stopped triangle,
    uv(ray_intersect_triangle(triangle, p, normalize(p0 - p)))), its value
    and its gradients in the triangle, p and p0, at (N, 3) lanes; rtol
    1e-4 (atol 1e-5: gradients that cancel to 0)."""
    rng = np.random.default_rng(4)
    n = 257
    v0, e1, e2 = (rng.normal(size=(n, 3)).astype(np.float32) for _ in range(3))
    p = rng.normal(size=(n, 3)).astype(np.float32) + 3.0
    p0 = (v0 + 0.3 * e1 + 0.3 * e2
          + 0.1 * rng.normal(size=(n, 3))).astype(np.float32)
    w = rng.normal(size=(n, 3)).astype(np.float32)

    def j_f(v0, e1, e2, p, p0):
        uv, _ = j_math.ray_intersect_triangle(v0, e1, e2, p,
                                              j_math.normalize(p0 - p))
        sg = jax.lax.stop_gradient
        return jnp.sum(j_math.bilinear(sg(v0), sg(e1), sg(e2), uv) * w)

    j_val, j_grads = jax.value_and_grad(j_f, argnums=(0, 1, 2, 3, 4))(
        v0, e1, e2, p, p0)
    args = [torch.tensor(a, requires_grad=True) for a in (v0, e1, e2, p, p0)]
    tv0, te1, te2, tp, tp0 = args
    uv, _ = t_math.ray_intersect_triangle(tv0, te1, te2, tp,
                                          t_math.normalize(tp0 - tp))
    val = torch.sum(t_math.bilinear(tv0.detach(), te1.detach(), te2.detach(),
                                    uv) * torch.from_numpy(w))
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(j_val), rtol=1e-4)
    for a, g in zip(args, j_grads):
        assert torch.isfinite(a.grad).all()
        scale = np.abs(np.asarray(g)).max()
        np.testing.assert_allclose(_np(a.grad), np.asarray(g), rtol=1e-3,
                                   atol=1e-5 * scale)


# -- the samplers, lane by lane -------------------------------------------------

def _assert_lanes(got, want, valid, rtol=1e-5, name=""):
    got, want = _np(got), np.asarray(want)
    scale = max(float(np.abs(want[valid]).max()), 1e-30)
    np.testing.assert_allclose(got[valid], want[valid], rtol=rtol,
                               atol=rtol * scale, err_msg=name)


def test_sample_primary_edge_and_sample_direct_match_jax():
    js, ts = _pair(j_sphere, t_scenes.sphere_light_scene, width=16, height=16,
                   spp=1, sppe=2, sppse=0, subdiv=2)
    jf, tf = _flats(js, ts)
    rng = np.random.default_rng(6)
    u = np.sort(rng.uniform(size=3000).astype(np.float32))
    pj = j_persp.sample_primary_edge(jf.sensors[0], jnp.asarray(u))
    pt = t_persp.sample_primary_edge(tf.sensors[0], torch.from_numpy(u))
    np.testing.assert_array_equal(_np(pt.idx), np.asarray(pj.idx))
    ok = np.asarray(pj.idx) >= 0
    assert ok.sum() > 2000
    for f in ("x_dot_n", "pdf", "vis_dist"):
        _assert_lanes(getattr(pt, f), getattr(pj, f), ok, name=f)
    for f in ("ray_p", "ray_n", "ray_c"):
        _assert_lanes(getattr(pt, f).o, getattr(pj, f).o, ok, name=f)
        _assert_lanes(getattr(pt, f).d, getattr(pj, f).d, ok, name=f)

    p = rng.uniform(-2.0, 2.0, size=(3000, 3)).astype(np.float32)
    sj = j_persp.sample_direct(jf.sensors[0], jnp.asarray(p))
    st = t_persp.sample_direct(tf.sensors[0], torch.from_numpy(p))
    np.testing.assert_array_equal(_np(st.valid), np.asarray(sj.valid))
    np.testing.assert_array_equal(_np(st.pixel_idx), np.asarray(sj.pixel_idx))
    ok = np.asarray(sj.valid)
    assert 100 < ok.sum() < 3000
    _assert_lanes(st.q, sj.q, ok, name="q")
    _assert_lanes(st.sensor_val, sj.sensor_val, ok, name="sensor_val")


def test_only_x_dot_n_carries_a_gradient():
    """sample_primary_edge: every output but x_dot_n is detached, as in the
    JAX package (stop_gradient in the same places)."""
    ts = t_scenes.sphere_light_scene(16, 16, 1, sppe=2, subdiv=1, **CPU)
    flat = ts.build(params_from_numpy(ts.params(), **CPU, requires_grad=True))
    pes = t_persp.sample_primary_edge(flat.sensors[0], torch.rand(64))
    assert pes.x_dot_n.requires_grad
    for x in (pes.pdf, pes.vis_dist, pes.ray_p.o, pes.ray_p.d, pes.ray_n.o,
              pes.ray_n.d, pes.ray_c.o, pes.ray_c.d):
        assert not x.requires_grad


def _cbox_pair(**kw):
    return _pair(j_cbox, t_scenes.cbox_scene, **kw)


def test_sample_boundary_segment_direct_matches_jax():
    js, ts = _cbox_pair(width=16, height=16, spp=1, sppse=2,
                        occluder_subdiv=3)
    jf, tf = _flats(js, ts)
    rng = np.random.default_rng(8)
    u = rng.uniform(size=(6000, 3)).astype(np.float32)
    u = u[np.argsort(u[:, 0], kind="stable")]
    act = rng.uniform(size=6000) > 0.05
    bj = j_scene.sample_boundary_segment_direct(
        jf, js.face_offset, j_direct._emitter_meta(js), jnp.asarray(u),
        jnp.asarray(act))
    bt = t_scene.sample_boundary_segment_direct(
        tf, ts.face_offset, t_direct._emitter_meta(ts), torch.from_numpy(u),
        torch.from_numpy(act))
    np.testing.assert_array_equal(_np(bt.valid), np.asarray(bj.valid))
    ok = np.asarray(bj.valid)
    assert 50 < ok.sum() < 3000
    everywhere = np.ones_like(ok)
    for f in ("p0", "edge", "edge2", "p2", "n"):
        _assert_lanes(getattr(bt, f), getattr(bj, f), everywhere, name=f)
    _assert_lanes(bt.pdf, bj.pdf, ok, name="pdf")
    assert (_np(bt.pdf)[~ok] == 0).all()


# -- compaction -------------------------------------------------------------------

@pytest.mark.parametrize("m,env,guided,want", [
    (1 << 16, {}, False, (1 << 15, 1 << 11)),
    (1 << 16, {}, True, (1 << 15, 1 << 13)),
    (4096, {}, False, (4096, 1024)),
    (1000, {}, False, None),                 # ks = 250 < 256
    (1 << 15, {"PSDR_TPU_SSE_COMPACT": "0"}, False, None),
    (1 << 15, {"PSDR_TPU_SSE_COMPACT_SHIFT": "3"}, False, (1 << 15, 1 << 12)),
    ((1 << 15) + 8, {}, False, None)])       # does not factor
def test_compact_eligibility_matches_jax(m, env, guided, want, monkeypatch):
    for k in ("PSDR_TPU_SSE_COMPACT", "PSDR_TPU_SSE_COMPACT_SHIFT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert t_direct._compact_eligibility(m, guided) == want
    assert j_direct._compact_eligibility(m, guided) == want


def test_compact_boundary_lanes_matches_jax_exactly():
    """Indices, weights and liveness on a seeded mask over four segments:
    one overflowing (more valid lanes than ks), one empty, and edge
    coordinates and keys with ties (the stable sorts)."""
    s, ks, segs = 2048, 512, 4
    rng = np.random.default_rng(12)
    frac = np.repeat([0.03, 0.6, 0.0, 0.2], s)
    valid = rng.uniform(size=s * segs) < frac
    edge = np.sort(rng.integers(0, 300, s * segs) / 300.0).astype(np.float32)
    u = (rng.integers(0, 1000, s * segs) / 1000.0).astype(np.float32)
    ij, wj, lj = j_direct._compact_boundary_lanes(
        jnp.asarray(valid), jnp.asarray(edge), jnp.asarray(u), s, ks)
    it, wt, lt = t_direct._compact_boundary_lanes(
        torch.from_numpy(valid), torch.from_numpy(edge), torch.from_numpy(u),
        s, ks)
    np.testing.assert_array_equal(_np(it), np.asarray(ij))
    np.testing.assert_array_equal(_np(wt), np.asarray(wj))
    np.testing.assert_array_equal(_np(lt), np.asarray(lj))
    counts = valid.reshape(segs, s).sum(1)
    assert counts[1] > ks and _np(wt)[ks] == counts[1] / ks > 1.0
    assert _np(wt)[0] == 1.0 and not _np(lt)[2 * ks:3 * ks].any()
    assert _np(lt).sum() == np.minimum(counts, ks).sum()


# -- the secondary-edge estimator, lane by lane -----------------------------------

def test_eval_secondary_edge_matches_jax_lane_by_lane():
    """eval_secondary_edge(ad=False) on 8,192 edge-sorted samples: rtol 1e-4
    on the lanes both packages call valid (value > 0), and at most 0.1% of
    lanes valid in one package only."""
    js, ts = _cbox_pair(width=32, height=32, spp=1, sppse=2,
                        occluder_subdiv=3)
    jf, tf = _flats(js, ts)
    rng = np.random.default_rng(9)
    u = rng.uniform(size=(8192, 3)).astype(np.float32)
    u = u[np.argsort(u[:, 0], kind="stable")]
    _, vj = jax.jit(lambda x: JDirect(1, 1).eval_secondary_edge(
        js, j_scene.detach_flat(jf), 0, x, ad=False))(jnp.asarray(u))
    with torch.no_grad():
        pix, vt = TDirect(1, 1).eval_secondary_edge(
            ts, t_scene.detach_flat(tf), 0, torch.from_numpy(u), ad=False)
    vj, vt = np.asarray(vj), _np(vt)
    assert (_np(pix) == -1).all() and np.isfinite(vt).all()
    lj, lt = vj.max(-1) > 0, vt.max(-1) > 0
    assert 50 < lj.sum() < 2000
    assert (lj != lt).mean() <= 1e-3
    both = lj & lt
    np.testing.assert_allclose(vt[both], vj[both], rtol=1e-4)


# -- the slice as a whole -----------------------------------------------------------

def _jax_grad(js, seed, integ=None):
    render = (integ or JDirect(1, 1)).render_fn(js, with_boundary=True)
    value, grad = jax.jit(jax.value_and_grad(
        lambda p: jnp.mean(render(p, jax.random.PRNGKey(seed)))))(js.params())
    return float(value), [np.asarray(g).ravel() for g in jax.tree.leaves(grad)]


def _port_grad(ts, params_np, seed, integ=None):
    p = params_from_numpy(params_np, **CPU, requires_grad=True)
    img = (integ or TDirect(1, 1)).render_fn(ts, with_boundary=True)(
        p, threefry.PRNGKey(seed))
    loss = torch.mean(img)
    loss.backward()
    return float(loss), img.detach(), [
        np.zeros(x.numel(), np.float32) if x.grad is None
        else x.grad.numpy().ravel() for x in _leaves(p)]


def _assert_grads_match(ref, port, rel_l2=1e-2, min_cos=0.999):
    """Per leaf: finite, relative L2 error and cosine. Returns the worst
    relative L2 error over the leaves."""
    assert len(ref) == len(port)
    worst = 0.0
    for i, (a, g) in enumerate(zip(ref, port)):
        assert np.isfinite(g).all(), f"leaf {i} not finite"
        na = np.linalg.norm(a)
        err = np.linalg.norm(g - a)
        assert err <= rel_l2 * na, (i, err, na)
        if na > 0:
            worst = max(worst, err / na)
            assert float(g @ a) / (np.linalg.norm(g) * na) >= min_cos, i
    return worst


SLICE_CASES = {
    # measured worst leaf, relative L2: 4.7e-7, 1.9e-5, 9.7e-5, 2.8e-5
    "primary": (j_sphere, t_scenes.sphere_light_scene,
                dict(width=16, height=16, spp=0, sppe=2, sppse=0, subdiv=1)),
    "secondary_full_width": (j_cbox, t_scenes.cbox_scene,
                             dict(width=12, height=12, spp=0, sppse=4,
                                  occluder_subdiv=2)),
    "secondary_compacted": (j_cbox, t_scenes.cbox_scene,
                            dict(width=64, height=64, spp=0, sppse=4,
                                 occluder_subdiv=3)),
    "all_terms": (j_cbox, t_scenes.cbox_scene,
                  dict(width=32, height=32, spp=2, sppe=2, sppse=4,
                       occluder_subdiv=3)),
}


@pytest.mark.parametrize("case", list(SLICE_CASES))
def test_boundary_value_and_grad_matches_jax(case, monkeypatch):
    """value_and_grad of mean(img) through render_fn(with_boundary=True)
    per params leaf against jax.value_and_grad under the same key. The
    secondary cases sit on either side of the compaction threshold (576
    lanes run at full width; 16,384 lanes compact to 4,096). A
    boundary-only image is exactly zero and its gradient is not."""
    monkeypatch.delenv("PSDR_TPU_SSE_COMPACT", raising=False)
    monkeypatch.delenv("PSDR_TPU_SSE_COMPACT_SHIFT", raising=False)
    monkeypatch.delenv("PSDR_TPU_VIS_REUSE", raising=False)
    j_make, t_make, kw = SLICE_CASES[case]
    js, ts = _pair(j_make, t_make, **kw)
    n = kw["width"] * kw["height"] * kw["sppse"]
    if n:
        compacts = t_direct._compact_eligibility(n) is not None
        assert compacts == (case in ("secondary_compacted", "all_terms"))
    j_loss, j_grads = _jax_grad(js, seed=3)
    t_loss, img, t_grads = _port_grad(ts, js.params(), seed=3)
    if kw["spp"] == 0:
        assert t_loss == 0.0 and j_loss == 0.0 and not bool(img.any())
    else:
        assert abs(t_loss - j_loss) <= 1e-5 * j_loss
    assert sum(np.abs(g).sum() for g in t_grads) > 0.0
    assert sum(np.linalg.norm(a) > 0 for a in j_grads) >= 3
    _assert_grads_match(j_grads, t_grads)


def test_boundary_images_are_zero_and_grads_differ_from_interior():
    """Each boundary term alone renders exactly zero while its gradient
    does not vanish, and with_boundary=True moves the gradient away from
    the interior-only one."""
    ts = t_scenes.cbox_scene(16, 16, spp=2, sppe=2, sppse=4,
                             occluder_subdiv=2, **CPU)
    integ = TDirect(1, 1)
    p = params_from_numpy(ts.params(), **CPU, requires_grad=True)
    flat = ts.build(p)
    key = threefry.PRNGKey(5)
    for term in (integ.render_primary_edges, integ.render_secondary_edges):
        img = term(ts, flat, 0, key)
        assert img.shape == (256, 3) and not bool(img.detach().any())
        grads = torch.autograd.grad(img.sum(), _leaves(p), allow_unused=True,
                                    retain_graph=True)
        assert all(g is None or torch.isfinite(g).all() for g in grads)
        assert sum(float(g.abs().sum()) for g in grads if g is not None) > 0
    out = []
    for wb in (True, False):
        q = params_from_numpy(ts.params(), **CPU, requires_grad=True)
        integ.render_fn(ts, with_boundary=wb)(q, key).mean().backward()
        out.append(np.concatenate([x.grad.numpy().ravel()
                                   for x in _leaves(q["meshes"][5])]))
    assert np.abs(out[0] - out[1]).max() > 1e-4


def test_compacted_pass_equals_full_width_pass(monkeypatch):
    """PSDR_TPU_SSE_COMPACT=0/1 in the port (the port's version of
    tests/test_boundary.py::test_secondary_compact_path_matches_full): the
    same samples and estimator at another width and order, rtol 1e-4."""
    out = []
    for compact in ("1", "0"):
        monkeypatch.setenv("PSDR_TPU_SSE_COMPACT", compact)
        ts = t_scenes.cbox_scene(64, 64, spp=0, sppse=4, occluder_subdiv=3,
                                 **CPU)
        out.append(_port_grad(ts, ts.params(), seed=7)[2])
    total = 0.0
    for a, b in zip(*out):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-6 * max(np.abs(b).max(), 1e-12))
        total += np.abs(b).sum()
    assert total > 0


def test_remat_and_chunked_boundary_passes_agree():
    """Several lane chunks (pass_lanes below the wavefront), checkpointed
    and not: the same gradients bit for bit, every leaf finite."""
    out = []
    for remat in (False, True):
        ts = t_scenes.cbox_scene(16, 16, spp=1, sppe=2, sppse=4,
                                 occluder_subdiv=2, **CPU)
        ts.opts = dataclasses.replace(ts.opts, pass_lanes=512,
                                      remat_passes=remat)
        out.append(_port_grad(ts, ts.params(), seed=2))
    (l0, _, g0), (l1, _, g1) = out
    assert l0 == l1 and sum(np.abs(g).sum() for g in g0) > 0
    for a, b in zip(g0, g1):
        assert np.isfinite(a).all()
        np.testing.assert_array_equal(a, b)


def test_primary_edge_vis_check_rejects_occluded_edge(monkeypatch):
    """The port's version of tests/test_boundary.py::
    test_primary_edge_vis_check_rejects_occluded, small: a quad between the
    camera and the sphere's right silhouette arc. The check rejects part of
    the valid edge samples, never all, agrees with the JAX package's on the
    same samples. With the option on, render_primary_edges runs one more
    occlusion query per chunk and the gradient stays finite; the rejected
    samples saw the unlit blocker on both sides, so it is also unchanged
    (rtol 1e-5)."""
    def blocked(make, prim, xf):
        sc = make(width=16, height=16, spp=1, sppe=4, subdiv=1)
        blocker = prim.make_quad(size=0.9, bsdf_id=len(sc.bsdfs) - 1,
                                 enable_edges=False)
        blocker.set_transform(np.asarray(xf.translate([0.8, 0.0, 2.5])))
        sc.add_mesh(blocker)
        return sc

    from psdr_tpu.core import transform as j_xf
    js = blocked(j_sphere, j_prim, j_xf)
    ts = blocked(lambda **kw: t_scenes.sphere_light_scene(**kw, **CPU),
                 t_prim, t_xf)
    ts.meshes[0].edge_indices = js.meshes[0].edge_indices
    jf, tf = _flats(js, ts)
    u = np.random.default_rng(1).uniform(size=2048).astype(np.float32)
    pj = j_persp.sample_primary_edge(jf.sensors[0], jnp.asarray(u))
    pt = t_persp.sample_primary_edge(tf.sensors[0], torch.from_numpy(u))
    valid = _np(pt.idx) >= 0
    occ_t = _np(t_scene.ray_test(tf, pt.ray_c, pt.vis_dist,
                                 torch.from_numpy(valid)))
    occ_j = np.asarray(j_scene.ray_test(jf, pj.ray_c, pj.vis_dist,
                                        jnp.asarray(valid)))
    assert valid.sum() > 100
    assert 0 < occ_t[valid].mean() < 0.9
    assert (occ_t != occ_j).mean() <= 1e-3
    from psdr_tpu_torch.integrator import base as t_base
    calls = []
    monkeypatch.setattr(t_base, "ray_test", lambda *a, **k: (
        calls.append(1), t_scene.ray_test(*a, **k))[1])
    grads = []
    for check in (False, True):
        ts.opts = dataclasses.replace(ts.opts, primary_edge_vis_check=check)
        grads.append(_port_grad(ts, ts.params(), seed=1)[2])
        assert len(calls) == int(check)
    assert all(np.isfinite(g).all() for g in grads[1])
    assert sum(np.abs(g).sum() for g in grads[1]) > 0
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(b).max(), 1e-12))


# -- guiding ------------------------------------------------------------------------

def test_guiding_mass_and_guided_gradient_match_jax():
    """preprocess_secondary_edges(sc, 0, (4, 4, 4, 2), nrounds=2, seed=3):
    the cell masses against the JAX package's, rtol 1e-4 (atol 1e-4 of the
    largest cell: a cell that holds one grazing sample); then the guided
    secondary-edge gradient under the JAX package's table (carried across
    with its cmf) per leaf. A one-rank ``mesh=`` builds the serial table;
    over several ranks ``tests/test_torch_parallel.py`` holds it."""
    js, ts = _cbox_pair(width=32, height=32, spp=0, sppse=4,
                        occluder_subdiv=3)
    ji, ti = JDirect(1, 1), TDirect(1, 1)
    ji.preprocess_secondary_edges(js, 0, (4, 4, 4, 2), nrounds=2, seed=3)
    ti.preprocess_secondary_edges(ts, 0, (4, 4, 4, 2), nrounds=2, seed=3)
    mj = np.asarray(ji.warpper[0].distrb.pmf)
    mt = _np(ti.warpper[0].distrb.pmf)
    assert mt.shape == (64,) and 0 < (mt > 0).sum() < 64
    np.testing.assert_allclose(mt, mj, rtol=1e-4, atol=1e-4 * mj.max())
    assert ti.warpper[0].resolution == (4, 4, 4)

    ti.warpper[0] = hypercube_from_numpy(
        (4, 4, 4), ji.warpper[0].distrb.pmf, ji.warpper[0].distrb.cmf, **CPU)
    j_loss, j_grads = _jax_grad(js, seed=5, integ=ji)
    t_loss, img, t_grads = _port_grad(ts, js.params(), seed=5, integ=ti)
    assert t_loss == 0.0 and j_loss == 0.0 and not bool(img.any())
    assert sum(np.abs(g).sum() for g in t_grads) > 0.0
    _assert_grads_match(j_grads, t_grads)
    # guiding changes the estimate
    _, _, unguided = _port_grad(ts, js.params(), seed=5)
    assert max(np.abs(a - b).max() for a, b in zip(unguided, t_grads)) > 1e-5

    one = TDirect(1, 1)
    one.preprocess_secondary_edges(ts, 0, (4, 4, 4, 2), nrounds=2, seed=3,
                                   mesh=LocalRank(None, 0, 1, ts.device))
    np.testing.assert_array_equal(_np(one.warpper[0].distrb.pmf), mt)
    with pytest.raises(ValueError):
        ti.preprocess_secondary_edges(ts, 0, (4, 4, 4, 2), nrounds=0)


def test_guiding_table_above_2_15_cells_matches_jax():
    """preprocess_secondary_edges(sc, 0, (1400, 5, 5, 1), nrounds=1): 35,000
    cells, above the 2^15 where both packages leave the small-table search
    for their large one (``searchsorted`` against the JAX package's blocked
    count). The masses against the JAX package's within rtol 1e-4 (atol
    1e-4 of the largest cell, as the small table's test); the port's cmf
    non-decreasing, ending at its total, and within 1e-5 of the total of
    the JAX cmf entry by entry (measured 6.1e-7: a sequential sum against
    XLA's parallel scan round apart in the last places); then, with the
    JAX table carried across, cmf and all
    (``convert.hypercube_from_numpy``), the warped samples and their pdf
    equal the JAX package's lane by lane."""
    reso = (1400, 5, 5, 1)
    js, ts = _cbox_pair(width=16, height=16, spp=0, sppse=4,
                        occluder_subdiv=3)
    ji, ti = JDirect(1, 1), TDirect(1, 1)
    ji.preprocess_secondary_edges(js, 0, reso, nrounds=1, seed=3)
    ti.preprocess_secondary_edges(ts, 0, reso, nrounds=1, seed=3)
    jd, td = ji.warpper[0].distrb, ti.warpper[0].distrb
    mj, cj = np.asarray(jd.pmf), np.asarray(jd.cmf)
    mt, ct = _np(td.pmf), _np(td.cmf)
    assert mt.shape == (35000,) and 100 < (mt > 0).sum() < 35000
    np.testing.assert_allclose(mt, mj, rtol=1e-4, atol=1e-4 * mj.max())
    assert (np.diff(ct) >= 0).all() and ct[-1] == float(td.total)
    assert np.abs(ct - cj).max() <= 1e-5 * cj[-1]

    hc = hypercube_from_numpy(reso[:3], mj, cj, **CPU)
    u = np.random.default_rng(4).uniform(size=(20000, 3)).astype(np.float32)
    wt, pt = t_dist.hypercube_sample_reuse(hc, torch.from_numpy(u))
    wj, pj = j_dist.hypercube_sample_reuse(ji.warpper[0], jnp.asarray(u))
    np.testing.assert_array_equal(_np(wt), np.asarray(wj))
    np.testing.assert_array_equal(_np(pt), np.asarray(pj))


def test_guiding_reduces_the_boundary_derivative_variance():
    """``tests/test_reference_parity.py``'s variance test (the JAX
    package's, which needs the reference's scenes) in the port at a reduced
    grid, as ``scripts/bench_guiding_scale.py`` measures it: the
    forward-mode derivative image of the boundary terms (``run_ad``; cbox
    24x24, spp 0, sppse 32) with respect to the occluder's translation
    along -x, at four keys, under a (400, 4, 4, 2) table built over 4
    rounds and unguided. The mean per-pixel variance over the keys, guided
    against unguided, below the JAX package's bar of 0.8 (measured
    0.17)."""
    from psdr_tpu_torch.testing import run_ad
    sc = t_scenes.cbox_scene(24, 24, spp=0, sppse=32, occluder_subdiv=3,
                             **CPU)
    guided = TDirect(1, 1)
    guided.preprocess_secondary_edges(sc, 0, (400, 4, 4, 2), nrounds=4)
    var = []
    for integ in (guided, TDirect(1, 1)):
        imgs = np.stack([run_ad(sc, integ, "mesh_transform", npass=1,
                                seed0=100 + s, mesh_index=5,
                                direction=(-1.0, 0.0, 0.0))
                         for s in range(4)])
        assert np.isfinite(imgs).all()
        var.append(imgs.var(axis=0).mean())
    assert var[1] > 0.0 and var[0] < 0.8 * var[1], var


def test_guiding_on_a_scene_without_edges_falls_back_to_uniform():
    ts = t_scenes.floor_light_scene(8, 8, 1, **CPU)
    ts.opts = dataclasses.replace(ts.opts, sppse=1)
    integ = TDirect(1, 1)
    integ.preprocess_secondary_edges(ts, 0, (2, 2, 2, 2), seed=1)
    assert _np(integ.warpper[0].distrb.pmf).tolist() == [1.0] * 8


# -- physics: AD with the boundary terms against finite differences --------------

def test_boundary_ad_matches_fd_sphere_translation(monkeypatch):
    """A sphere translated along x across its silhouette and its shadow
    (sphere_light_scene, 12x12, spp 32, sppe 64, sppse 64): forward-mode AD
    of the image with the boundary terms against central finite differences
    (eps 0.05, common random numbers, visibility reuse off as in the JAX
    package's AD-vs-FD tests), both averaged over 4 keys. The silhouette
    and shadow gradient is all boundary term: interior-only AD misses it.
    With the boundary terms the L1 error against FD is under 0.5 of the
    interior-only error (measured 0.23; FD's own noise is part of it), and
    the boundary part is over half of FD's L1 norm (measured 1.07)."""
    monkeypatch.setenv("PSDR_TPU_VIS_REUSE", "off")
    sc = t_scenes.sphere_light_scene(12, 12, spp=32, sppe=64, sppse=64,
                                     subdiv=1, **CPU)
    integ = TDirect(1, 1)
    shift = torch.tensor([1.0, 0.0, 0.0])
    renders = {wb: integ.render_fn(sc, with_boundary=wb)
               for wb in (True, False)}

    def f(P, key, wb):
        p = params_from_numpy(sc.params(), **CPU)
        mp = p["meshes"][0]
        p["meshes"][0] = {"vertex_positions": mp["vertex_positions"]
                          + P * shift, "to_world": mp["to_world"]}
        return renders[wb](p, key)

    ad, ad_nob, fd = [], [], []
    for seed in range(4):
        key = threefry.PRNGKey(seed)
        for wb, out in ((True, ad), (False, ad_nob)):
            with fwAD.dual_level():
                out.append(fwAD.unpack_dual(f(fwAD.make_dual(
                    torch.tensor(0.0), torch.tensor(1.0)), key, wb)).tangent)
        eps = 0.05
        with torch.no_grad():
            fd.append((f(torch.tensor(eps), key, False)
                       - f(torch.tensor(-eps), key, False)) / (2 * eps))
    ad, ad_nob, fd = (torch.stack(x).mean(0) for x in (ad, ad_nob, fd))
    assert torch.isfinite(ad).all()
    boundary_part = float((ad - ad_nob).abs().sum())
    err_with = float((ad - fd).abs().sum())
    err_without = float((ad_nob - fd).abs().sum())
    assert boundary_part > 0.5 * float(fd.abs().sum())
    assert err_with < 0.5 * err_without, (err_with, err_without)
