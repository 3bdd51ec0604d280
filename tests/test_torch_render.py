"""The port's forward render against the JAX package's, end to end:
DirectIntegrator(1, 1) renderC semantics (render_fn with_boundary=False,
detached=True) on cbox_scene(32, 32, spp=4, occluder_subdiv=3), 1,292
triangles, so the BVH and K1 run (the plain version, on the CPU). Both
packages get the same parameters (params_from_numpy) and PRNGKey(seed);
their uniforms are bit-equal, so lanes agree to float rounding. XLA-CPU
and torch-CPU round a few ops differently (fused Moller-Trumbore, sin/cos,
matmul order), so a handful of lanes may cross a discrete test (a triangle
edge, the side gate, a penumbra class): at least 99% of pixels must be
allclose (rtol 1e-4, atol 1e-5) and the image means must agree to 1e-4."""
import numpy as np
import jax
import pytest
import torch

from psdr_tpu import DirectIntegrator as JDirect
from psdr_tpu_torch import DirectIntegrator as TDirect
from psdr_tpu_torch.convert import params_from_numpy
from psdr_tpu_torch.core import threefry
from psdr_tpu_torch.scene.scene import Scene
from psdr_tpu_torch.testing.scenes import cbox_scene as t_cbox

from scenes import cbox_scene as j_cbox

torch.set_num_threads(2)

SCENE = dict(width=32, height=32, spp=4, occluder_subdiv=3)
CPU = dict(device="cpu")     # the port defaults to the card


def _renders(seed):
    js = j_cbox(**SCENE)
    j_img = np.asarray(jax.jit(JDirect(1, 1).render_fn(
        js, with_boundary=False, detached=True))(
            js.params(), jax.random.PRNGKey(seed)))
    ts = t_cbox(**SCENE, **CPU)
    t_img = TDirect(1, 1).render_fn(ts, with_boundary=False, detached=True)(
        params_from_numpy(js.params(), **CPU), threefry.PRNGKey(seed)).numpy()
    return j_img, t_img


@pytest.mark.parametrize("reuse,q", [("off", None), ("edge", None),
                                     ("bern", "0.25")])
def test_render_matches_jax(reuse, q, monkeypatch):
    monkeypatch.setenv("PSDR_TPU_VIS_REUSE", reuse)
    if q is None:
        monkeypatch.delenv("PSDR_TPU_VIS_REUSE_Q", raising=False)
    else:
        monkeypatch.setenv("PSDR_TPU_VIS_REUSE_Q", q)
    j_img, t_img = _renders(seed=3)
    assert t_img.shape == j_img.shape == (SCENE["width"] * SCENE["height"], 3)
    assert np.isfinite(t_img).all() and t_img.mean() > 0.0
    close = np.isclose(t_img, j_img, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(t_img.mean() - j_img.mean()) / j_img.mean() < 1e-4


@pytest.mark.parametrize("stratify_primary", [True, False])
@pytest.mark.parametrize("integ", ["direct", "path"])
def test_stratified_sampler_matches_jax(integ, stratify_primary):
    """sampler="stratified" (spp 4: a 2 x 2 jitter grid and the per-pixel
    rotated strata of the first NEE and BSDF samples), and the same
    sampler with ``stratify_primary`` off (plain uniform draws): per pixel
    against the JAX package under the same key, for DirectIntegrator(1, 1)
    and PathTracer(2). Same tolerances as the sobol cases; the two
    settings give different images."""
    import dataclasses
    from psdr_tpu import PathTracer as JPath
    from psdr_tpu_torch import PathTracer as TPath
    js, ts = j_cbox(**SCENE), t_cbox(**SCENE, **CPU)
    imgs = {}
    for strat in (stratify_primary, not stratify_primary):
        kw = dict(sampler="stratified", stratify_primary=strat)
        js.opts = dataclasses.replace(js.opts, **kw)
        ts.opts = dataclasses.replace(ts.opts, **kw)
        ti = TDirect(1, 1) if integ == "direct" else TPath(2)
        imgs[strat] = ti.render_fn(ts, with_boundary=False, detached=True)(
            params_from_numpy(js.params(), **CPU),
            threefry.PRNGKey(3)).numpy()
        if strat != stratify_primary:
            break
        ji = JDirect(1, 1) if integ == "direct" else JPath(2)
        j_img = np.asarray(jax.jit(ji.render_fn(
            js, with_boundary=False, detached=True))(
                js.params(), jax.random.PRNGKey(3)))
    t_img = imgs[stratify_primary]
    assert np.isfinite(t_img).all() and t_img.mean() > 0.0
    close = np.isclose(t_img, j_img, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(t_img.mean() - j_img.mean()) / j_img.mean() < 1e-4
    assert not np.allclose(imgs[True], imgs[False])


def test_unknown_sampler_is_refused():
    import dataclasses
    ts = t_cbox(8, 8, spp=1, **CPU)
    ts.opts = dataclasses.replace(ts.opts, sampler="halton")
    with pytest.raises(ValueError, match="unknown sampler"):
        TDirect(1, 1).renderC(ts)


def test_scene_build_matches_jax():
    """The flat scene: face table (F, 32), emitter faces, emitter tables."""
    js, ts = j_cbox(**SCENE), t_cbox(**SCENE, **CPU)
    jf = js.build(js.params())
    tf = ts.build(params_from_numpy(js.params(), **CPU))
    np.testing.assert_allclose(np.asarray(jf.face_table),
                               tf.face_table.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(jf.em_tri_idx),
                                  tf.em_tri_idx.numpy())
    for f in ("emitter_radiance", "emitter_weight", "emitter_inv_area"):
        np.testing.assert_allclose(np.asarray(getattr(jf, f)),
                                   getattr(tf, f).numpy(), rtol=1e-6)
    assert ts.face_offset == js.face_offset


def test_unported_options_raise():
    """What the port leaves out raises NotImplementedError instead of doing
    something else: an emitter or a BSDF of an unknown kind (in the build,
    and so in render_fn and renderD). Options once left out now run: the
    boundary options (sppe/sppse > 0) build and render, the 1D vertex
    offset is a leaf, and lane sharding (``shard=`` of every term, the
    ``mesh=`` of the guiding build) renders one rank's slice of all the
    lanes as the unsharded call does."""
    from psdr_tpu_torch.integrator.direct import _emitter_meta

    ts = t_cbox(width=8, height=8, spp=1, sppe=1, sppse=1, occluder_subdiv=1,
                **CPU)
    integ = TDirect(1, 1)
    flat = ts.build(params_from_numpy(ts.params(), **CPU))
    key = threefry.PRNGKey(0)
    assert integ.renderD(ts).shape == (8, 8, 3)
    for term in (integ.render_interior, integ.render_primary_edges,
                 integ.render_secondary_edges):
        assert torch.equal(term(ts, flat, 0, key, shard=(0, 1)),
                           term(ts, flat, 0, key))
    assert torch.equal(integ.radiance_image(ts, flat, 0, key, True,
                                            shard=(0, 1)),
                       integ.radiance_image(ts, flat, 0, key, True))
    from psdr_tpu_torch.testing.ranks import LocalRank
    integ.preprocess_secondary_edges(ts, 0, (2, 2, 2, 1),
                                     mesh=LocalRank(None, 0, 1, ts.device))
    assert integ.warpper[0].num_cells == 8

    from psdr_tpu_torch.shape import primitives
    quad = primitives.make_quad(enable_vertex_offset=True)
    assert quad.params()["vertex_offset"].shape == (4,)

    class PointLight:       # stands in for an emitter kind of no package
        kind = "point"

        def params(self):
            return {}

    ts.add_emitter(PointLight())
    assert _emitter_meta(ts)[-1] == ("env", -1)
    with pytest.raises(NotImplementedError, match="PointLight is not ported"):
        ts.build(ts.params())
    with pytest.raises(NotImplementedError, match="PointLight is not ported"):
        integ.render_fn(ts, with_boundary=True)(ts.params(), key)
    with pytest.raises(NotImplementedError, match="PointLight is not ported"):
        integ.renderD(ts)


def test_default_device_is_the_card_never_the_cpu():
    """The scene makers, ``Scene`` and ``params_from_numpy`` name the card
    when the caller names no device. Where there is no card, building
    raises torch's own error: nothing falls back to the CPU."""
    sc = t_cbox(8, 8, spp=1)
    assert sc.device.type == Scene().device.type == "cuda"
    if torch.cuda.is_available():
        assert sc.build(sc.params()).tri.p0.is_cuda
        assert params_from_numpy({"x": np.zeros(3)})["x"].is_cuda
        return
    with pytest.raises((AssertionError, RuntimeError)):
        sc.build(sc.params())
    with pytest.raises((AssertionError, RuntimeError)):
        params_from_numpy({"x": np.zeros(3)})


@pytest.mark.parametrize("subdiv", [0, 3])
def test_vertex_normals_sum_in_one_fixed_order(subdiv):
    """``compute_triangle_info``'s vertex normals sum each vertex's corners
    through ``vertex_corner_table`` in one fixed order: bit for bit what a
    sequential scatter-add over corner 0, 1, 2 of every face gives (the
    CPU's ``index_add``; on the card the same order, where an atomic
    scatter-add would sum in another order on every run), and JAX's
    normals to float rounding, on a jittered icosphere."""
    from psdr_tpu.shape.mesh import compute_triangle_info as j_info
    from psdr_tpu_torch.core.math import cross, norm, normalize
    from psdr_tpu_torch.shape import primitives
    from psdr_tpu_torch.shape.mesh import (compute_triangle_info,
                                           vertex_corner_table)
    m = primitives.make_icosphere(subdiv=subdiv)
    rng = np.random.default_rng(subdiv)
    vp = (m.vertices + rng.normal(size=m.vertices.shape) * 0.01).astype(
        np.float32)
    faces = torch.as_tensor(m.faces).long()
    table = vertex_corner_table(m.faces, m.num_vertices)
    assert table.shape == (m.num_vertices, 6 if subdiv else 5)
    _, vn = compute_triangle_info(torch.as_tensor(vp), faces,
                                  m.num_vertices, torch.as_tensor(table))
    t = torch.as_tensor(vp)
    fn = cross(t[faces[:, 1]] - t[faces[:, 0]], t[faces[:, 2]] - t[faces[:, 0]])
    want = torch.zeros_like(t)
    weight = torch.zeros(m.num_vertices)
    for i in range(3):
        want = want.index_add(0, faces[:, i], fn)
        weight = weight.index_add(0, faces[:, i], norm(fn))
    assert torch.equal(vn, normalize(want / weight[:, None]))
    _, j_vn = j_info(jax.numpy.asarray(vp), jax.numpy.asarray(m.faces),
                     m.num_vertices)
    np.testing.assert_allclose(vn.numpy(), np.asarray(j_vn), rtol=1e-5,
                               atol=1e-6)
