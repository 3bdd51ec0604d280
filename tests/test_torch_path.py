"""The port's PathTracer against the JAX package's: the same numpy inputs go
through the JAX function and its counterpart, module by module (the sphere
warp, the silhouette pre-pass, ``Li``, the indirect and the camera-side
boundary estimators, the guiding table) and for the slice as a whole
(renderC per pixel, value_and_grad per leaf). The port runs on the CPU
(``device="cpu"``), where the intersection kernels take their plain
versions; the JAX package runs as its own tests run it on the CPU.

The scenes stay below ``accel_min_faces`` wherever lanes are compared one by
one, so both packages take brute force and a lane's hits agree; a lane whose
detached hit differs (a tie, a grazing hit) differs entirely afterwards,
and every such test states the share of lanes that must agree. As in
``test_torch_boundary.py`` the port's meshes share the JAX meshes' edge
tables, and the lane-by-lane tests carry the JAX package's ``cmf`` of the
edge distribution and of the guiding tables across. A boundary estimator's
value is zero in the primal, so its lanes are compared through the
forward-mode derivative of a translation of the occluder, lane by lane."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from psdr_tpu import PathTracer as JPath
from psdr_tpu.core import warp as j_warp
from psdr_tpu.core.records import Ray as JRay
from psdr_tpu.core.sampler import RngStream as JRng
from psdr_tpu.integrator import path as j_path
from psdr_tpu.scene import scene as j_scene
from psdr_tpu.sensor import perspective as j_persp
from psdr_tpu_torch import DirectIntegrator as TDirect
from psdr_tpu_torch import PathTracer as TPath
from psdr_tpu_torch.convert import (discrete_from_numpy, hypercube_from_numpy,
                                    params_from_numpy)
from psdr_tpu_torch.core import threefry
from psdr_tpu_torch.core import warp as t_warp
from psdr_tpu_torch.core.records import Ray as TRay
from psdr_tpu_torch.core.sampler import RngStream as TRng
from psdr_tpu_torch.integrator import path as t_path
from psdr_tpu_torch.scene import scene as t_scene
from psdr_tpu_torch.sensor import perspective as t_persp
from psdr_tpu_torch.testing import scenes as t_scenes
from psdr_tpu_torch.testing.ranks import LocalRank

from scenes import cbox_scene as j_cbox
from scenes import sphere_light_scene as j_sphere
from test_camera_indirect_boundary import _hidden_shadow_scene as j_hidden
from test_indirect_boundary import _gi_shadow_scene as j_gi

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


def _on_jax_cmf(tf, jf):
    return tf._replace(sec_distrb=discrete_from_numpy(
        jf.sec_distrb.pmf, jf.sec_distrb.cmf, **CPU))


def _sorted_samples(n, seed):
    u = np.random.default_rng(seed).uniform(size=(n, 3)).astype(np.float32)
    return u[np.argsort(u[:, 0], kind="stable")]


# -- the validation scenes ---------------------------------------------------------

@pytest.mark.parametrize("j_make,t_make", [
    (j_gi, t_scenes.gi_shadow_scene), (j_hidden, t_scenes.hidden_shadow_scene)],
    ids=["gi_shadow", "hidden_shadow"])
def test_validation_scenes_equal_the_jax_tests(j_make, t_make):
    """The port's jax-free copies of the indirect and the camera-side
    estimators' validation scenes: every params leaf and every render
    option equal to the JAX tests' scenes, exactly."""
    js, ts = j_make(), t_make(**CPU)
    j_leaves, t_leaves = _leaves(js.params()), _leaves(ts.params())
    assert len(j_leaves) == len(t_leaves) > 8
    for a, b in zip(j_leaves, t_leaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for f in ("width", "height", "spp", "sppe", "sppse"):
        assert getattr(js.opts, f) == getattr(ts.opts, f)
    assert [m.enable_edges for m in js.meshes] == [
        m.enable_edges for m in ts.meshes]


# -- the warp and the silhouette pre-pass ---------------------------------------

def test_square_to_uniform_sphere_matches_jax():
    """Unit directions, uniform in z; against the JAX function to 1 ulp of
    1 (sin and cos round apart between XLA and torch), z exactly."""
    u = np.random.default_rng(0).uniform(size=(5000, 2)).astype(np.float32)
    got = _np(t_warp.square_to_uniform_sphere(torch.from_numpy(u)))
    want = np.asarray(j_warp.square_to_uniform_sphere(jnp.asarray(u)))
    np.testing.assert_array_equal(got[:, 2], want[:, 2])
    np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
    assert abs(got[:, 2].mean()) < 0.03
    assert t_warp.square_to_uniform_sphere_pdf() == pytest.approx(
        float(j_warp.square_to_uniform_sphere_pdf()))


def test_direction_segment_valid_matches_jax():
    """The detached silhouette pre-pass on 20,000 edge-sorted samples, on
    the JAX package's cmf: the same lanes, bit for bit but for directions
    within EdgeEpsilon of a face's plane (at most 1e-4 of the lanes)."""
    js, ts = _pair(j_cbox, t_scenes.cbox_scene, width=8, height=8, spp=1,
                   sppse=1, occluder_subdiv=2)
    jf = j_scene.detach_flat(js.build(js.params()))
    tf = _on_jax_cmf(t_scene.detach_flat(
        ts.build(params_from_numpy(js.params(), **CPU))), jf)
    u = _sorted_samples(20000, 1)
    vj = np.asarray(j_path._direction_segment_valid(jf, jnp.asarray(u)))
    vt = _np(t_path._direction_segment_valid(tf, torch.from_numpy(u)))
    assert vt.dtype == bool and 0.02 < vj.mean() < 0.2
    assert (vt != vj).mean() <= 1e-4


# -- Li, lane by lane -------------------------------------------------------------

@pytest.mark.parametrize("reuse", ["off", "edge"])
@pytest.mark.parametrize("depth,hide", [(1, False), (2, False), (3, False),
                                        (3, True)])
def test_li_matches_jax_lane_by_lane(depth, hide, reuse, monkeypatch):
    """PathTracer.Li on 2,048 camera rays (512 pixels x 4 adjacent lanes,
    the layout the visibility reuse reads) under one stream: rtol 1e-5
    (atol 1e-6 of the largest radiance) on at least 99.8% of the lanes
    (measured: all at depth 1 and 2, all but one lane at depth 3); the
    rest took another hit at some bounce."""
    monkeypatch.setenv("PSDR_TPU_VIS_REUSE", reuse)
    monkeypatch.delenv("PSDR_TPU_VIS_REUSE_Q", raising=False)
    kw = dict(width=16, height=16, spp=4, occluder_subdiv=1)
    js, ts = j_cbox(**kw), t_scenes.cbox_scene(**kw, **CPU)
    jf = j_scene.detach_flat(js.build(js.params()))
    tf = t_scene.detach_flat(ts.build(params_from_numpy(js.params(), **CPU)))
    rng = np.random.default_rng(0)
    npix, spp = 512, 4
    n = npix * spp
    uv = (np.repeat(rng.uniform(size=(npix, 2)), spp, 0)
          + rng.uniform(-0.01, 0.01, size=(n, 2)))
    uv = np.clip(uv, 0, 1).astype(np.float32)

    def j_li(uv):
        ray = j_persp.sample_primary_ray(jf.sensors[0], uv)
        r = JRng(jax.random.PRNGKey(5), salt=0)
        r.vis_spp = spp
        return JPath(depth, hide_emitters=hide).Li(
            js, jf, r, JRay(ray.o, ray.d), jnp.ones(n, bool))

    want = np.asarray(jax.jit(j_li)(jnp.asarray(uv)))
    ray = t_persp.sample_primary_ray(tf.sensors[0], torch.from_numpy(uv))
    r = TRng(threefry.PRNGKey(5), salt=0, **CPU)
    r.vis_spp = spp
    with torch.no_grad():
        got = _np(TPath(depth, hide_emitters=hide).Li(
            ts, tf, r, TRay(ray.o, ray.d), torch.ones(n, dtype=torch.bool)))
    assert np.isfinite(got).all() and got.mean() > 0.05
    close = np.isclose(got, want, rtol=1e-5,
                       atol=1e-6 * np.abs(want).max()).all(-1)
    assert close.mean() >= 0.998, close.mean()
    assert abs(got.mean() - want.mean()) <= 1e-4 * want.mean()


# -- renderC per pixel --------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 3, 6])
def test_renderC_matches_jax_and_scan_depths_changes_nothing(depth):
    """render_fn(with_boundary=False, detached=True) on cbox 16x16, spp 4:
    ``scan_depths`` False and True give the same image bit for bit in the
    port, and both equal the JAX package's (unrolled) image: at least 99%
    of pixels allclose (rtol 1e-4, atol 1e-5), means to 1e-4."""
    kw = dict(width=16, height=16, spp=4, occluder_subdiv=1)
    js, ts = j_cbox(**kw), t_scenes.cbox_scene(**kw, **CPU)
    want = np.asarray(jax.jit(JPath(depth, scan_depths=False).render_fn(
        js, with_boundary=False, detached=True))(
            js.params(), jax.random.PRNGKey(5)))
    p = params_from_numpy(js.params(), **CPU)
    imgs = [_np(TPath(depth, scan_depths=scan).render_fn(
        ts, with_boundary=False, detached=True)(p, threefry.PRNGKey(5)))
        for scan in (False, True)]
    np.testing.assert_array_equal(imgs[0], imgs[1])
    close = np.isclose(imgs[0], want, rtol=1e-4, atol=1e-5).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(imgs[0].mean() - want.mean()) <= 1e-4 * want.mean()


def test_depth1_matches_direct_and_depth_adds_energy():
    """``tests/test_path.py::test_depth1_matches_direct`` in the port:
    PathTracer(1) is DirectIntegrator(1, 1)'s estimator, so the means over
    4 seeds agree within 5%; and three bounces in a closed box add light."""
    ts = t_scenes.cbox_scene(32, 32, spp=16, **CPU)

    def avg(integ):
        return np.mean([_np(integ.renderC(ts, seed=s)) for s in range(4)],
                       axis=0)

    d, p1, p3 = avg(TDirect(1, 1)), avg(TPath(1)), avg(TPath(3))
    assert p1.shape == (32, 32, 3) and np.isfinite(p3).all()
    assert abs(p1.mean() - d.mean()) < 0.05 * d.mean()
    assert p3.mean() > 1.05 * p1.mean()


# -- the boundary estimators, lane by lane -------------------------------------------

def _estimator_pair(n, seed):
    """Both packages' cbox (92 triangles: brute force in both), their
    params, and n edge-sorted samples."""
    js, ts = _pair(j_cbox, t_scenes.cbox_scene, width=16, height=16, spp=1,
                   sppse=2, occluder_subdiv=1)
    return js, ts, _sorted_samples(n, seed)


def _shift(params, P, lib):
    """The occluder (mesh 5) translated by P along (1, 0.5, 0.25)."""
    p = {k: list(v) for k, v in params.items()}
    mp = params["meshes"][5]
    d = lib.asarray([1.0, 0.5, 0.25], dtype=lib.float32)
    p["meshes"][5] = {"vertex_positions": mp["vertex_positions"] + P * d,
                      "to_world": mp["to_world"]}
    return p


def _jax_splats(js, u, eval_fn):
    """(pix, value, d value / dP) per splat of the JAX estimator."""
    base = js.params()

    def f(P):
        flat = js.build(_shift(base, P, jnp))
        out = eval_fn(flat, jnp.asarray(u))
        return [v for _, v in out], [p for p, _ in out]

    vals, tans, pix = jax.jit(lambda: jax.jvp(
        f, (jnp.float32(0.0),), (jnp.float32(1.0),), has_aux=True))()
    return [(np.asarray(p), np.asarray(v), np.asarray(t))
            for p, v, t in zip(pix, vals, tans)]


def _port_splats(ts, jf, params_np, u, eval_fn):
    base = params_from_numpy(params_np, **CPU)
    res = []
    with fwAD.dual_level():
        P = fwAD.make_dual(torch.tensor(0.0), torch.tensor(1.0))
        flat = _on_jax_cmf(ts.build(_shift(base, P, torch)), jf)
        for pix, v in eval_fn(flat, torch.from_numpy(u)):
            v, t = fwAD.unpack_dual(v)
            res.append((_np(pix), _np(v),
                        np.zeros_like(_np(v)) if t is None else _np(t)))
    return res


def _assert_splats_match(got, want, min_live, min_agree=0.998):
    """Per splat: the pixel of every lane (the lane's validity: -1 is a dead
    lane) on at least ``min_agree`` of the lanes; values exactly zero; and
    the derivative to rtol 1e-3 (atol 1e-4 of the largest) on the lanes
    whose pixels agree, all but 0.2% of them (a derivative sums a few
    hundred cancelling terms of the triangle recompute)."""
    assert len(got) == len(want)
    for k, ((pt, vt, tt), (pj, vj, tj)) in enumerate(zip(got, want)):
        assert not vt.any() and not vj.any(), k
        assert np.isfinite(tt).all(), k
        same = pt == pj
        assert same.mean() >= min_agree, (k, same.mean())
        live = same & (pj >= 0)
        assert live.sum() >= min_live, (k, live.sum())
        assert np.abs(tj[live]).max() > 0.0, k
        close = np.isclose(tt[same], tj[same], rtol=1e-3,
                           atol=1e-4 * np.abs(tj).max()).all(-1)
        assert close.mean() >= 0.998, (k, close.mean())
        assert not tt[pt < 0].any(), k


@pytest.mark.parametrize("ad", [True, False])
def test_eval_secondary_edge_indirect_matches_jax(ad):
    """PathTracer(2).eval_secondary_edge_indirect on 8,192 samples. With
    ``ad``: pixel and derivative per lane (``_assert_splats_match``).
    Without (the guiding variant): pixel -1 everywhere and |value| to rtol
    1e-4 on the lanes both call valid, which are all but 0.2%."""
    js, ts, u = _estimator_pair(8192, 3)
    jf = js.build(js.params())
    if ad:
        want = _jax_splats(js, u, lambda flat, x: [
            JPath(2).eval_secondary_edge_indirect(
                js, flat, 0, x, JRng(jax.random.PRNGKey(7), salt=3))])
        got = _port_splats(ts, jf, js.params(), u, lambda flat, x: [
            TPath(2).eval_secondary_edge_indirect(
                ts, flat, 0, x, TRng(threefry.PRNGKey(7), salt=3, **CPU))])
        _assert_splats_match(got, want, min_live=100)
        return
    _, vj = jax.jit(lambda x: JPath(2).eval_secondary_edge_indirect(
        js, j_scene.detach_flat(jf), 0, x,
        JRng(jax.random.PRNGKey(7), salt=3), ad=False))(jnp.asarray(u))
    tf = _on_jax_cmf(t_scene.detach_flat(
        ts.build(params_from_numpy(js.params(), **CPU))), jf)
    with torch.no_grad():
        pix, vt = TPath(2).eval_secondary_edge_indirect(
            ts, tf, 0, torch.from_numpy(u),
            TRng(threefry.PRNGKey(7), salt=3, **CPU), ad=False)
    vj, vt = np.asarray(vj), _np(vt)
    assert (_np(pix) == -1).all() and np.isfinite(vt).all()
    lj, lt = vj.max(-1) > 0, vt.max(-1) > 0
    assert lj.sum() > 100
    assert (lj != lt).mean() <= 2e-3
    both = lj & lt
    np.testing.assert_allclose(vt[both], vj[both], rtol=1e-4)


@pytest.mark.parametrize("far,include_s1,camera_depth,max_depth", [
    ("emitter", False, 2, 1), ("emitter", True, 2, 1),
    ("direction", False, 2, 2), ("direction", True, 3, 3)])
def test_eval_secondary_edge_camera_matches_jax(far, include_s1,
                                                camera_depth, max_depth):
    """eval_secondary_edge_camera on 16,384 samples: one splat a walk depth
    (and the s = 1 splat first with ``include_s1``), each held lane by lane
    (``_assert_splats_match``). The walk's draws come after the far-side
    radiance's subkey, in both packages' streams."""
    js, ts, u = _estimator_pair(16384, 4)
    jf = js.build(js.params())
    salt = 2 if far == "emitter" else 3
    want = _jax_splats(js, u, lambda flat, x: JPath(
        max_depth, camera_depth=camera_depth).eval_secondary_edge_camera(
            js, flat, 0, x, JRng(jax.random.PRNGKey(9), salt=salt), far,
            include_s1=include_s1))
    got = _port_splats(ts, jf, js.params(), u, lambda flat, x: TPath(
        max_depth, camera_depth=camera_depth).eval_secondary_edge_camera(
            ts, flat, 0, x, TRng(threefry.PRNGKey(9), salt=salt, **CPU), far,
            include_s1=include_s1))
    assert len(got) == camera_depth - 1 + int(include_s1)
    _assert_splats_match(got, want, min_live=30)


def test_eval_secondary_edge_camera_rejects_unknown_far():
    ts = t_scenes.cbox_scene(8, 8, spp=1, sppse=1, **CPU)
    with pytest.raises(ValueError, match="far"):
        TPath(2, camera_depth=2).eval_secondary_edge_camera(
            ts, ts.flat, 0, torch.rand(8, 3),
            TRng(threefry.PRNGKey(0), **CPU), "sky")
    with pytest.raises(ValueError):
        TPath(max_depth=0)


# -- the slice as a whole: value_and_grad per leaf -----------------------------------

def _jax_grad(js, integ, seed, with_boundary, power=2):
    render = integ.render_fn(js, with_boundary=with_boundary)
    value, grad = jax.jit(jax.value_and_grad(
        lambda p: jnp.mean(render(p, jax.random.PRNGKey(seed)) ** power)))(
            js.params())
    return float(value), [np.asarray(g).ravel() for g in jax.tree.leaves(grad)]


def _port_grad(ts, params_np, integ, seed, with_boundary, power=2):
    """Loss mean(img^power) and its gradient per leaf; power 1 for an image
    of boundary terms alone, which is zero and so is mean(img^2)'s
    gradient."""
    p = params_from_numpy(params_np, **CPU, requires_grad=True)
    img = integ.render_fn(ts, with_boundary=with_boundary)(
        p, threefry.PRNGKey(seed))
    loss = torch.mean(img ** power)
    loss.backward()
    return float(loss), [
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
        assert err <= rel_l2 * na + 1e-12, (i, err, na)
        if na > 0:
            worst = max(worst, err / na)
            assert float(g @ a) / (np.linalg.norm(g) * na) >= min_cos, i
    return worst


INTERIOR_CASES = {
    "sphere_light": (j_sphere, t_scenes.sphere_light_scene,
                     dict(width=16, height=16, spp=4, subdiv=1)),
    "cbox": (j_cbox, t_scenes.cbox_scene,
             dict(width=16, height=16, spp=4, occluder_subdiv=1)),
}


@pytest.mark.parametrize("case", list(INTERIOR_CASES))
def test_interior_value_and_grad_matches_jax(case, monkeypatch):
    """value_and_grad of mean(img^2) through Scene.build and
    PathTracer(3).render_fn(with_boundary=False), per params leaf against
    jax.value_and_grad under the same key: loss to 1e-5, every leaf within
    1e-2 relative L2 and cosine 0.999 (measured worst leaf: 6.1e-7 on
    sphere_light, 1.4e-5 on cbox), every leaf finite."""
    monkeypatch.delenv("PSDR_TPU_VIS_REUSE", raising=False)
    j_make, t_make, kw = INTERIOR_CASES[case]
    js, ts = _pair(j_make, t_make, **kw)
    j_loss, j_grads = _jax_grad(js, JPath(3), 3, False)
    t_loss, t_grads = _port_grad(ts, js.params(), TPath(3), 3, False)
    assert abs(t_loss - j_loss) <= 1e-5 * j_loss
    assert sum(np.linalg.norm(a) > 0 for a in j_grads) >= 4
    _assert_grads_match(j_grads, t_grads)


BOUNDARY_KW = dict(width=16, height=16, spp=2, sppe=2, sppse=8,
                   occluder_subdiv=1)


@pytest.mark.parametrize("max_depth,camera_depth,fused,spp", [
    (2, 1, "1", 0), (1, 2, "1", 0), (2, 2, "1", 0), (1, 2, "0", 0),
    (2, 2, "0", 0), (2, 2, "1", 2), (3, 3, "1", 0)])
def test_boundary_value_and_grad_matches_jax(max_depth, camera_depth, fused,
                                             spp, monkeypatch):
    """value_and_grad through render_fn(with_boundary=True) on cbox 16x16
    (sppe 2, sppse 8: 2,048 secondary lanes, compacted to 512) per leaf
    against jax.value_and_grad, each against its JAX twin under the same
    ``PSDR_TPU_FUSED_BOUNDARY``; (3, 3) walks the camera side's importance
    path two bounces deep. With spp 0 the image is the boundary terms
    alone: exactly zero in both packages, the loss is mean(img) and the
    gradient is all boundary; with spp 2 the loss is mean(img^2) over all
    terms, equal to 1e-5. Leaves within 1e-2 relative L2 and cosine 0.999
    (measured worst leaf: 5.1e-6 boundary only, 1.1e-5 with all terms; the
    edge distribution's cmf is each package's own here)."""
    monkeypatch.setenv("PSDR_TPU_FUSED_BOUNDARY", fused)
    for k in ("PSDR_TPU_SSE_COMPACT", "PSDR_TPU_SSE_COMPACT_SHIFT",
              "PSDR_TPU_VIS_REUSE"):
        monkeypatch.delenv(k, raising=False)
    power = 2 if spp else 1
    js, ts = _pair(j_cbox, t_scenes.cbox_scene, **{**BOUNDARY_KW, "spp": spp})
    j_loss, j_grads = _jax_grad(
        js, JPath(max_depth, camera_depth=camera_depth), 3, True, power)
    t_loss, t_grads = _port_grad(
        ts, js.params(), TPath(max_depth, camera_depth=camera_depth), 3, True,
        power)
    if spp:
        assert abs(t_loss - j_loss) <= 1e-5 * j_loss
    else:
        assert t_loss == 0.0 and j_loss == 0.0
    assert sum(np.linalg.norm(a) > 0 for a in j_grads) >= 3
    _assert_grads_match(j_grads, t_grads)


def test_fused_and_unfused_passes_differ_only_in_their_samples(monkeypatch):
    """The fused pass shares one stream between the s = 1 and s >= 2
    estimators, the separate passes draw their own: two estimates of one
    gradient, finite, non-zero and not equal; with camera_depth 1 there is
    nothing to fuse and the switch changes nothing."""
    ts = t_scenes.cbox_scene(**BOUNDARY_KW, **CPU)
    out = {}
    for cd in (1, 2):
        for fused in ("1", "0"):
            monkeypatch.setenv("PSDR_TPU_FUSED_BOUNDARY", fused)
            out[cd, fused] = np.concatenate(_port_grad(
                ts, ts.params(), TPath(2, camera_depth=cd), 3, True)[1])
    np.testing.assert_array_equal(out[1, "1"], out[1, "0"])
    assert np.isfinite(out[2, "1"]).all() and np.isfinite(out[2, "0"]).all()
    assert np.abs(out[2, "1"] - out[2, "0"]).max() > 1e-6
    assert np.abs(out[2, "1"] - out[1, "1"]).max() > 1e-6


def test_camera_edges_compacted_and_full_width(monkeypatch):
    """``tests/test_camera_indirect_boundary.py::
    test_camera_edges_compact_matches_full`` in the port (cbox 64x64, sppse
    4, 1,292 triangles: the BVH and K1's plain version;
    PathTracer(1, camera_depth=2)): the walk draws at the compacted width,
    so the two modes are two estimates: both finite and non-zero; and the
    compacted one equals the JAX package's compacted gradient per leaf
    (1e-2 relative L2; measured 1.1e-4)."""
    monkeypatch.delenv("PSDR_TPU_FUSED_BOUNDARY", raising=False)
    kw = dict(width=64, height=64, spp=0, sppse=4, occluder_subdiv=3)
    js, ts = _pair(j_cbox, t_scenes.cbox_scene, **kw)
    grads = {}
    for compact in ("1", "0"):
        monkeypatch.setenv("PSDR_TPU_SSE_COMPACT", compact)
        loss, grads[compact] = _port_grad(
            ts, js.params(), TPath(1, camera_depth=2), 3, True, power=1)
        assert loss == 0.0
        assert all(np.isfinite(g).all() for g in grads[compact])
        assert sum(np.abs(g).sum() for g in grads[compact]) > 0
    monkeypatch.setenv("PSDR_TPU_SSE_COMPACT", "1")
    j_grads = _jax_grad(js, JPath(1, camera_depth=2), 3, True, power=1)[1]
    _assert_grads_match(j_grads, grads["1"])


def test_remat_and_chunked_passes_agree():
    """Several lane chunks (pass_lanes below every wavefront), checkpointed
    and not: PathTracer(2, camera_depth=2) gives the same loss and the same
    gradients bit for bit, every leaf finite."""
    out = []
    for remat in (False, True):
        ts = t_scenes.cbox_scene(16, 16, spp=2, sppe=2, sppse=8,
                                 occluder_subdiv=1, **CPU)
        ts.opts = dataclasses.replace(ts.opts, pass_lanes=512,
                                      remat_passes=remat)
        out.append(_port_grad(ts, ts.params(), TPath(2, camera_depth=2), 2,
                              True))
    (l0, g0), (l1, g1) = out
    assert l0 == l1 and sum(np.abs(g).sum() for g in g0) > 0
    for a, b in zip(g0, g1):
        assert np.isfinite(a).all()
        np.testing.assert_array_equal(a, b)


def test_remat_on_env_bench_scene_and_the_step_image():
    """``PathTracer(3)`` on a small ``env_bench_scene`` (rough conductor,
    textures, authored normals, environment map) in four pass chunks:
    ``remat_passes=True`` gives the loss, the image and every leaf of
    ``remat_passes=False`` bit for bit, every leaf finite. The step's image
    against the forward's (``render_fn(detached=True)``) at the same key,
    under ``chip_smoke.py`` phase 4's gates (at least 0.99 of the pixels
    within rtol 1e-4, atol 1e-5; means within 1e-4): not bit for bit, since
    the forward reads the hit query's own t and uv and the step recomputes
    each hit on its triangle (measured: every pixel within rtol 1e-4)."""
    out = []
    for remat in (False, True):
        sc = t_scenes.env_bench_scene(32, 32, 4, sphere_subdiv=3,
                                      small_subdiv=2, env_size=(130, 258),
                                      tex_size=32, **CPU)
        sc.opts = dataclasses.replace(sc.opts, pass_lanes=1024,
                                      remat_passes=remat)
        p = params_from_numpy(sc.params(), **CPU, requires_grad=True)
        img = TPath(3).render_fn(sc, with_boundary=False)(
            p, threefry.PRNGKey(3))
        loss = torch.mean(img ** 2)
        loss.backward()
        out.append((float(loss), img.detach().numpy(),
                    [x.grad.numpy() for x in _leaves(p) if x.grad is not None]))
    (l0, i0, g0), (l1, i1, g1) = out
    assert l0 == l1 and len(g0) == len(g1) > 10
    np.testing.assert_array_equal(i0, i1)
    for a, b in zip(g0, g1):
        assert np.isfinite(a).all()
        np.testing.assert_array_equal(a, b)
    with torch.no_grad():
        fwd = TPath(3).render_fn(sc, with_boundary=False, detached=True)(
            sc.params(), threefry.PRNGKey(3)).numpy()
    assert np.isclose(i1, fwd, rtol=1e-4, atol=1e-5).all(axis=-1).mean() >= 0.99
    assert abs(i1.mean() - fwd.mean()) < 1e-4 * fwd.mean()


# -- guiding ------------------------------------------------------------------------

def test_indirect_guiding_mass_matches_jax_and_guided_renderD_is_finite():
    """preprocess_indirect_edges(sc, 0, (4, 4, 4, 2), nrounds=2, seed=3) on
    the GI-shadow scene: the cell masses against the JAX package's, rtol
    1e-3 (atol 1e-3 of the largest cell: a cell holds a few samples, and one
    that changes its hit moves it); a guided renderD under the JAX table
    (carried across by ``hypercube_from_numpy`` with its cmf) is finite, as
    is its fused twin. A one-rank ``mesh=`` builds the serial direct table
    and, from its rank's own stream, a finite indirect one (over several
    ranks ``tests/test_torch_parallel.py`` holds both)."""
    js, ts = _pair(j_gi, t_scenes.gi_shadow_scene, width=12, height=12,
                   spp=4, sppe=2, sppse=8)
    ji, ti = JPath(2), TPath(2)
    ji.preprocess_indirect_edges(js, 0, (4, 4, 4, 2), nrounds=2, seed=3)
    ti.preprocess_indirect_edges(ts, 0, (4, 4, 4, 2), nrounds=2, seed=3)
    mj = np.asarray(ji.ind_warpper[0].distrb.pmf)
    mt = _np(ti.ind_warpper[0].distrb.pmf)
    assert mt.shape == (64,) and 0 < (mt > 0).sum() < 64
    np.testing.assert_allclose(mt, mj, rtol=1e-3, atol=1e-3 * mj.max())
    assert ti.ind_warpper[0].resolution == (4, 4, 4) and not ti.warpper

    for integ in (ti, TPath(2, camera_depth=2)):
        integ.ind_warpper[0] = hypercube_from_numpy(
            (4, 4, 4), ji.ind_warpper[0].distrb.pmf,
            ji.ind_warpper[0].distrb.cmf, **CPU)
        img = integ.renderD(ts, seed=0)
        assert img.shape == (12, 12, 3) and torch.isfinite(img).all()
    # the direct table goes through DirectIntegrator's build into warpper
    ti.preprocess_secondary_edges(ts, 0, (2, 2, 2, 2), seed=1)
    assert ti.warpper[0].num_cells == 8

    one, mesh = TPath(2), LocalRank(None, 0, 1, ts.device)
    one.preprocess_secondary_edges(ts, 0, (2, 2, 2, 2), seed=1, mesh=mesh)
    np.testing.assert_array_equal(_np(one.warpper[0].distrb.pmf),
                                  _np(ti.warpper[0].distrb.pmf))
    one.preprocess_indirect_edges(ts, 0, (4, 4, 4, 2), nrounds=2, seed=3,
                                  mesh=mesh)
    m1 = _np(one.ind_warpper[0].distrb.pmf)
    assert m1.shape == (64,) and np.isfinite(m1).all() and (m1 >= 0).all()
    assert m1.sum() > 0.0
    with pytest.raises(ValueError):
        ti.preprocess_indirect_edges(ts, 0, (4, 4, 4, 2), nrounds=0)


def test_guided_indirect_gradient_matches_jax():
    """The guided indirect term (PathTracer(2) on the GI-shadow scene, 24x24,
    sppse 8: 4,608 lanes, full width) under the JAX package's table: per
    leaf within 1e-2 relative L2 (measured 3e-4), and guiding changes the
    estimate."""
    js, ts = _pair(j_gi, t_scenes.gi_shadow_scene, width=24, height=24,
                   spp=0, sppe=0, sppse=8)
    ji, ti = JPath(2), TPath(2)
    ji.preprocess_indirect_edges(js, 0, (4, 4, 4, 2), nrounds=1, seed=1)
    ti.ind_warpper[0] = hypercube_from_numpy(
        (4, 4, 4), ji.ind_warpper[0].distrb.pmf, ji.ind_warpper[0].distrb.cmf,
        **CPU)
    j_grads = _jax_grad(js, ji, 5, True, power=1)[1]

    def port(integ):
        loss, grads = _port_grad(ts, js.params(), integ, 5, True, power=1)
        assert loss == 0.0
        return grads

    t_grads = port(ti)
    assert sum(np.abs(g).sum() for g in t_grads) > 0
    _assert_grads_match(j_grads, t_grads)
    unguided = port(TPath(2))
    assert max(np.abs(a - b).max() for a, b in zip(unguided, t_grads)) > 1e-6


# -- physics and safety ---------------------------------------------------------------

def test_interior_gradient_is_zero():
    """``tests/test_indirect_boundary.py::test_interior_gradient_is_zero``
    in the port: sliding the flat blocker of the GI-shadow scene in its own
    plane has NO interior derivative: forward mode gives exactly 0.0, so
    the whole gradient is a visibility-boundary effect."""
    ts = t_scenes.gi_shadow_scene(spp=8, **CPU)
    render = TPath(max_depth=2).render_fn(ts, with_boundary=False)
    base = params_from_numpy(ts.params(), **CPU)
    with fwAD.dual_level():
        P = fwAD.make_dual(torch.tensor(0.0), torch.tensor(1.0))
        p = {k: list(v) for k, v in base.items()}
        mp = base["meshes"][3]
        p["meshes"][3] = {
            "vertex_positions": mp["vertex_positions"]
            + P * torch.tensor([1.0, 0.0, 0.0]),
            "to_world": mp["to_world"]}
        out = fwAD.unpack_dual(render(p, threefry.PRNGKey(0)).mean())
    assert float(out.primal) > 0.0
    assert out.tangent is None or float(out.tangent) == 0.0


@pytest.mark.parametrize("scene,moving,carrying", [
    ("gi_shadow", 3, ("fused_direction", "indirect", "all")),
    ("hidden_shadow", 2, ("fused_emitter", "fused_direction", "indirect",
                          "camera_emitter", "all"))])
def test_boundary_images_are_zero_and_full_gradient_is_finite(scene, moving,
                                                              carrying):
    """Every secondary boundary pass of PathTracer(2, camera_depth=2), fused
    and separate, renders exactly zero with a finite gradient, which does
    not vanish on the blocker for the passes that carry the scene's signal
    (the GI shadow has no emitter-side segment: its light faces away from
    the blocker); a per-leaf isfinite sweep of the full (2, 2) gradient
    with all terms on."""
    make = getattr(t_scenes, scene + "_scene")
    ts = make(width=12, height=12, spp=2, sppse=16, **CPU)
    ts.opts = dataclasses.replace(ts.opts, sppe=2)
    integ = TPath(2, camera_depth=2)
    p = params_from_numpy(ts.params(), **CPU, requires_grad=True)
    flat = ts.build(p)
    key = threefry.PRNGKey(5)
    terms = {
        "fused_emitter": lambda: integ._render_boundary_fused(
            ts, flat, 0, key, "emitter"),
        "fused_direction": lambda: integ._render_boundary_fused(
            ts, flat, 0, key, "direction"),
        "indirect": lambda: integ.render_indirect_edges(ts, flat, 0, key),
        "camera_emitter": lambda: integ.render_camera_edges(
            ts, flat, 0, key, "emitter"),
        "camera_direction": lambda: integ.render_camera_edges(
            ts, flat, 0, key, "direction"),
        "all": lambda: integ.render_secondary_edges(ts, flat, 0, key),
    }
    for name, term in terms.items():
        img = term()
        assert img.shape == (144, 3) and not bool(img.detach().any()), name
        w = torch.linspace(-1, 1, 144)[:, None]
        grads = torch.autograd.grad((img * w).sum(), _leaves(p),
                                    allow_unused=True, retain_graph=True)
        assert all(g is None or torch.isfinite(g).all() for g in grads), name
        g_block = torch.autograd.grad(
            (img * w).sum(), list(p["meshes"][moving].values()),
            allow_unused=True, retain_graph=True)
        moved = sum(float(g.abs().sum()) for g in g_block if g is not None)
        assert moved > 0 or name not in carrying, name

    q = params_from_numpy(ts.params(), **CPU, requires_grad=True)
    img = integ.render_fn(ts, with_boundary=True)(q, key)
    torch.mean(img ** 2).backward()
    for x in _leaves(q):
        assert x.grad is None or torch.isfinite(x.grad).all()
    assert float(q["meshes"][moving]["to_world"].grad.abs().sum()) > 0


def test_replaced_sub_pass_takes_the_unfused_path(monkeypatch):
    """The test seam: an instance whose ``render_indirect_edges`` (or
    ``render_camera_edges``) is replaced runs the separate passes, so the
    replacement is called and the fused pass is not."""
    monkeypatch.delenv("PSDR_TPU_FUSED_BOUNDARY", raising=False)
    ts = t_scenes.cbox_scene(8, 8, spp=1, sppse=4, occluder_subdiv=1, **CPU)
    key = threefry.PRNGKey(1)
    fused_calls, calls = [], []
    monkeypatch.setattr(
        TPath, "_render_boundary_fused",
        lambda self, sc, fl, sid, k, far, shard=None: (
            fused_calls.append(far),
            torch.zeros((sc.opts.num_pixels, 3)))[1])
    integ = TPath(2, camera_depth=2)
    integ.render_secondary_edges(ts, ts.flat, 0, key)
    assert fused_calls == ["emitter", "direction"]

    integ.render_indirect_edges = lambda sc, fl, sid, k, shard=None: (
        calls.append("indirect"), torch.zeros((sc.opts.num_pixels, 3)))[1]
    img = integ.render_secondary_edges(ts, ts.flat, 0, key)
    assert calls == ["indirect"] and len(fused_calls) == 2
    assert img.shape == (64, 3)

    integ = TPath(1, camera_depth=2)
    integ.render_camera_edges = lambda sc, fl, sid, k, far, shard=None: (
        calls.append(far), torch.zeros((sc.opts.num_pixels, 3)))[1]
    integ.render_secondary_edges(ts, ts.flat, 0, key)
    assert calls == ["indirect", "emitter"] and len(fused_calls) == 2


def test_lane_sharding_raises():
    """``shard=`` of every PathTracer pass: one rank's slice of all the
    lanes is the unsharded pass, gradient and all; the slices of two ranks
    render (zero in the primal) with finite gradients. Over gloo ranks
    ``tests/test_torch_parallel.py`` holds the sums."""
    ts = t_scenes.cbox_scene(8, 8, spp=1, sppse=4, occluder_subdiv=1, **CPU)
    integ, key = TPath(2, camera_depth=2), threefry.PRNGKey(1)
    for term, extra in ((integ.render_secondary_edges, ()),
                        (integ.render_indirect_edges, ()),
                        (integ.render_camera_edges, ("emitter",)),
                        (integ._render_boundary_fused, ("direction",))):
        grads = []
        for shard in (None, (0, 1), (0, 2), (1, 2)):
            p = params_from_numpy(ts.params(), **CPU, requires_grad=True)
            img = term(ts, ts.build(p), 0, key, *extra, shard=shard)
            assert not bool(img.any())
            img.sum().backward()
            grads.append([x.grad for m in p["meshes"] for x in m.values()
                          if x.grad is not None])
        assert grads[0] and all(torch.isfinite(g).all() for gs in grads
                                for g in gs)
        for a, b in zip(grads[0], grads[1]):
            assert torch.equal(a, b)
