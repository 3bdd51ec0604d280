"""The port's materials against the JAX package's on the CPU: GGX, the
conductor Fresnel term and the rough conductor lane by lane, the bilinear
texture lookup with its gradients, authored vertex normals, the textured
quad per pixel, and ``value_and_grad`` per leaf on a small cbox with one
rough-conductor wall and one textured wall under ``PathTracer(3)``.

Every input is made from a numpy seed and goes through both packages.
Lane-by-lane cases ask for rtol 1e-5 / atol 1e-6 on a stated share of the
lanes: XLA and torch round ``rsqrt``, ``sin`` and ``cos`` differently in
the last place, so a lane at a mask's threshold (``D * cos > 1e-5``, a
clip) may fall on the other side.

The JAX package's reverse-mode gradient of a rough conductor is NaN (its
``ggx_smith_g1`` and ``eval_roughconductor`` divide by zero on masked
lanes, and a zero cotangent times an infinite slope is NaN; its own tests
differentiate in forward mode, where the select drops the bad tangent). So
the per-leaf reference here is ``jax.jvp``: the full gradient of every leaf
of up to 16 entries, one basis tangent each, and three seeded random
projections of each larger leaf. The port divides by 1 on those lanes and
its reverse-mode gradient is finite on every leaf.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import psdr_tpu as J
import psdr_tpu_torch as T
from psdr_tpu.bsdf import ggx as j_ggx
from psdr_tpu.bsdf import roughconductor as j_rc
from psdr_tpu.core import bitmap as j_bitmap
from psdr_tpu.core import frame as j_frame
from psdr_tpu.core import math as j_math
from psdr_tpu.core.records import Intersection as JIts
from psdr_tpu_torch.bsdf import ggx as t_ggx
from psdr_tpu_torch.bsdf import roughconductor as t_rc
from psdr_tpu_torch.convert import params_from_numpy
from psdr_tpu_torch.core import bitmap as t_bitmap
from psdr_tpu_torch.core import frame as t_frame
from psdr_tpu_torch.core import math as t_math
from psdr_tpu_torch.core import threefry
from psdr_tpu_torch.core import transform as t_xf
from psdr_tpu_torch.core.records import Intersection as TIts
from psdr_tpu_torch.testing import scenes as t_scenes

from test_texture import _textured_quad_scene as j_textured_quad

torch.set_num_threads(2)

CPU = dict(device="cpu")     # the port defaults to the card
N = 4096


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close_share(got, want, rtol=1e-5, atol=1e-6):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    close = np.isclose(got, want, rtol=rtol, atol=atol)
    if close.ndim > 1:
        close = close.all(axis=-1)
    return close.mean()


def _directions(rng, n, upper_share=0.85):
    """Unit vectors, most in the upper hemisphere, some grazing, some
    below."""
    d = rng.normal(size=(n, 3))
    d[:, 2] = np.abs(d[:, 2])
    d[: n // 16, 2] *= 1e-3                       # grazing
    flip = rng.uniform(size=n) > upper_share
    d[flip, 2] *= -1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return d.astype(np.float32)


def _ggx_inputs(seed=0):
    rng = np.random.default_rng(seed)
    au = rng.uniform(0.05, 0.9, N).astype(np.float32)
    av = rng.uniform(0.05, 0.9, N).astype(np.float32)
    return (au, av, _directions(rng, N), _directions(rng, N),
            rng.uniform(size=(N, 2)).astype(np.float32))


# -- GGX and Fresnel, lane by lane ---------------------------------------------

@pytest.mark.parametrize("fn", ["ggx_eval", "ggx_smith_g1", "ggx_sample"])
def test_ggx_matches_jax(fn):
    """4,096 lanes of per-lane roughness in [0.05, 0.9] and directions on
    both sides of the horizon: at least 99.9% of the lanes within rtol
    1e-5, atol 1e-6 (measured: all). ``ggx_sample`` subtracts nearly equal
    terms (cos * y - sin * z) and normalizes twice: 98% of its unit
    vectors at that tolerance (measured 99.0%) and every component within
    5e-5 absolute (measured 9.2e-6)."""
    au, av, v, m, u2 = _ggx_inputs()
    args = {"ggx_eval": (au, av, m), "ggx_smith_g1": (au, av, v, m),
            "ggx_sample": (au, av, v, u2)}[fn]
    want = np.asarray(getattr(j_ggx, fn)(*map(jnp.asarray, args)))
    got = getattr(t_ggx, fn)(*map(_t, args))
    if fn == "ggx_sample":
        assert _close_share(got, want) >= 0.98
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=5e-5)
        np.testing.assert_allclose(np.linalg.norm(_np(got), axis=-1), 1.0,
                                   atol=1e-5)
    else:
        assert _close_share(got, want) >= 0.999


def test_fresnel_conductor_and_math_helpers_match_jax():
    rng = np.random.default_rng(1)
    eta = rng.uniform(0.1, 3.0, (N, 3)).astype(np.float32)
    k = rng.uniform(0.0, 5.0, (N, 3)).astype(np.float32)
    c = rng.uniform(0.0, 1.0, N).astype(np.float32)
    c[:8] = [0.0, 1.0, 1e-6, 0.5, 0.25, 0.75, 1.0, 0.0]
    want = np.asarray(j_math.fresnel_conductor(*map(jnp.asarray,
                                                    (eta, k, c))))
    got = t_math.fresnel_conductor(_t(eta), _t(k), _t(c))
    # near-cancelling quotients at small eta and k: all but a few entries
    assert _close_share(got, want) >= 0.999
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-4)
    assert (0.0 <= _np(got)).all() and (_np(got) <= 1.0 + 1e-6).all()

    th, ph = c * np.pi, rng.uniform(0, 2 * np.pi, N).astype(np.float32)
    assert _close_share(t_math.sphdir(_t(th), _t(ph)),
                        j_math.sphdir(jnp.asarray(th), jnp.asarray(ph))) == 1.0
    p1, p2 = rng.uniform(0, 4, N).astype(np.float32), c + 0.1
    assert _close_share(t_math.mis_weight(_t(p1), _t(p2)),
                        j_math.mis_weight(jnp.asarray(p1),
                                          jnp.asarray(p2))) == 1.0
    assert _close_share(t_math.lerp(_t(p1), _t(p2), _t(c)),
                        j_math.lerp(*map(jnp.asarray, (p1, p2, c)))) == 1.0
    assert _close_share(t_math.rcp(_t(p2)), j_math.rcp(jnp.asarray(p2))) == 1.0


def test_frame_angle_family_matches_jax():
    v = _directions(np.random.default_rng(2), N)
    v[0] = [0.0, 0.0, 1.0]
    for name in ("cos_theta_2", "sin_theta", "sin_theta_2", "tan_theta",
                 "tan_theta_2", "cos_phi", "sin_phi"):
        want = np.asarray(getattr(j_frame, name)(jnp.asarray(v)))
        assert _close_share(getattr(t_frame, name)(_t(v)), want) >= 0.999, name


def test_aabb_helpers_match_jax():
    rng = np.random.default_rng(3)
    lower, upper = np.float32([-1, -2, -1.5]), np.float32([2, 1, 1.5])
    o = rng.uniform(-0.9, 0.9, (N, 3)).astype(np.float32)
    d = _directions(rng, N, upper_share=0.5)
    jt, jn, jG = j_math.ray_intersect_scene_aabb(*map(jnp.asarray,
                                                      (o, d, lower, upper)))
    tt, tn, tG = t_math.ray_intersect_scene_aabb(*map(_t, (o, d, lower, upper)))
    assert _close_share(tt, jt) == 1.0 and _close_share(tG, jG) == 1.0
    np.testing.assert_array_equal(_np(tn), np.asarray(jn))
    o2 = rng.uniform(-4, 4, (N, 3)).astype(np.float32)
    ja, jlo, jhi = j_math.ray_intersect_box(*map(jnp.asarray,
                                                 (o2, d, lower, upper)))
    ta, tlo, thi = t_math.ray_intersect_box(*map(_t, (o2, d, lower, upper)))
    np.testing.assert_array_equal(_np(ta), np.asarray(ja))
    assert _close_share(tlo, jlo) == 1.0 and _close_share(thi, jhi) == 1.0
    r = T.core.records.Ray(_t(o), _t(d)).reversed()
    np.testing.assert_array_equal(_np(r.d), -d)


# -- the rough conductor, lane by lane -----------------------------------------

def _its(cls, lib, wi, uv):
    n = wi.shape[0]
    as_ = jnp.asarray if lib == "jax" else _t
    z3 = np.zeros((n, 3), np.float32)
    up = np.tile(np.float32([0, 0, 1]), (n, 1))
    frame_mod = j_frame if lib == "jax" else t_frame
    return cls(valid=as_(np.ones(n, bool)), t=as_(np.ones(n, np.float32)),
               p=as_(z3), n=as_(up), sh_frame=frame_mod.make_frame(as_(up)),
               uv=as_(uv), wi=as_(wi), J=as_(np.ones(n, np.float32)),
               mesh_id=as_(np.zeros(n, np.int32)),
               tri_id=as_(np.zeros(n, np.int32)),
               bsdf_id=as_(np.zeros(n, np.int32)),
               emitter_id=as_(np.full(n, -1, np.int32)))


def _rc_params(textured):
    rng = np.random.default_rng(4)
    mat = J.RoughConductor(alpha_u=0.15, alpha_v=0.4)
    p = {k: np.asarray(v, np.float32) for k, v in mat.params().items()}
    if textured:
        p["alpha_u"] = rng.uniform(0.05, 0.6, (6, 5, 1)).astype(np.float32)
        p["specular_reflectance"] = rng.uniform(
            0.2, 1.0, (4, 7, 3)).astype(np.float32)
    return p


@pytest.mark.parametrize("textured", [False, True])
@pytest.mark.parametrize("fn", ["eval", "pdf", "sample"])
def test_roughconductor_matches_jax(fn, textured):
    """eval_/pdf_/sample_roughconductor on 4,096 lanes, constant and
    image-textured parameters: at least 99.8% of the lanes within rtol
    1e-5, atol 1e-6 (measured: >= 99.95%; the rest sit at ggx_eval's
    ``D * cos > 1e-5`` cut, where a last-place difference flips the
    lane). The sampled direction carries ``ggx_sample``'s rounding: 98% of
    the lanes at that tolerance, and 99.8% of them within 5e-5 absolute
    (wo) and rtol 1e-3 (pdf)."""
    rng = np.random.default_rng(5)
    wi, wo = _directions(rng, N), _directions(rng, N)
    uv = rng.uniform(-0.5, 1.5, (N, 2)).astype(np.float32)
    u3 = rng.uniform(size=(N, 3)).astype(np.float32)
    active = rng.uniform(size=N) > 0.1
    p = _rc_params(textured)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    jits, tits = _its(JIts, "jax", wi, uv), _its(TIts, "torch", wi, uv)
    if fn == "sample":
        want = j_rc.sample_roughconductor(jp, jits, jnp.asarray(u3),
                                          jnp.asarray(active))
        got = t_rc.sample_roughconductor(tp, tits, _t(u3), _t(active))
        agree = (_np(got.valid) == np.asarray(want.valid))
        assert agree.mean() >= 0.998
        # off the mask the dispatch discards the sample, and the port reads
        # other texels there (eval_bitmap's ``active``)
        g_wo, w_wo = _np(got.wo)[active], np.asarray(want.wo)[active]
        g_pdf, w_pdf = _np(got.pdf)[active], np.asarray(want.pdf)[active]
        assert _close_share(g_wo, w_wo) >= 0.98
        assert _close_share(g_pdf, w_pdf) >= 0.98
        assert _close_share(g_wo, w_wo, rtol=0, atol=5e-5) >= 0.998
        assert _close_share(g_pdf, w_pdf, rtol=1e-3) >= 0.998
        assert np.asarray(want.valid).mean() > 0.5
        return
    j_fn = getattr(j_rc, f"{fn}_roughconductor")
    t_fn = getattr(t_rc, f"{fn}_roughconductor")
    want = np.asarray(j_fn(jp, jits, jnp.asarray(wo), jnp.asarray(active)))
    got = t_fn(tp, tits, _t(wo), _t(active))
    assert _close_share(got, want) >= 0.998
    assert (want != 0).mean() > 0.2


def test_roughconductor_reverse_gradient_is_finite_on_masked_lanes():
    """Lanes the masks discard (wi or wo at or below the horizon, the zero
    vector of a dead lane, exact back-scatter's zero half vector) put no
    NaN into any parameter's gradient, nor into wo's or wi's."""
    rng = np.random.default_rng(6)
    wi, wo = _directions(rng, 256), _directions(rng, 256)
    wo[:8] = 0.0
    wi[8:16] = 0.0
    wo[16:24] = -wi[16:24]
    wi[24:32, 2] = 0.0
    tp = {k: _t(v).requires_grad_() for k, v in _rc_params(True).items()}
    tits = _its(TIts, "torch", wi, rng.uniform(size=(256, 2)).astype(np.float32))
    wi_t = tits.wi.clone().requires_grad_()
    tits = tits._replace(wi=wi_t)
    wo_t = _t(wo).requires_grad_()
    act = torch.ones(256, dtype=torch.bool)
    loss = (t_rc.eval_roughconductor(tp, tits, wo_t, act).sum()
            + t_rc.pdf_roughconductor(tp, tits, wo_t, act).sum())
    loss.backward()
    assert torch.isfinite(loss)
    for name, x in {**tp, "wo": wo_t, "wi": wi_t}.items():
        assert torch.isfinite(x.grad).all(), name
    assert tp["alpha_v"].grad.abs().sum() > 0


# -- textures --------------------------------------------------------------------

@pytest.mark.parametrize("shape,flip_v", [((8, 8, 3), False), ((5, 7, 1), True),
                                          ((1, 1, 3), False),
                                          ((33, 64, 3), False)])
def test_eval_bitmap_value_and_gradients_match_jax(shape, flip_v):
    """Values, and the gradients of sum(w * eval) to the texels and to uv,
    to 1e-6 (relative to the largest entry), on uv that wrap (negative and
    above 1) and hit texel boundaries exactly."""
    rng = np.random.default_rng(7)
    data = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    uv = rng.uniform(-1.5, 2.5, (N, 2)).astype(np.float32)
    uv[:4] = [[0.0, 0.0], [1.0, 1.0], [0.5, 0.5], [0.999999, 0.25]]
    w = rng.uniform(-1, 1, (N, shape[2])).astype(np.float32)

    def j_loss(d, q):
        return jnp.sum(jnp.asarray(w) * j_bitmap.eval_bitmap(
            j_bitmap.Bitmap(d), q, flip_v=flip_v))

    want = np.asarray(j_bitmap.eval_bitmap(
        j_bitmap.Bitmap(jnp.asarray(data)), jnp.asarray(uv), flip_v=flip_v))
    jd, juv = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(data),
                                               jnp.asarray(uv))
    td, tuv = _t(data).requires_grad_(), _t(uv).requires_grad_()
    got = t_bitmap.eval_bitmap(t_bitmap.Bitmap(td), tuv, flip_v=flip_v)
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-6)
    for g, ref in ((td.grad, jd), (tuv.grad, juv)):
        ref = np.asarray(ref)
        if g is None:               # a constant texture does not read uv
            g = torch.zeros(ref.shape)
        np.testing.assert_allclose(_np(g), ref, rtol=1e-5,
                                   atol=1e-6 * max(1.0, np.abs(ref).max()))
    if shape[0] > 1:
        # lanes off ``active`` read other texels (their values are the
        # caller's to discard) and leave the active lanes' values alone
        act = _t(rng.uniform(size=N) > 0.5)
        masked = t_bitmap.eval_bitmap(t_bitmap.Bitmap(_t(data)), _t(uv),
                                      flip_v=flip_v, active=act)
        np.testing.assert_array_equal(_np(masked)[act.numpy()],
                                      _np(got)[act.numpy()])
        assert not np.array_equal(_np(masked), _np(got))
    bm = t_bitmap.from_array(data[..., 0])
    assert bm.data.shape == shape[:2] + (1,)
    assert t_bitmap.Bitmap(data).resolution == (shape[1], shape[0])


def test_texture_gather_modes_agree(monkeypatch):
    """The four texel gathers go through core.gather: every backward
    reduction gives the native one's texel gradient."""
    from psdr_tpu_torch.core import gather
    rng = np.random.default_rng(8)
    data = rng.uniform(size=(6, 9, 3)).astype(np.float32)
    uv = _t(rng.uniform(size=(N, 2)).astype(np.float32))
    grads = {}
    for mode in ("native", "scatter", "sorted", "cumsum"):
        monkeypatch.setattr(gather, "_DEFAULT_MODE", mode)
        d = _t(data).requires_grad_()
        (t_bitmap.eval_bitmap(t_bitmap.Bitmap(d), uv) ** 2).sum().backward()
        grads[mode] = d.grad.numpy()
    for mode in ("scatter", "sorted", "cumsum"):
        np.testing.assert_allclose(grads[mode], grads["native"], rtol=2e-4,
                                   atol=1e-4)


# -- authored vertex normals ---------------------------------------------------------

def _vn_meshes():
    ball = T.primitives.make_icosphere(subdiv=1, radius=0.5)
    rng = np.random.default_rng(9)
    nrm = ball.vertices + rng.normal(scale=0.1, size=ball.vertices.shape)
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    kw = dict(normals=nrm, normal_idx=ball.faces.copy(),
              use_vertex_normals=True)
    return (J.Mesh(ball.vertices, ball.faces, **kw),
            T.Mesh(ball.vertices, ball.faces, **kw))


def test_world_shading_normals_match_jax_and_carry_the_transform_gradient():
    jm, tm = _vn_meshes()
    m = (t_xf.translate([0.3, 0.1, -0.2]) @ t_xf.rotate([1, 2, 3], 40.0)
         @ t_xf.scale([1.0, 2.0, 0.5])).astype(np.float32)
    want = jm.world_shading_normals({"to_world": jnp.asarray(m)})
    tw = _t(m).requires_grad_()
    got = tm.world_shading_normals({"to_world": tw})
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w_), rtol=1e-5,
                                   atol=1e-6)
    jg = jax.grad(lambda a: sum(jnp.sum(x[:, 0] * x[:, 1]) for x in
                                jm.world_shading_normals({"to_world": a})))(
                                    jnp.asarray(m))
    sum((x[:, 0] * x[:, 1]).sum() for x in got).backward()
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-5)


def test_vertex_normals_reach_the_face_table_and_not_the_silhouette():
    """Scene.build with use_vertex_normals: the face table equals the JAX
    package's (shading normal columns 9:18 are the authored ones), and the
    geometric normals and the edge table are those of the same mesh
    without authored normals."""
    def make(lib, mesh):
        sc = lib.Scene(**({} if lib is J else CPU))
        mesh.bsdf_id = sc.add_bsdf(lib.Diffuse([0.5, 0.5, 0.5]))
        sc.add_mesh(mesh)
        cam = lib.PerspectiveCamera(fov_x=40.0)
        cam.set_transform(np.asarray(t_xf.look_at([0, 0, 3], [0, 0, 0],
                                                  [0, 1, 0])))
        sc.add_sensor(cam)
        sc.opts = lib.RenderOptions(width=8, height=8, spp=1, sppse=1)
        return sc

    jm, tm = _vn_meshes()
    tm.edge_indices = jm.edge_indices
    js, ts = make(J, jm), make(T, tm)
    jf = js.build(js.params())
    tf = ts.build(params_from_numpy(js.params(), **CPU))
    np.testing.assert_allclose(tf.face_table.numpy(),
                               np.asarray(jf.face_table), rtol=1e-5, atol=1e-6)
    plain = T.Mesh(tm.vertices, tm.faces, bsdf_id=0)
    plain.edge_indices = jm.edge_indices
    pf = make(T, plain).build(params_from_numpy(js.params(), **CPU))
    assert not np.allclose(pf.face_table[:, 9:18].numpy(),
                           tf.face_table[:, 9:18].numpy(), atol=1e-3)
    np.testing.assert_array_equal(pf.face_table[:, 18:22].numpy(),
                                  tf.face_table[:, 18:22].numpy())
    for a, b in zip(pf.sec_edge, tf.sec_edge):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_vertex_normals_are_all_or_nothing():
    ball = T.primitives.make_icosphere(subdiv=0)
    idx = ball.faces.copy()
    idx[3, 1] = -1
    with pytest.raises(ValueError, match="every face corner"):
        T.Mesh(ball.vertices, ball.faces, normals=ball.vertices,
               normal_idx=idx, use_vertex_normals=True)
    with pytest.raises(ValueError, match="every face corner"):
        T.Mesh(ball.vertices, ball.faces, use_vertex_normals=True)
    m = T.Mesh(ball.vertices, ball.faces, normals=ball.vertices,
               normal_idx=idx)          # carried, not used: no check
    assert not m.use_vertex_normals


# -- the textured quad per pixel -------------------------------------------------

def _tex(seed=10, shape=(8, 8, 3)):
    return np.random.default_rng(seed).uniform(0.1, 0.9, shape).astype(
        np.float32)


def _assert_images_match(got, want):
    assert np.isfinite(got).all() and got.mean() > 0.0
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(got.mean() - want.mean()) <= 1e-4 * want.mean()


@pytest.mark.parametrize("integ", ["direct", "path"])
def test_textured_quad_renderC_matches_jax(integ):
    """renderC semantics on the textured quad, 24 x 24 at spp 4: at least
    99% of pixels allclose (rtol 1e-4, atol 1e-5), means to 1e-4."""
    tex = _tex()
    js = j_textured_quad(tex, width=24, height=24, spp=4)
    ts = t_scenes.textured_quad_scene(tex, width=24, height=24, spp=4, **CPU)
    ji, ti = ((J.DirectIntegrator(1, 1), T.DirectIntegrator(1, 1))
              if integ == "direct" else (J.PathTracer(3), T.PathTracer(3)))
    want = np.asarray(jax.jit(ji.render_fn(js, with_boundary=False,
                                           detached=True))(
        js.params(), jax.random.PRNGKey(2)))
    got = _np(ti.render_fn(ts, with_boundary=False, detached=True)(
        params_from_numpy(js.params(), **CPU), threefry.PRNGKey(2)))
    _assert_images_match(got, want)


def test_texel_gradient_matches_jax_and_is_localized():
    """d mean(left image half) / d texels: equal to jax.grad's per texel
    (relative L2 1e-2, cosine 0.999; this scene's reverse mode is finite
    in both packages) and concentrated on the texels the left half sees
    (``tests/test_texture.py::test_texel_gradients_are_localized``)."""
    tex = np.full((8, 8, 3), 0.5, np.float32)
    js = j_textured_quad(tex)
    ts = t_scenes.textured_quad_scene(tex, **CPU)
    j_render = J.DirectIntegrator(1, 1).render_fn(js, with_boundary=False)
    jg = np.asarray(jax.jit(jax.grad(lambda p: jnp.mean(
        j_render(p, jax.random.PRNGKey(0)).reshape(32, 32, 3)[:, :16])))(
            js.params())["bsdfs"][0]["reflectance"])
    p = params_from_numpy(js.params(), **CPU, requires_grad=True)
    img = T.DirectIntegrator(1, 1).render_fn(ts, with_boundary=False)(
        p, threefry.PRNGKey(0))
    img.reshape(32, 32, 3)[:, :16].mean().backward()
    g = p["bsdfs"][0]["reflectance"].grad.numpy()
    assert np.isfinite(g).all()
    assert np.abs(g[:, :4]).sum() > 3.0 * np.abs(g[:, 5:]).sum()
    assert np.linalg.norm(g - jg) <= 1e-2 * np.linalg.norm(jg)


# -- the slice as a whole: a cbox with a rough-conductor and a textured wall -----

def _material_cbox(lib, width=12, height=12, spp=4, sppe=0, sppse=0, **kw):
    """Cornell box, floor textured (6 x 6 image), back wall a rough
    conductor, a subdiv-1 sphere, an area light. The same host arrays go
    to whichever package ``lib`` is."""
    xf = t_xf
    bitmap = j_bitmap if lib is J else t_bitmap
    sc = lib.Scene(**kw)
    white = sc.add_bsdf(lib.Diffuse([0.9, 0.9, 0.9]), "white")
    tex = sc.add_bsdf(lib.Diffuse(bitmap.from_array(_tex(11, (6, 6, 3)))),
                      "tex")
    metal = sc.add_bsdf(lib.RoughConductor(alpha_u=0.25, alpha_v=0.35),
                        "metal")
    black = sc.add_bsdf(lib.Diffuse([0.0, 0.0, 0.0]), "black")

    def wall(translate, axis, deg, bsdf):
        q = lib.primitives.make_quad(size=1.0, bsdf_id=bsdf,
                                     enable_edges=False,
                                     use_face_normals=True)
        m = xf.translate(translate)
        if deg:
            m = m @ xf.rotate(axis, deg)
        q.set_transform(np.asarray(m))
        sc.add_mesh(q)

    wall([0, -1, 0], [1, 0, 0], -90.0, tex)
    wall([0, 1, 0], [1, 0, 0], 90.0, white)
    wall([0, 0, -1], [0, 0, 0], 0.0, metal)
    wall([-1, 0, 0], [0, 1, 0], 90.0, white)
    wall([1, 0, 0], [0, 1, 0], -90.0, white)
    ball = lib.primitives.make_icosphere(subdiv=1, radius=0.35, bsdf_id=white)
    ball.set_transform(np.asarray(xf.translate([0.0, -0.2, 0.0])))
    sc.add_mesh(ball)
    light = lib.primitives.make_quad(size=0.25, bsdf_id=black,
                                     enable_edges=False,
                                     use_face_normals=True)
    light.set_transform(np.asarray(
        xf.translate([0.0, 0.98, 0.0]) @ xf.rotate([1, 0, 0], 90.0)))
    li = sc.add_mesh(light)
    sc.add_emitter(lib.AreaLight([20.0, 20.0, 8.0], mesh_index=li))
    cam = lib.PerspectiveCamera(fov_x=39.0, near=0.01, far=100.0)
    cam.set_transform(np.asarray(xf.look_at([0, 0, 3.6], [0, 0, 0],
                                            [0, 1, 0])))
    sc.add_sensor(cam)
    sc.opts = lib.RenderOptions(width=width, height=height, spp=spp,
                                sppe=sppe, sppse=sppse)
    return sc


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaf_paths(tree[k],
                                                              prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaf_paths(v, prefix + (i,))]
    return [prefix]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def jvp_reference(js, integ, seed, with_boundary, power=2, small=16,
                  n_proj=3, proj_seed=0):
    """Forward-mode reference of d mean(img^power) / d params in the JAX
    package: ``{path: ("full", gradient)}`` for leaves of up to ``small``
    entries, ``{path: ("proj", directions, derivatives)}`` for the others.
    One jitted jvp serves every tangent."""
    render = integ.render_fn(js, with_boundary=with_boundary)
    params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), js.params())

    def loss(p):
        return jnp.mean(render(p, jax.random.PRNGKey(seed)) ** power)

    jvp = jax.jit(lambda p, t: jax.jvp(loss, (p,), (t,)))
    zeros = jax.tree.map(jnp.zeros_like, params)
    rng = np.random.default_rng(proj_seed)
    out, value = {}, None
    for path in _leaf_paths(js.params()):
        leaf = np.asarray(_get(params, path))

        def tangent(direction):
            t = jax.tree.map(lambda x: x, zeros)
            node = t
            for k in path[:-1]:
                node = node[k]
            node[path[-1]] = jnp.asarray(direction.reshape(leaf.shape),
                                         jnp.float32)
            return t

        if leaf.size <= small:
            g = np.zeros(leaf.size, np.float32)
            for i in range(leaf.size):
                e = np.zeros(leaf.size, np.float32)
                e[i] = 1.0
                value, d = jvp(params, tangent(e))
                g[i] = float(d)
            out[path] = ("full", g)
        else:
            dirs = rng.normal(size=(n_proj, leaf.size)).astype(np.float32)
            ds = []
            for r in dirs:
                value, d = jvp(params, tangent(r))
                ds.append(float(d))
            out[path] = ("proj", dirs, np.float32(ds))
    return float(value), out


def assert_matches_jvp_reference(ref, p, rel=1e-2, min_cos=0.999):
    """The port's reverse-mode ``.grad`` of every leaf of ``p`` against
    ``jvp_reference``: finite; a fully known leaf within ``rel`` relative
    L2 and cosine ``min_cos``; a projected leaf within ``rel`` of the
    largest projection on each direction. Returns the worst relative
    error."""
    worst = 0.0
    for path, entry in ref.items():
        leaf = _get(p, path)
        g = (np.zeros(leaf.numel(), np.float32) if leaf.grad is None
             else leaf.grad.numpy().ravel())
        assert np.isfinite(g).all(), path
        if entry[0] == "full":
            a = entry[1]
            assert np.isfinite(a).all(), path
            na, err = np.linalg.norm(a), np.linalg.norm(g - a)
            assert err <= rel * na + 1e-9, (path, err, na)
            if na > 1e-9:
                worst = max(worst, err / na)
                assert g @ a / (np.linalg.norm(g) * na) >= min_cos, path
        else:
            _, dirs, ds = entry
            got = dirs @ g
            scale = np.abs(ds).max()
            assert np.abs(got - ds).max() <= rel * scale + 1e-9, (path, got,
                                                                  ds)
            if scale > 1e-9:
                worst = max(worst, np.abs(got - ds).max() / scale)
    return worst


def test_material_cbox_value_and_grad_matches_jax():
    """BASELINE.json config 2's acceptance at test size: value_and_grad of
    mean(img^2) under PathTracer(3) on the cbox with a textured floor and a
    rough-conductor back wall, every params leaf (roughness, eta, k, the
    specular reflectance, texels, vertices, transforms, radiance) against
    the JAX package's forward-mode derivative: loss to 1e-5, leaves to 1e-2
    (measured worst: 7.4e-5), every leaf finite."""
    js, ts = _material_cbox(J), _material_cbox(T, **CPU)
    j_loss, ref = jvp_reference(js, J.PathTracer(3), 3, False)
    p = params_from_numpy(js.params(), **CPU, requires_grad=True)
    img = T.PathTracer(3).render_fn(ts, with_boundary=False)(
        p, threefry.PRNGKey(3))
    loss = torch.mean(img ** 2)
    loss.backward()
    assert abs(loss.item() - j_loss) <= 1e-5 * j_loss
    worst = assert_matches_jvp_reference(ref, p)
    metal = p["bsdfs"][2]
    for k in ("alpha_u", "alpha_v", "eta", "k", "specular_reflectance"):
        assert metal[k].grad.abs().sum() > 0, k
    assert p["bsdfs"][1]["reflectance"].grad.abs().sum() > 0
    assert worst < 1e-2


def test_material_cbox_renderC_matches_jax():
    js, ts = _material_cbox(J, 16, 16), _material_cbox(T, 16, 16, **CPU)
    want = np.asarray(jax.jit(J.PathTracer(3).render_fn(
        js, with_boundary=False, detached=True))(js.params(),
                                                 jax.random.PRNGKey(4)))
    got = _np(T.PathTracer(3).render_fn(ts, with_boundary=False,
                                        detached=True)(
        params_from_numpy(js.params(), **CPU), threefry.PRNGKey(4)))
    _assert_images_match(got, want)


def test_params_from_numpy_takes_the_new_leaves():
    """Texture data, alpha_u/v, eta, k, specular_reflectance, the envmap's
    radiance, scale and to_world cross as float32 leaves of their shapes."""
    js = _material_cbox(J)
    js.add_emitter(J.EnvironmentMap(t_scenes.gradient_sky(), scale=2.0))
    p = params_from_numpy(js.params(), **CPU, requires_grad=True)
    assert p["bsdfs"][1]["reflectance"].shape == (6, 6, 3)
    assert p["bsdfs"][2]["alpha_u"].shape == (1, 1, 1)
    assert p["bsdfs"][2]["eta"].shape == p["bsdfs"][2]["k"].shape == (1, 1, 3)
    env = p["emitters"][1]
    assert env["radiance"].shape == (16, 32, 3)
    assert env["scale"].shape == () and env["scale"].item() == 2.0
    assert env["to_world"].shape == (4, 4)
    leaves = [x for d in p["bsdfs"] + p["emitters"] for x in d.values()]
    assert all(x.dtype == torch.float32 and x.requires_grad and x.is_leaf
               for x in leaves)
