"""The port's environment map against the JAX package's on the CPU: the
host-side mass grid and frozen cmf bit for bit, ``configure_envmap`` on its
three grids and under its two opt-in tables (the alias table and the
hierarchical warp: host builds bit for bit, samplers lane by lane, renders
per pixel, gradients per leaf), the four direction and position functions lane by lane on the
JAX package's importance table (``convert.envmap_state_from_numpy``: XLA's
scan and torch's cumsum differ in the last place, and a sample between the
two values picks another cell), ``Scene.build``'s bounding mesh, ``renderC``
per pixel for four estimators on ``env_scene`` with a diffuse and a
rough-conductor sphere, and ``value_and_grad`` per leaf: the rotation of
the map, its texels and scale, interior and with the boundary terms.

``atan2``, ``acos``, ``sin`` and ``cos`` round differently in XLA and in
torch, so a direction within a last place of a texel's or a cell's border
may read the neighbour: lane-by-lane cases state the share of lanes that
must agree.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import psdr_tpu as J
import psdr_tpu_torch as T
from psdr_tpu.emitter import envmap as j_env
from psdr_tpu_torch.convert import envmap_state_from_numpy, params_from_numpy
from psdr_tpu.core import distribution as j_dist
from psdr_tpu_torch.core import distribution as t_dist
from psdr_tpu_torch.core import threefry
from psdr_tpu_torch.core import transform as t_xf
from psdr_tpu_torch.emitter import envmap as t_env
from psdr_tpu_torch.testing import scenes as t_scenes

from test_envmap import _env_scene as j_env_scene
from test_torch_materials import (_assert_images_match, _np, _t,
                                  assert_matches_jvp_reference,
                                  jvp_reference)

torch.set_num_threads(2)

CPU = dict(device="cpu")     # the port defaults to the card
N = 4096
ENV_KEYS = ("PSDR_TPU_ENV_RESO_DIV", "PSDR_TPU_ENV_FROZEN",
            "PSDR_TPU_ENV_ALIAS", "PSDR_TPU_ENV_HIER")


@pytest.fixture(autouse=True)
def _default_env(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)


def _sky(h, w, seed=0):
    """A seeded sky with a bright spot two texels wide."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.05, 1.0, (h, w, 3)).astype(np.float32)
    img[h // 3:h // 3 + 2, w // 5:w // 5 + 2] = 400.0
    return img


def _rotation():
    return (t_xf.rotate([0.3, 1.0, 0.2], 35.0)).astype(np.float32)


def _pair(bsdf="diffuse", to_world=None, **kw):
    """env_scene in both packages; the port samples the JAX table."""
    mats = {"diffuse": lambda lib: lib.Diffuse([0.7, 0.7, 0.7]),
            "rough": lambda lib: lib.RoughConductor(alpha_u=0.3, alpha_v=0.2)}
    js = j_env_scene(mats[bsdf](J), **{k: v for k, v in kw.items()
                                        if k in ("width", "height", "spp")})
    js.opts = J.RenderOptions(**{**dict(width=24, height=24, spp=8), **kw})
    ts = t_scenes.env_scene(mats[bsdf](T), **kw, **CPU)
    if to_world is not None:
        js.emitters[0].to_world = to_world
        ts.emitters[0].to_world = to_world
    for jm, tm in zip(js.meshes, ts.meshes):
        tm.edge_indices = jm.edge_indices
    jf = js.build(js.params())
    d = jf.envmap.cell_distrb.distrb
    envmap_state_from_numpy(ts, np.asarray(d.pmf), np.asarray(d.cmf))
    return js, ts, jf


# -- host tables ---------------------------------------------------------------------

@pytest.mark.parametrize("h,w,div", [(12, 20, 1), (40, 70, 1), (70, 130, 4)])
def test_host_mass_grid_and_frozen_cmf_bit_for_bit(h, w, div):
    """The float64 numpy build is the JAX package's, copied: equal bit for
    bit on the parity grid and on the max-pooled divided grid."""
    rad = _sky(h, w)
    gw_f, gh_f = 2 * (w - 1), 2 * (h - 1)
    gw, gh = gw_f // div, gh_f // div
    want = j_env._host_mass_grid(rad, gw, gh, gw_f, gh_f)
    got = t_env._host_mass_grid(rad, gw, gh, gw_f, gh_f)
    assert got.dtype == np.float64 and got.shape == (gw * gh,)
    np.testing.assert_array_equal(got, want)
    jd = j_env._frozen_tables(rad, gw, gh, gw_f, gh_f, "cmf")
    td = t_env._frozen_tables(rad, gw, gh, gw_f, gh_f, "cmf")
    np.testing.assert_array_equal(td.pmf, jd.pmf)
    np.testing.assert_array_equal(td.cmf, jd.cmf)
    assert td.total == jd.total and (np.diff(td.cmf) >= 0).all()
    assert t_env._frozen_tables(rad, gw, gh, gw_f, gh_f, "cmf") is td
    if div > 1:
        assert (got > 0).all()          # the bright spot is in no empty cell


@pytest.mark.parametrize("grid", ["parity", "frozen", "divided",
                                  "frozen divided"])
def test_configure_envmap_grids_match_jax(grid, monkeypatch):
    """The three grids: the reference-parity grid built in the render (a
    16 x 32 sky), the frozen cmf above 2^15 cells (bit for bit), and above
    2^18 cells the divided max-pooled grid, in the render with
    ``PSDR_TPU_ENV_FROZEN=0`` and frozen (bit for bit)."""
    h, w = {"parity": (16, 32), "frozen": (70, 130),
            "divided": (260, 520), "frozen divided": (260, 520)}[grid]
    if grid == "divided":
        monkeypatch.setenv("PSDR_TPU_ENV_FROZEN", "0")
    rad = _sky(h, w, seed=1)
    p = {"radiance": rad, "scale": np.float32(1.5), "to_world": _rotation()}
    lower, upper = np.float32([-1, -1, -1]), np.float32([1, 2, 1])
    jst = j_env.configure_envmap({k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(lower), jnp.asarray(upper),
                                 host_radiance=rad)
    tst = t_env.configure_envmap({k: _t(np.asarray(v)) for k, v in p.items()},
                                 _t(lower), _t(upper), host_radiance=rad)
    jh, th = jst.cell_distrb, tst.cell_distrb
    assert th.resolution == tuple(int(r) for r in jh.resolution)
    want_reso = {"parity": (62, 30), "frozen": (258, 138),
                 "divided": (259, 129), "frozen divided": (259, 129)}[grid]
    assert th.resolution == want_reso
    np.testing.assert_allclose(_np(th.unit), np.asarray(jh.unit), rtol=1e-7)
    if "frozen" in grid:
        np.testing.assert_array_equal(_np(th.distrb.pmf),
                                      np.asarray(jh.distrb.pmf))
        np.testing.assert_array_equal(_np(th.distrb.cmf),
                                      np.asarray(jh.distrb.cmf))
        assert th.cells.shape == (0, 2)
    else:
        np.testing.assert_allclose(_np(th.distrb.pmf),
                                   np.asarray(jh.distrb.pmf), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(_np(th.distrb.total),
                                   np.asarray(jh.distrb.total), rtol=1e-5)
    assert (_np(th.distrb.pmf) > 0).all()
    np.testing.assert_allclose(_np(tst.from_world), np.asarray(jst.from_world),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("switch", ["PSDR_TPU_ENV_ALIAS", "PSDR_TPU_ENV_HIER"])
def test_alias_and_hier_switches_raise_by_name(switch, monkeypatch):
    """Where the JAX package takes its alias table or its hierarchical
    warp (a grid above 2^15 cells with a host snapshot), so does the port,
    on the parity grid (a default divisor of 1), bit for bit; on a small
    grid both ignore the switch. Beyond their bounds the host builders
    raise and say which (2^24 alias cells; 4096 hier cells an axis)."""
    monkeypatch.setenv(switch, "1")
    rad = _sky(70, 130)
    p = {"radiance": rad, "scale": np.float32(1.0),
         "to_world": np.eye(4, dtype=np.float32)}
    lower, upper = np.zeros(3, np.float32), np.ones(3, np.float32)
    jst = j_env.configure_envmap({k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(lower), jnp.asarray(upper),
                                 host_radiance=rad)
    tst = t_env.configure_envmap({k: _t(np.asarray(v)) for k, v in p.items()},
                                 _t(lower), _t(upper), host_radiance=rad)
    jh, th = jst.cell_distrb, tst.cell_distrb
    assert th.resolution == tuple(int(r) for r in jh.resolution) == (258, 138)
    assert th.distrb is None and th.cells.shape == (0, 2)
    assert th.num_cells == jh.num_cells == 258 * 138
    name = "alias" if switch.endswith("ALIAS") else "hier"
    jt, tt = getattr(jh, name), getattr(th, name)
    assert getattr(th, {"alias": "hier", "hier": "alias"}[name]) is None
    for f in jt._fields:
        a, b = getattr(jt, f), getattr(tt, f)
        for x, y in (zip(a, b) if f == "levels" else [(a, b)]):
            assert _np(y).tobytes() == np.asarray(x).tobytes(), f
    small = dict(p, radiance=_t(_sky(16, 32)), scale=torch.tensor(1.0),
                 to_world=torch.eye(4))
    st = t_env.configure_envmap(small, torch.zeros(3), torch.ones(3),
                                host_radiance=_sky(16, 32))
    assert st.cell_distrb.resolution == (62, 30)
    assert st.cell_distrb.alias is None and st.cell_distrb.hier is None
    with pytest.raises(ValueError, match="4096 cells per axis"):
        t_env.hier2d_host(np.ones(8200 * 2), 8200, 2)
    with pytest.raises(ValueError, match="2\\^24 cells"):
        t_dist.alias_sample_reuse(t_dist.AliasTable(
            packed=None, pmf=np.zeros(1 << 24), total=1.0), torch.zeros(1))


# -- the build --------------------------------------------------------------------

def test_scene_build_with_envmap_matches_jax():
    """The enlarged box, the 12 bounding faces (bsdf_id -1, the envmap's
    emitter id) at the end of the face table, their place in the
    emitter-first index set, the sampling weights."""
    js, ts, jf = _pair(to_world=_rotation())
    tf = ts.build(params_from_numpy(js.params(), **CPU))
    assert ts.envmap_index == js.envmap_index == 0
    np.testing.assert_allclose(tf.face_table.numpy(),
                               np.asarray(jf.face_table), rtol=1e-5, atol=1e-6)
    assert (tf.bsdf_id[-12:] == -1).all() and (tf.emitter_id[-12:] == 0).all()
    assert (tf.mesh_id[-12:] == 1).all() and tf.face_normal_mask[-12:].all()
    np.testing.assert_array_equal(tf.em_tri_idx.numpy(),
                                  np.asarray(jf.em_tri_idx))
    for f in ("emitter_radiance", "emitter_weight", "emitter_inv_area",
              "lower", "upper"):
        np.testing.assert_allclose(getattr(tf, f).numpy(),
                                   np.asarray(getattr(jf, f)), rtol=1e-6)
    np.testing.assert_array_equal(tf.envmap.cell_distrb.distrb.cmf.numpy(),
                                  np.asarray(jf.envmap.cell_distrb.distrb.cmf))
    with pytest.raises(ValueError, match="cells"):
        envmap_state_from_numpy(ts, np.ones(7, np.float32))
        ts.build(ts.params())


# -- direction and position functions, lane by lane ----------------------------------

def _states(to_world):
    js, ts, jf = _pair(to_world=to_world)
    tf = ts.build(params_from_numpy(js.params(), **CPU))
    return jf.envmap, tf.envmap


def _unit(rng, n):
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = d.astype(np.float32)
    d[:6] = [[0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1], [1, 0, 0],
             [-1, 0, 0]]
    return d


@pytest.mark.parametrize("rotated", [False, True])
def test_envmap_eval_direction_matches_jax(rotated):
    """4,096 directions, the poles and the axes among them: at least 99.5%
    of lanes within rtol 1e-5, atol 1e-6 (measured: all but <= 3, which
    read the neighbouring texel across the wrap or a texel border)."""
    jst, tst = _states(_rotation() if rotated else None)
    rng = np.random.default_rng(2)
    d = _unit(rng, N)
    act = rng.uniform(size=N) > 0.1
    want = np.asarray(j_env.envmap_eval_direction(jst, jnp.asarray(d),
                                                  jnp.asarray(act)))
    got = _np(t_env.envmap_eval_direction(tst, _t(d), _t(act)))
    assert np.isfinite(got).all() and (got[~act] == 0).all()
    close = np.isclose(got, want, rtol=1e-5, atol=1e-6).all(-1)
    assert close.mean() >= 0.995, close.mean()
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=1e-4)


@pytest.mark.parametrize("rotated", [False, True])
def test_envmap_sampling_matches_jax(rotated):
    """envmap_sample_direction and envmap_sample_position on 4,096
    samples with the JAX cmf carried across: every lane picks the same
    cell, so directions agree to 2e-6 absolute and pdfs to rtol 1e-5 on at
    least 99.5% of lanes (1 / sin theta near a pole amplifies the last
    place), the position sample's point, normal and pdf likewise."""
    jst, tst = _states(_rotation() if rotated else None)
    rng = np.random.default_rng(3)
    u = rng.uniform(size=(N, 2)).astype(np.float32)
    ref_p = rng.uniform(-0.8, 0.8, (N, 3)).astype(np.float32)
    act = rng.uniform(size=N) > 0.1
    jd, jpdf = j_env.envmap_sample_direction(jst, jnp.asarray(u))
    td, tpdf = t_env.envmap_sample_direction(tst, _t(u))
    np.testing.assert_allclose(_np(td), np.asarray(jd), rtol=0, atol=2e-6)
    close = np.isclose(_np(tpdf), np.asarray(jpdf), rtol=1e-5, atol=1e-7)
    assert close.mean() >= 0.995, close.mean()
    np.testing.assert_allclose(_np(tpdf), np.asarray(jpdf), rtol=1e-3)

    jps = j_env.envmap_sample_position(jst, jnp.asarray(ref_p),
                                       jnp.asarray(u), jnp.asarray(act))
    tps = t_env.envmap_sample_position(tst, _t(ref_p), _t(u), _t(act))
    np.testing.assert_array_equal(_np(tps.valid), np.asarray(jps.valid))
    same_face = (_np(tps.n) == np.asarray(jps.n)).all(-1)
    assert same_face.mean() >= 0.999
    np.testing.assert_allclose(_np(tps.p)[same_face],
                               np.asarray(jps.p)[same_face], rtol=1e-5,
                               atol=1e-5)
    close = np.isclose(_np(tps.pdf), np.asarray(jps.pdf), rtol=2e-5,
                       atol=1e-8)
    assert close[same_face].mean() >= 0.995
    assert (_np(tps.emitter) == -1).all() and (_np(tps.J) == 1).all()


@pytest.mark.parametrize("rotated", [False, True])
def test_envmap_position_pdf_matches_jax(rotated):
    """The area pdf of bounding-box hits: at least 99.5% of lanes within
    rtol 2e-5 (the rest read a neighbouring cell), and equal to the pdf
    the sampler reports for the same point."""
    jst, tst = _states(_rotation() if rotated else None)
    rng = np.random.default_rng(4)
    u = rng.uniform(size=(N, 2)).astype(np.float32)
    ref_p = rng.uniform(-0.8, 0.8, (N, 3)).astype(np.float32)
    act = np.ones(N, bool)
    tps = t_env.envmap_sample_position(tst, _t(ref_p), _t(u), _t(act))
    p, n = _np(tps.p), _np(tps.n)
    want = np.asarray(j_env.envmap_position_pdf(
        jst, *map(jnp.asarray, (ref_p, p, n, act))))
    got = _np(t_env.envmap_position_pdf(tst, _t(ref_p), tps.p, tps.n,
                                        _t(act)))
    assert np.isfinite(got).all()
    close = np.isclose(got, want, rtol=2e-5, atol=1e-8)
    assert close.mean() >= 0.995, close.mean()
    # sampler and pdf agree, except where the point falls in another cell
    # than the sampled one (a cell border) or near a pole
    agree = np.isclose(got, _np(tps.pdf), rtol=1e-3)
    assert agree.mean() >= 0.97, agree.mean()


def test_envmap_functions_are_detached_where_jax_stops_gradients():
    """envmap_sample_position and envmap_position_pdf carry neither a graph
    nor a forward-mode tangent; envmap_eval_direction carries both, finite
    at the poles and on the +-z axis, to the texels, the scale and the
    rotation."""
    _, tst = _states(_rotation())
    rng = np.random.default_rng(5)
    u, ref_p = _t(rng.uniform(size=(64, 2)).astype(np.float32)), torch.zeros(64, 3)
    act = torch.ones(64, dtype=torch.bool)
    with fwAD.dual_level():
        tw = fwAD.make_dual(tst.to_world, torch.ones(4, 4))
        dual = tst._replace(to_world=tw, from_world=torch.linalg.inv(tw))
        ref = fwAD.make_dual(ref_p, torch.ones(64, 3))
        ps = t_env.envmap_sample_position(dual, ref, u, act)
        pdf = t_env.envmap_position_pdf(dual, ref, ps.p + 0.0 * ref, ps.n, act)
        for x in (ps.p, ps.n, ps.pdf, pdf):
            assert fwAD.unpack_dual(x).tangent is None
        val = t_env.envmap_eval_direction(dual, _t(_unit(rng, 64)), act)
        tan = fwAD.unpack_dual(val).tangent
        assert tan is not None and torch.isfinite(tan).all()
    leaves = {k: getattr(tst, k).clone().requires_grad_()
              for k in ("data", "scale", "to_world")}
    st = tst._replace(**leaves,
                      from_world=torch.linalg.inv(leaves["to_world"]))
    ps = t_env.envmap_sample_position(st, ref_p, u, act)
    assert not ps.p.requires_grad and not ps.pdf.requires_grad
    assert not t_env.envmap_position_pdf(st, ref_p, ps.p, ps.n,
                                         act).requires_grad
    t_env.envmap_eval_direction(st, _t(_unit(rng, 64)), act).sum().backward()
    for k, x in leaves.items():
        assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0, k


# -- renderC per pixel ---------------------------------------------------------------

INTEGRATORS = {
    "direct(1,1)": (lambda lib: lib.DirectIntegrator(1, 1)),
    "direct(2,0)": (lambda lib: lib.DirectIntegrator(2, 0)),
    "direct(0,2)": (lambda lib: lib.DirectIntegrator(0, 2)),
    "path(3)": (lambda lib: lib.PathTracer(3)),
}


@pytest.mark.parametrize("bsdf", ["diffuse", "rough"])
@pytest.mark.parametrize("integ", list(INTEGRATORS))
def test_env_scene_renderC_matches_jax(integ, bsdf):
    """renderC semantics on env_scene (a sphere under the 16 x 32 gradient
    sky, 24 x 24 at spp 8, the map rotated), light-sampling only,
    BSDF-sampling only, MIS, and three bounces: at least 99% of pixels
    allclose (rtol 1e-4, atol 1e-5), means to 1e-4; the background pixels
    see the map. On the rough conductor the lanes at the sphere's
    silhouette divide by a cosine that is itself a rounded difference, so
    last-place differences grow: there at least 97% of pixels at rtol 1e-4
    (measured 98.3% light-sampling only) and 99% at rtol 2e-3."""
    js, ts, _ = _pair(bsdf, to_world=_rotation())
    make = INTEGRATORS[integ]
    want = np.asarray(jax.jit(make(J).render_fn(
        js, with_boundary=False, detached=True))(js.params(),
                                                 jax.random.PRNGKey(6)))
    got = _np(make(T).render_fn(ts, with_boundary=False, detached=True)(
        params_from_numpy(js.params(), **CPU), threefry.PRNGKey(6)))
    if bsdf == "rough":
        assert np.isfinite(got).all()
        for rtol, share in ((1e-4, 0.97), (2e-3, 0.99)):
            close = np.isclose(got, want, rtol=rtol, atol=1e-5).all(-1)
            assert close.mean() >= share, (rtol, close.mean())
        assert abs(got.mean() - want.mean()) <= 1e-4 * want.mean()
    else:
        _assert_images_match(got, want)
    assert got[0].sum() > 0.0


# -- value_and_grad per leaf ------------------------------------------------------

def _port_grad(ts, params_np, integ, seed, with_boundary):
    p = params_from_numpy(params_np, **CPU, requires_grad=True)
    img = integ.render_fn(ts, with_boundary=with_boundary)(
        p, threefry.PRNGKey(seed))
    loss = torch.mean(img ** 2)
    loss.backward()
    return loss.item(), p


@pytest.mark.parametrize("case", ["interior direct", "interior path",
                                  "boundary direct", "boundary path"])
def test_env_value_and_grad_matches_jax(case):
    """value_and_grad of mean(img^2) on the diffuse env_scene with the map
    rotated, 16 x 16 at spp 4, per leaf: the envmap's ``to_world``, texels
    and scale, the sphere's vertices and transform, the camera; interior,
    and with sppe 2 and sppse 8 (the boundary passes draw their emitter
    points from the map). The reference is the JAX package's forward-mode
    derivative (``jvp_reference``): its reverse mode returns NaN for the
    envmap's and the camera's ``to_world`` on this scene and agrees with
    the port on the other leaves (measured 1.1e-5 worst). Loss to 1e-5,
    every leaf within 1e-2, every leaf finite."""
    boundary = case.startswith("boundary")
    kw = dict(width=16, height=16, spp=4)
    if boundary:
        kw.update(sppe=2, sppse=8)
    js, ts, _ = _pair(to_world=_rotation(), **kw)
    ji, ti = ((J.DirectIntegrator(1, 1), T.DirectIntegrator(1, 1))
              if case.endswith("direct")
              else (J.PathTracer(2), T.PathTracer(2)))
    j_loss, ref = jvp_reference(js, ji, 3, boundary)
    t_loss, p = _port_grad(ts, js.params(), ti, 3, boundary)
    assert abs(t_loss - j_loss) <= 1e-5 * j_loss
    assert assert_matches_jvp_reference(ref, p) < 1e-2
    env = p["emitters"][0]
    for k in ("radiance", "scale", "to_world"):
        assert env[k].grad.abs().sum() > 0, k


def test_rough_env_value_and_grad_matches_jax_forward_mode():
    """The rough-conductor sphere under the rotated map, PathTracer(2),
    with the boundary terms on: every leaf (roughness, eta, k, rotation,
    texels) against the JAX package's forward-mode derivative
    (``jvp_reference``; its reverse mode is NaN here), 1e-2 per leaf, every
    leaf finite."""
    kw = dict(width=12, height=12, spp=4, sppe=2, sppse=8)
    js, ts, _ = _pair("rough", to_world=_rotation(), **kw)
    j_loss, ref = jvp_reference(js, J.PathTracer(2), 3, True)
    t_loss, p = _port_grad(ts, js.params(), T.PathTracer(2), 3, True)
    assert abs(t_loss - j_loss) <= 1e-5 * j_loss
    assert assert_matches_jvp_reference(ref, p) < 1e-2
    for k in ("alpha_u", "alpha_v", "eta", "k"):
        assert p["bsdfs"][0][k].grad.abs().sum() > 0, k


@pytest.mark.parametrize("bsdf", ["diffuse", "rough"])
def test_env_rotation_forward_mode_equals_reverse_mode(bsdf):
    """d image / d (rotation angle of the map) by forward mode
    (``torch.autograd.forward_ad``) is finite on every pixel and equals
    the reverse-mode derivative of a random projection of the image, under
    a diffuse and under a rough-conductor sphere."""
    _, ts, _ = _pair(bsdf, width=12, height=12, spp=4)
    base = params_from_numpy(ts.params(), **CPU)
    axis = torch.tensor([0.0, 1.0, 0.0])
    K = torch.tensor([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
    w = _t(np.random.default_rng(7).normal(size=(144, 3)).astype(np.float32))
    render = T.DirectIntegrator(1, 1).render_fn(ts, with_boundary=False)

    def image(angle):
        rot = torch.eye(3) + torch.sin(angle) * K + (1 - torch.cos(angle)) * K @ K
        m = torch.eye(4).clone()
        m = torch.cat([torch.cat([rot, torch.zeros(3, 1)], 1),
                       torch.tensor([[0.0, 0.0, 0.0, 1.0]])], 0)
        p = {**base, "emitters": [dict(base["emitters"][0], to_world=m)]}
        return render(p, threefry.PRNGKey(1))

    with fwAD.dual_level():
        img = image(fwAD.make_dual(torch.tensor(0.3), torch.tensor(1.0)))
        tan = fwAD.unpack_dual(img).tangent
    assert torch.isfinite(tan).all() and tan.abs().max() > 0
    a = torch.tensor(0.3, requires_grad=True)
    (image(a) * w).sum().backward()
    np.testing.assert_allclose(a.grad.item(), (tan * w).sum().item(),
                               rtol=1e-3)


# -- the opt-in tables: PSDR_TPU_ENV_ALIAS=1, PSDR_TPU_ENV_HIER=1 --------------------

def _masses(n, seed):
    """Cell masses with zero runs, a spike and a spread of magnitudes."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(0.0, 1.0, n) ** 3
    m[rng.uniform(size=n) < 0.2] = 0.0
    m[n // 3] = 500.0
    return m


@pytest.mark.parametrize("gw,gh", [(40, 30), (258, 138), (398, 198)])
def test_alias_and_hier_host_tables_bit_for_bit(gw, gh):
    """``alias_table_host`` and ``hier2d_host`` are the JAX package's
    float64 numpy builds, copied: equal bit for bit, the all-zero mass's
    uniform fallback included."""
    for mass in (_masses(gw * gh, gw), np.zeros(gw * gh)):
        ja, ta = j_dist.alias_table_host(mass), t_dist.alias_table_host(mass)
        for f in ja._fields:
            assert (np.asarray(getattr(ta, f)).tobytes()
                    == np.asarray(getattr(ja, f)).tobytes()), f
        jh, th = j_dist.hier2d_host(mass, gw, gh), t_dist.hier2d_host(
            mass, gw, gh)
        assert [t.shape for t in th.levels] == [t.shape for t in jh.levels]
        for a, b in zip(jh.levels, th.levels):
            assert a.tobytes() == b.tobytes()
        assert th.pmf.tobytes() == jh.pmf.tobytes() and th.total == jh.total
    assert t_dist._hier_split_plan(512, 256) == j_dist._hier_split_plan(
        512, 256) == [(8, 8), (8, 8), (8, 4)]


def _on_torch(table):
    return type(table)(*(tuple(_t(x) for x in v) if isinstance(v, tuple)
                         else _t(np.asarray(v)) for v in table))


def _on_jax(table):
    return type(table)(*(tuple(jnp.asarray(x) for x in v)
                         if isinstance(v, tuple) else jnp.asarray(v)
                         for v in table))


def test_alias_sample_reuse_bit_equal():
    """65,536 uniforms (0 and the largest below 1 among them) through a
    398 x 198 alias table: index, pdf and remapped uniform equal to the JAX
    sampler's bit for bit on every lane; hypercube_pdf too."""
    mass = _masses(398 * 198, 1)
    at = j_dist.alias_table_host(mass)
    rng = np.random.default_rng(6)
    u = rng.uniform(size=1 << 16).astype(np.float32)
    u[:2] = [0.0, np.nextafter(np.float32(1), np.float32(0))]
    want = j_dist.alias_sample_reuse(_on_jax(at), jnp.asarray(u))
    got = t_dist.alias_sample_reuse(_on_torch(at), _t(u))
    for w, g in zip(want, got):
        assert _np(g).tobytes() == np.asarray(w).tobytes()
    reso = (398, 198)
    jhc = j_dist.HyperCube(distrb=None, cells=jnp.zeros((0, 2), jnp.int32),
                           resolution=jnp.asarray(reso, jnp.int32),
                           unit=1.0 / jnp.asarray(reso, jnp.float32),
                           alias=_on_jax(at))
    thc = t_dist.HyperCube(distrb=None, cells=torch.zeros((0, 2)),
                           resolution=reso,
                           unit=1.0 / torch.tensor(reso, dtype=torch.float32),
                           alias=_on_torch(at))
    s2 = rng.uniform(size=(4096, 2)).astype(np.float32)
    jw, jp = j_dist.hypercube_sample_reuse(jhc, jnp.asarray(s2))
    tw, tp = t_dist.hypercube_sample_reuse(thc, _t(s2))
    np.testing.assert_allclose(_np(tw), np.asarray(jw), rtol=0, atol=1e-7)
    assert _np(tp).tobytes() == np.asarray(jp).tobytes()
    np.testing.assert_array_equal(_np(t_dist.hypercube_pdf(thc, tw)),
                                  np.asarray(j_dist.hypercube_pdf(jhc, jw)))


@pytest.mark.parametrize("gw,gh", [(258, 138), (398, 198), (1022, 510),
                                   (4000, 2000)])
def test_hier2d_sample_reuse_lane_by_lane(gw, gh):
    """65,536 sample pairs through the hierarchical warp against the JAX
    sampler. Should a row's sums round apart from XLA's, a pair within a
    last place of a bin border would land one cell over: at most 1 in 2,000
    lanes may pick another cell (measured: none, on every grid here, since
    ``_invcdf_small`` adds its running sum left to right as XLA does; with
    torch.cumsum 1 of 65,536 at 4000 x 2000 and the in-cell point off by up
    to 0.09 of a cell). On the others the warped point and the cell pdf are
    equal bit for bit; hypercube_pdf at the port's points is the port's
    sampled pdf."""
    h = j_dist.hier2d_host(_masses(gw * gh, 2), gw, gh)
    rng = np.random.default_rng(7)
    s = rng.uniform(size=(1 << 16, 2)).astype(np.float32)
    jw, jp = map(np.asarray, j_dist.hier2d_sample_reuse(
        _on_jax(h), jnp.asarray(s), (gw, gh)))
    tw, tp = map(_np, t_dist.hier2d_sample_reuse(_on_torch(h), _t(s),
                                                 (gw, gh)))
    reso = np.array([gw, gh])
    jc, tc = np.floor(jw * reso), np.floor(tw * reso)
    same = (jc == tc).all(-1)
    assert (~same).sum() <= len(s) // 2000, (~same).sum()
    assert tp[same].tobytes() == jp[same].tobytes()
    assert tw[same].tobytes() == jw[same].tobytes()
    hc = t_dist.HyperCube(distrb=None, cells=torch.zeros((0, 2)),
                          resolution=(gw, gh),
                          unit=1.0 / torch.tensor((gw, gh),
                                                  dtype=torch.float32),
                          hier=_on_torch(h))
    np.testing.assert_array_equal(
        _np(t_dist.hypercube_pdf(hc, _t(tw))), tp * np.float32(gw * gh))
    assert (tp > 0).all()


def _big_sky_pair(switch, monkeypatch, bsdf="diffuse", **kw):
    """env_scene in both packages under a 100 x 200 sky (a 398 x 198 grid,
    above 2^15 cells) with the map rotated and ``switch`` on. Both build
    the same host table, so nothing is carried across."""
    monkeypatch.setenv(switch, "1")
    mats = {"diffuse": lambda lib: lib.Diffuse([0.7, 0.7, 0.7]),
            "rough": lambda lib: lib.RoughConductor(alpha_u=0.3, alpha_v=0.2)}
    js = j_env_scene(mats[bsdf](J))
    js.opts = J.RenderOptions(**{**dict(width=24, height=24, spp=8), **kw})
    ts = t_scenes.env_scene(mats[bsdf](T), **kw, **CPU)
    sky = _sky(100, 200, seed=3)
    for sc in (js, ts):
        sc.emitters[0].set_params(dict(sc.emitters[0].params(), radiance=sky,
                                       to_world=_rotation()))
    for jm, tm in zip(js.meshes, ts.meshes):
        tm.edge_indices = jm.edge_indices
    name = "alias" if switch.endswith("ALIAS") else "hier"
    tf = ts.build(params_from_numpy(ts.params(), **CPU))
    assert getattr(tf.envmap.cell_distrb, name) is not None
    assert tf.envmap.cell_distrb.resolution == (398, 198)
    return js, ts


@pytest.mark.parametrize("integ", ["direct(1,1)", "direct(0,2)", "path(3)"])
@pytest.mark.parametrize("switch", ["PSDR_TPU_ENV_ALIAS", "PSDR_TPU_ENV_HIER"])
def test_env_opt_in_renderC_matches_jax(switch, integ, monkeypatch):
    """renderC of env_scene under each switch, MIS, light sampling only and
    three bounces: at least 99% of pixels allclose (rtol 1e-4, atol 1e-5),
    means to 1e-4."""
    js, ts = _big_sky_pair(switch, monkeypatch)
    make = INTEGRATORS[integ]
    want = np.asarray(jax.jit(make(J).render_fn(
        js, with_boundary=False, detached=True))(js.params(),
                                                 jax.random.PRNGKey(6)))
    got = _np(make(T).render_fn(ts, with_boundary=False, detached=True)(
        params_from_numpy(js.params(), **CPU), threefry.PRNGKey(6)))
    _assert_images_match(got, want)


@pytest.mark.parametrize("switch", ["PSDR_TPU_ENV_ALIAS", "PSDR_TPU_ENV_HIER"])
def test_env_opt_in_value_and_grad_matches_jax_forward_mode(switch,
                                                            monkeypatch):
    """value_and_grad of mean(img^2) under each switch, PathTracer(2) with
    the boundary terms (their emitter points come from the table), 12 x 12
    at spp 4, against the JAX package's forward-mode derivative per leaf
    (``jvp_reference``): loss to 1e-5, every leaf within 1e-2 and finite,
    the map's texels and rotation among them."""
    kw = dict(width=12, height=12, spp=4, sppe=2, sppse=8)
    js, ts = _big_sky_pair(switch, monkeypatch, **kw)
    j_loss, ref = jvp_reference(js, J.PathTracer(2), 3, True)
    t_loss, p = _port_grad(ts, js.params(), T.PathTracer(2), 3, True)
    assert abs(t_loss - j_loss) <= 1e-5 * j_loss
    assert assert_matches_jvp_reference(ref, p) < 1e-2
    for k in ("radiance", "to_world"):
        assert p["emitters"][0][k].grad.abs().sum() > 0, k
