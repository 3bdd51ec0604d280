"""The port's backward against the JAX package's: value_and_grad of the L2
loss mean(img^2) through Scene.build and render_interior
(render_fn(with_boundary=False, detached=False)), leaf by leaf. Both
packages get the same parameters (params_from_numpy) and PRNGKey(seed);
their uniforms are bit-equal, so lanes agree to float rounding.

Tolerances: the loss within 1e-5 relative; on cbox every leaf within 1e-2
relative L2 error and cosine >= 0.999 (a lane that crosses a discrete test,
a triangle edge or the side gate, may differ between XLA-CPU and torch-CPU
rounding); on the smooth floor-light scene 1e-4 relative L2. A leaf whose
reference gradient is zero must be zero in the port too. Every leaf is
finite."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from psdr_tpu import DirectIntegrator as JDirect
from psdr_tpu.accel.bruteforce import HitRecord as JHit
from psdr_tpu.core import gather as j_gather
from psdr_tpu.core import math as j_math
from psdr_tpu.core.records import Ray as JRay
from psdr_tpu.scene.scene import ray_intersect as j_ray_intersect
from psdr_tpu_torch import DirectIntegrator as TDirect
from psdr_tpu_torch import RenderOptions as TOpts
from psdr_tpu_torch.accel.bruteforce import HitRecord
from psdr_tpu_torch.convert import params_from_numpy
from psdr_tpu_torch.core import gather as t_gather
from psdr_tpu_torch.core import math as t_math
from psdr_tpu_torch.core import threefry
from psdr_tpu_torch.core.records import Ray
from psdr_tpu_torch.scene.scene import ray_intersect
from psdr_tpu_torch.testing import scenes as t_scenes

from scenes import cbox_scene as j_cbox
from test_gradients import _floor_light_scene as j_floor_light

torch.set_num_threads(2)

CBOX = dict(width=32, height=32, spp=4, occluder_subdiv=3)
CPU = dict(device="cpu")     # the port defaults to the card


def _leaves(tree):
    """Leaves in jax.tree.leaves order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _jax_value_and_grad(js, integ, seed, opts=None):
    if opts is not None:
        js.opts = opts
    render = integ.render_fn(js, with_boundary=False)

    def loss(p):
        return jnp.mean(render(p, jax.random.PRNGKey(seed)) ** 2)

    value, grad = jax.jit(jax.value_and_grad(loss))(js.params())
    return float(value), [np.asarray(g).ravel() for g in jax.tree.leaves(grad)]


def _port_value_and_grad(ts, integ, params_np, seed):
    p = params_from_numpy(params_np, **CPU, requires_grad=True)
    img = integ.render_fn(ts, with_boundary=False)(p, threefry.PRNGKey(seed))
    loss = torch.mean(img ** 2)
    loss.backward()
    grads = [np.zeros(x.numel(), np.float32) if x.grad is None
             else x.grad.numpy().ravel() for x in _leaves(p)]
    return float(loss), grads


def _assert_grads_match(ref, port, rel_l2, min_cos=None):
    assert len(ref) == len(port)
    for i, (a, g) in enumerate(zip(ref, port)):
        assert np.isfinite(g).all(), f"leaf {i} not finite"
        na = np.linalg.norm(a)
        err = np.linalg.norm(g - a)
        assert err <= rel_l2 * na, (i, err, na)
        if min_cos is not None and na > 0:
            cos = float(g @ a) / (np.linalg.norm(g) * na)
            assert cos >= min_cos, (i, cos)


@pytest.mark.parametrize("reuse", ["off", "edge"])
def test_value_and_grad_matches_jax_cbox(reuse, monkeypatch):
    """1,292 triangles, so K1's plain version and the emitter-first sweep
    (K2's plain version) run; every params leaf: mesh vertex_positions and
    to_world, reflectance, radiance, sensor to_world."""
    monkeypatch.setenv("PSDR_TPU_VIS_REUSE", reuse)
    monkeypatch.delenv("PSDR_TPU_VIS_REUSE_Q", raising=False)
    js = j_cbox(**CBOX)
    j_loss, j_grads = _jax_value_and_grad(js, JDirect(1, 1), seed=3)
    t_loss, t_grads = _port_value_and_grad(
        t_scenes.cbox_scene(**CBOX, **CPU), TDirect(1, 1), js.params(), seed=3)
    assert abs(t_loss - j_loss) <= 1e-5 * j_loss
    assert sum(np.linalg.norm(a) > 0 for a in j_grads) >= 15
    _assert_grads_match(j_grads, t_grads, rel_l2=1e-2, min_cos=0.999)


def test_value_and_grad_matches_jax_floor_light():
    """The smooth scene (4 triangles: brute force, K2's plain version)."""
    js = j_floor_light(width=16, height=16, spp=16)
    j_loss, j_grads = _jax_value_and_grad(js, JDirect(1, 1), seed=1)
    t_loss, t_grads = _port_value_and_grad(
        t_scenes.floor_light_scene(16, 16, 16, **CPU), TDirect(1, 1),
        js.params(), seed=1)
    assert abs(t_loss - j_loss) <= 1e-5 * j_loss
    _assert_grads_match(j_grads, t_grads, rel_l2=1e-4)


def test_unaligned_chunks_and_remat_match_jax():
    """pass_lanes not a multiple of spp takes the index_add accumulation
    path (no visibility reuse there); remat_passes=True checkpoints every
    chunk and must give the same loss and gradients bit for bit."""
    js = j_cbox(width=16, height=16, spp=4, occluder_subdiv=1)
    opts = js.opts.__class__(width=16, height=16, spp=4, pass_lanes=1000)
    j_loss, j_grads = _jax_value_and_grad(js, JDirect(1, 1), 2, opts)
    ts = t_scenes.cbox_scene(width=16, height=16, spp=4, occluder_subdiv=1,
                             **CPU)
    results = []
    for remat in (False, True):
        ts.opts = TOpts(width=16, height=16, spp=4, pass_lanes=1000,
                        remat_passes=remat)
        results.append(_port_value_and_grad(ts, TDirect(1, 1), js.params(),
                                            seed=2))
    (t_loss, t_grads), (r_loss, r_grads) = results
    assert abs(t_loss - j_loss) <= 1e-5 * j_loss
    _assert_grads_match(j_grads, t_grads, rel_l2=1e-2, min_cos=0.999)
    assert r_loss == t_loss
    for a, b in zip(t_grads, r_grads):
        np.testing.assert_array_equal(a, b)


def test_camera_prior_is_exact():
    """The camera-hit prior bounds the camera query and changes nothing:
    the same image and gradients as without it (pixel-aligned chunks,
    several of them)."""
    out = []
    for prior in (False, True):
        ts = t_scenes.cbox_scene(width=16, height=16, spp=4,
                                 occluder_subdiv=3, **CPU)
        ts.opts = TOpts(width=16, height=16, spp=4, pass_lanes=256,
                        camera_hit_prior=prior)
        out.append(_port_value_and_grad(ts, TDirect(1, 1), ts.params(),
                                        seed=4))
    (l0, g0), (l1, g1) = out
    assert l0 == l1
    for a, b in zip(g0, g1):
        np.testing.assert_array_equal(a, b)


def test_renderD_matches_renderC():
    """renderD is the primal of the differentiable render: the recompute
    path reproduces the detached render to float rounding."""
    ts = t_scenes.cbox_scene(width=16, height=16, spp=4, occluder_subdiv=3,
                             **CPU)
    integ = TDirect(1, 1)
    d = integ.renderD(ts, seed=5).detach().numpy()
    c = integ.renderC(ts, seed=5).numpy()
    assert d.shape == c.shape == (16, 16, 3) and np.isfinite(d).all()
    close = np.isclose(d, c, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99
    assert abs(d.mean() - c.mean()) <= 1e-4 * c.mean()


def test_ad_matches_fd_pin_2e4():
    """Port of tests/test_gradients.py::test_north_star_gradient_pin_1e4:
    forward-mode AD (torch.autograd.forward_ad, through the Functions'
    jvp) of the image in a light translation against central finite
    differences with common random numbers; relative error < 2e-4."""
    sc = t_scenes.floor_light_scene(16, 16, 16, **CPU)
    render = TDirect(0, 1).render_fn(sc, with_boundary=False)
    shift = torch.tensor([1.0, 0.0, 0.0])
    key = threefry.PRNGKey(0)

    def f(P):
        p = params_from_numpy(sc.params(), **CPU)
        mp = p["meshes"][1]
        p["meshes"][1] = {"vertex_positions": mp["vertex_positions"]
                          + P * shift, "to_world": mp["to_world"]}
        return render(p, key)

    with fwAD.dual_level():
        ad = fwAD.unpack_dual(f(fwAD.make_dual(torch.tensor(0.0),
                                               torch.tensor(1.0)))).tangent
    eps = 1e-2
    with torch.no_grad():
        fd = (f(torch.tensor(eps)) - f(torch.tensor(-eps))) / (2 * eps)
    rel = float((ad - fd).abs().max() / (fd.abs().max() + 1e-12))
    assert rel < 2e-4, rel
    assert float(ad.abs().max()) > 1e-4


def test_known_hit_recompute_degenerate_lane_grads_finite():
    """Port of the JAX test of the same name: a caller-provided hit marks
    near-coplanar lanes valid; the solid-angle recompute stays finite, so
    the masked lanes' zero cotangents cannot poison any leaf."""
    js = j_cbox(width=8, height=8, spp=1)
    ts = t_scenes.cbox_scene(width=8, height=8, spp=1, **CPU)
    n = 4
    d_np = np.array([[0.0, 0.0, -1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 1e-8],
                     [1e-8, 1.0, 0.0]], np.float32)
    d_np /= np.linalg.norm(d_np, axis=-1, keepdims=True)
    o_np = np.array([[0.0, 0.0, 5.0]] * n, np.float32)

    def j_f(p):
        flat = js.build(p)
        hit = JHit(valid=jnp.ones((n,), bool), tri_id=jnp.zeros((n,), jnp.int32),
                   uv=jnp.zeros((n, 2)), t=jnp.ones((n,)))
        its = j_ray_intersect(flat, JRay(jnp.asarray(o_np), jnp.asarray(d_np)),
                              jnp.ones((n,), bool), hit=hit)
        mask = (its.t < 10.0)[..., None]
        return jnp.sum(jnp.where(mask, its.p, 0.0)) + jnp.sum(
            jnp.where(mask[..., 0], its.t, 0.0))

    p = params_from_numpy(js.params(), **CPU, requires_grad=True)
    flat = ts.build(p)
    hit = HitRecord(valid=torch.ones(n, dtype=torch.bool),
                    tri_id=torch.zeros(n, dtype=torch.int32),
                    uv=torch.zeros(n, 2), t=torch.ones(n))
    its = ray_intersect(flat, Ray(torch.from_numpy(o_np), torch.from_numpy(d_np)),
                        torch.ones(n, dtype=torch.bool), hit=hit)
    mask = (its.t < 10.0)[..., None]
    (torch.where(mask, its.p, 0.0).sum()
     + torch.where(mask[..., 0], its.t, 0.0).sum()).backward()
    grads = [x.grad for x in _leaves(p)]
    assert all(g is None or torch.isfinite(g).all() for g in grads)
    j_grads = jax.tree.leaves(jax.jit(jax.grad(j_f))(js.params()))
    _assert_grads_match([np.asarray(g).ravel() for g in j_grads],
                        [np.zeros(x.numel(), np.float32) if g is None
                         else g.numpy().ravel()
                         for x, g in zip(_leaves(p), grads)], rel_l2=1e-4)


@pytest.mark.parametrize("mode", ["native", "scatter", "sorted", "cumsum"])
def test_gather_rows_matches_jax(mode):
    """Forward, reverse (vjp of a random cotangent, duplicate indices) and
    forward-mode (jvp) of gather_rows and gather_rows_offsets, against the
    JAX package's; rtol 1e-5 (cumsum: 1e-4, float32 prefix sums)."""
    rng = np.random.default_rng(5)
    table = rng.normal(size=(37, 5)).astype(np.float32)
    idx = rng.integers(0, 35, size=(300,)).astype(np.int32)
    ct = rng.normal(size=(300, 5)).astype(np.float32)
    ct2 = rng.normal(size=(300, 5)).astype(np.float32)
    tan = rng.normal(size=(37, 5)).astype(np.float32)
    tol = dict(rtol=1e-4 if mode == "cumsum" else 1e-5, atol=1e-5)

    out_j, vjp_j = jax.vjp(lambda t: j_gather.gather_rows(t, jnp.asarray(idx),
                                                          mode), table)
    _, jvp_j = jax.jvp(lambda t: j_gather.gather_rows(t, jnp.asarray(idx),
                                                      mode), (table,), (tan,))
    offs_j, vjp_oj = jax.vjp(lambda t: j_gather.gather_rows_offsets(
        t, jnp.asarray(idx), (0, 2), mode), table)

    tt = torch.tensor(table, requires_grad=True)
    ti = torch.from_numpy(idx)
    out_t = t_gather.gather_rows(tt, ti, mode)
    np.testing.assert_array_equal(out_t.detach().numpy(), np.asarray(out_j))
    (g_t,) = torch.autograd.grad(out_t, tt, torch.from_numpy(ct))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(vjp_j(ct)[0]), **tol)
    offs_t = t_gather.gather_rows_offsets(tt, ti, (0, 2), mode)
    for a, b in zip(offs_t, offs_j):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    (g_o,) = torch.autograd.grad(offs_t, tt, (torch.from_numpy(ct),
                                              torch.from_numpy(ct2)))
    np.testing.assert_allclose(g_o.numpy(), np.asarray(vjp_oj((ct, ct2))[0]),
                               **tol)
    with fwAD.dual_level():
        dual = fwAD.make_dual(torch.from_numpy(table), torch.from_numpy(tan))
        jvp_t = fwAD.unpack_dual(t_gather.gather_rows(dual, ti, mode)).tangent
    np.testing.assert_array_equal(jvp_t.numpy(), np.asarray(jvp_j))


@pytest.mark.parametrize("name", ["safe_sqrt", "safe_acos"])
def test_safe_math_derivatives_match_jax(name):
    """Values, reverse-mode and forward-mode derivatives at 0, +-1 and
    inside the domain, against the JAX package's custom jvp: finite at 0
    (safe_sqrt) and at the poles (safe_acos); rtol 1e-6."""
    x = np.array([0.0, 1.0, -1.0, 0.25, -0.5, 1e-9], np.float32)
    j_fn, t_fn = getattr(j_math, name), getattr(t_math, name)
    j_val, j_tan = jax.jvp(j_fn, (jnp.asarray(x),), (jnp.ones_like(x),))
    j_grad = jax.grad(lambda v: jnp.sum(j_fn(v)))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    y = t_fn(xt)
    (g,) = torch.autograd.grad(y.sum(), xt)
    with fwAD.dual_level():
        tan = fwAD.unpack_dual(t_fn(fwAD.make_dual(torch.from_numpy(x),
                                                   torch.ones(6)))).tangent
    for got, want in ((y.detach(), j_val), (g, j_grad), (tan, j_tan)):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
