"""The port's optimizer against the JAX package's on the CPU: param_map
addressing, Adam's arithmetic against optax's given the same gradients
(never trajectories element by element: a first step is about lr times the
sign of the gradient), ``Optimizer.step``'s loss and gradients against
``jax.value_and_grad``, a JAX run carried over by
``convert.adam_state_from_numpy``, masked updates and checkpoints, the
accel rebuild (``refit_quality``, ``maybe_rebuild_accel``), the 1D vertex
offset, and the recovery of a sphere's position through the boundary
terms (tests/test_inverse_geometry.py's loop)."""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import psdr_tpu as J
import psdr_tpu_torch as T
from psdr_tpu.opt import Optimizer as JOptimizer
from psdr_tpu.opt import param_mask as j_param_mask
from psdr_tpu.opt import resolve_param_path as j_resolve
from psdr_tpu_torch.convert import adam_state_from_numpy, params_from_numpy
from psdr_tpu_torch.core import threefry
from psdr_tpu_torch.core import transform as xf
from psdr_tpu_torch.opt import (Optimizer, adam_update, leaf_items,
                                param_mask, resolve_param_path)
from psdr_tpu_torch.testing import scenes as t_scenes
from psdr_tpu_torch.testing.differential import translate

from scenes import sphere_light_scene as j_sphere
from test_torch_grad import _assert_grads_match, _leaves

torch.set_num_threads(2)

CPU = dict(device="cpu")     # the port defaults to the card
PATHS = ["BSDF[id=white].reflectance", "Mesh[0].vertex_positions"]


def test_param_addressing_matches_jax():
    js, ts = j_sphere(), t_scenes.sphere_light_scene(**CPU)
    for path in ("BSDF[id=white].reflectance", "Mesh[0].vertex_positions",
                 "Mesh[1]", "Emitter[0].radiance", "Sensor[0].to_world",
                 "BSDF[id=grey]"):
        assert resolve_param_path(ts, path) == j_resolve(js, path)
    assert resolve_param_path(ts, "Mesh[1]") == ("meshes", 1, None)
    for bad in ("BSDF[id=nope].reflectance", "Mesh[0].nope", "Mesh[9]"):
        for fn, sc in ((resolve_param_path, ts), (j_resolve, js)):
            with pytest.raises(KeyError):
                fn(sc, bad)
    for paths in (PATHS, ["Mesh[1]", "Emitter[0].radiance"], []):
        assert param_mask(ts, paths) == j_param_mask(js, paths)


def _adam_state(jopt):
    """The optax ScaleByAdamState inside a JAX Optimizer's state."""
    found = [x for x in jax.tree.leaves(
        jopt.state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState)]
    assert len(found) == 1
    return found[0]


def _full_grads(params_np, grads):
    """A JAX gradient tree: ``grads`` on the selected paths, 0 elsewhere."""
    return {g: [{k: jnp.asarray(grads.get((g, i, k), np.zeros_like(v)))
                 for k, v in entry.items()} for i, entry in enumerate(lst)]
            for g, lst in params_np.items()}


def _random_grads(opt, rng):
    out = {}
    for path, leaf in opt.trainable():
        g = rng.normal(size=tuple(leaf.shape)).astype(np.float32)
        g[..., 0] *= 1e-6          # some gradients near 0
        out[path] = g
    return out


def _assert_state_matches(opt, jopt, rtol=1e-6):
    paths = [p for p, _ in opt.trainable()]
    for (g, i, k) in paths:
        np.testing.assert_allclose(opt.params[g][i][k].numpy(),
                                   np.asarray(jopt.params[g][i][k]),
                                   rtol=rtol, atol=1e-7)
    st = _adam_state(jopt)
    for name, leaves in (("mu", jax.tree.leaves(st.mu)),
                         ("nu", jax.tree.leaves(st.nu))):
        assert len(leaves) == len(paths)
        for path, want in zip(paths, leaves):
            # a moment is a sum of terms of either sign: its error is
            # relative to the leaf's largest moment (XLA may fuse the
            # multiply-add)
            want = np.asarray(want)
            np.testing.assert_allclose(opt.state[name][path].numpy(), want,
                                       rtol=rtol,
                                       atol=rtol * np.abs(want).max())
    assert opt.state["count"] == int(st.count)


def test_adam_updates_match_optax():
    """Ten Adam updates of two selected leaves from identical gradients,
    through ``Optimizer._jit_update`` with the step count a 0-dim int32
    tensor: params and moments equal optax's to 1e-6 relative; frozen
    leaves stay bit for bit."""
    js, ts = j_sphere(), t_scenes.sphere_light_scene(**CPU)
    jopt = JOptimizer(js, PATHS, lr=0.05)
    opt = Optimizer(ts, PATHS, lr=0.05)
    before = {p: v.clone() for p, v in leaf_items(opt.params)}
    rng = np.random.default_rng(0)
    for _ in range(10):
        grads = _random_grads(opt, rng)
        jopt.params, jopt.state = jopt._jit_update(
            jopt.params, _full_grads(js.params(), grads), jopt.state)
        opt.update({p: torch.as_tensor(g) for p, g in grads.items()})
        _assert_state_matches(opt, jopt)
    count = opt.state["count"]
    assert count.dtype == torch.int32 and count.shape == () and count == 10
    selected = {p for p, _ in opt.trainable()}
    for path, was in before.items():
        now = opt.params[path[0]][path[1]][path[2]]
        assert torch.equal(now, was) != (path in selected), path


@pytest.mark.parametrize("which", ["adam", "adam-decay", "sgd", "masked",
                                   "masked-decay"])
def test_functional_transforms_match_optax(which):
    """The transforms the sharded steps and the examples take from optax
    (``opt.adam`` with a rate or ``exponential_decay``, ``sgd``, ``masked``
    after Adam, and after Adam on the schedule as the flagship chains
    them): twelve updates of a params tree from identical gradients, the
    count a 0-dim int32 tensor, updates and moments equal optax's to 1e-6
    relative; the schedule's rates to 1e-6 at counts 0 to 20, as ints and
    as the state's tensor count."""
    from psdr_tpu_torch import opt as t_opt
    sched, j_sched = (t_opt.exponential_decay(1e-2, 10, 0.05),
                      optax.exponential_decay(1e-2, 10, 0.05))
    for c in range(21):
        np.testing.assert_allclose(sched(c), float(j_sched(c)), rtol=1e-6)
        np.testing.assert_allclose(
            sched(torch.tensor(c, dtype=torch.int32)), float(j_sched(c)),
            rtol=1e-6)
    rng = np.random.default_rng(1)
    tree = {"meshes": [{"to_world": rng.normal(size=(4, 4)),
                        "vertex_positions": rng.normal(size=(12, 3))}],
            "bsdfs": [{"reflectance": rng.normal(size=(1, 1, 3))}]}
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
    mask = jax.tree.map(lambda x: np.zeros_like(x), tree)
    mask["meshes"][0]["vertex_positions"][:] = 1.0
    def j_masked(inner):
        return optax.chain(inner, optax.GradientTransformation(
            lambda p: optax.EmptyState(),
            lambda u, s, p=None: (jax.tree.map(lambda a, m: a * m, u, mask),
                                  s)))

    t_tx, j_tx = {
        "adam": (t_opt.adam(5e-2), optax.adam(5e-2)),
        "adam-decay": (t_opt.adam(sched), optax.adam(j_sched)),
        "sgd": (t_opt.sgd(0.5), optax.sgd(0.5)),
        "masked": (t_opt.masked(t_opt.adam(5e-2),
                                params_from_numpy(mask, **CPU)),
                   j_masked(optax.adam(5e-2))),
        "masked-decay": (t_opt.masked(t_opt.adam(sched),
                                      params_from_numpy(mask, **CPU)),
                         j_masked(optax.adam(j_sched)))}[which]
    tp, jp = params_from_numpy(tree, **CPU), jax.tree.map(jnp.asarray, tree)
    ts, jst = t_tx.init(tp), j_tx.init(jp)
    for _ in range(12):
        g = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(
            np.float32), tree)
        tu, ts = t_tx.update(params_from_numpy(g, **CPU), ts, tp)
        ju, jst = j_tx.update(jax.tree.map(jnp.asarray, g), jst, jp)
        tp, jp = t_opt.apply_updates(tp, tu), optax.apply_updates(jp, ju)
        for (_, a), b in zip(leaf_items(tu), jax.tree.leaves(ju)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-9)
    if which != "sgd":
        assert ts["count"].dtype == torch.int32 and ts["count"] == 12
        j_adam = jst[0] if which.startswith("masked") else jst
        mu = [x for _, x in leaf_items(ts["mu"])]
        for a, b in zip(mu, jax.tree.leaves(j_adam[0].mu)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_step_matches_jax_value_and_grad():
    """``Optimizer.step`` on sphere_light_scene(16, 16, spp=2): the loss to
    1e-5 and the selected leaves' gradients within 1e-2 relative L2 and
    cosine 0.999 of ``jax.value_and_grad``'s (tests/test_torch_grad.py's
    bounds); the step then moves only the selected leaves."""
    js = j_sphere(width=16, height=16, spp=2)
    ts = t_scenes.sphere_light_scene(16, 16, spp=2, **CPU)
    j_render = J.DirectIntegrator(1, 1).render_fn(js, with_boundary=False)

    def j_loss(p):
        return jnp.mean(j_render(p, jax.random.PRNGKey(3)) ** 2)

    j_value, j_grad = jax.jit(jax.value_and_grad(j_loss))(js.params())
    opt = Optimizer(ts, PATHS, lr=0.05)
    render = T.DirectIntegrator(1, 1).render_fn(ts, with_boundary=False)
    seen = {}
    update = opt.update
    opt.update = lambda grads: (seen.update(grads), update(grads))[1]
    before = [x.clone() for x in _leaves(opt.params)]
    loss = opt.step(lambda p, key: torch.mean(render(p, key) ** 2),
                    threefry.PRNGKey(3))
    assert abs(loss - float(j_value)) <= 1e-5 * float(j_value)
    assert sorted(seen) == [("bsdfs", 0, "reflectance"),
                            ("meshes", 0, "vertex_positions")]
    _assert_grads_match(
        [np.asarray(j_grad[g][i][k]).ravel() for g, i, k in sorted(seen)],
        [seen[p].numpy().ravel() for p in sorted(seen)], rel_l2=1e-2,
        min_cos=0.999)
    moved = [not torch.equal(a, b) for a, b in zip(before,
                                                   _leaves(opt.params))]
    assert sum(moved) == 2


def test_run_carried_over_from_jax_continues_step_for_step():
    """Two steps of the JAX Optimizer, its params and Adam state carried
    into the port (``params_from_numpy``, ``adam_state_from_numpy``), then
    a third update from JAX's third gradient in both: equal to 1e-6."""
    js = j_sphere(width=12, height=12, spp=2)
    ts = t_scenes.sphere_light_scene(12, 12, spp=2, **CPU)
    render = jax.jit(J.DirectIntegrator(1, 1).render_fn(
        js, with_boundary=False))

    def loss_fn(p, key):
        return jnp.mean(render(p, key) ** 2)

    jopt = JOptimizer(js, PATHS, lr=0.02)
    for i in range(2):
        jopt.step(loss_fn, jax.random.PRNGKey(i))
    opt = Optimizer(ts, PATHS, lr=0.02)
    opt.params = params_from_numpy(jax.tree.map(np.asarray, jopt.params),
                                   **CPU)
    st = _adam_state(jopt)
    adam_state_from_numpy(opt, [np.asarray(x) for x in jax.tree.leaves(st.mu)],
                          [np.asarray(x) for x in jax.tree.leaves(st.nu)],
                          int(st.count))
    _assert_state_matches(opt, jopt, rtol=0)
    g3 = jax.jit(jax.grad(loss_fn))(jopt.params, jax.random.PRNGKey(2))
    jopt.params, jopt.state = jopt._jit_update(jopt.params, g3, jopt.state)
    opt.update({p: torch.tensor(np.asarray(g3[p[0]][p[1]][p[2]]))
                for p, _ in opt.trainable()})
    _assert_state_matches(opt, jopt)
    with pytest.raises(ValueError, match="moments"):
        adam_state_from_numpy(opt, [], [], 0)


def test_masked_steps_write_back_and_resume(tmp_path):
    """Only the selected leaf moves; ``write_back`` hands the result to the
    scene; ``save`` then ``load`` into a fresh Optimizer resumes: the next
    step equals the step without the round trip."""
    ts = t_scenes.sphere_light_scene(12, 12, spp=2, **CPU)
    render = T.DirectIntegrator(1, 1).render_fn(ts, with_boundary=False)

    def loss_fn(p, key):
        return torch.mean(render(p, key))

    opt = Optimizer(ts, ["BSDF[id=white].reflectance"], lr=0.05)
    before = [x.clone() for x in _leaves(opt.params)]
    for i in range(3):
        opt.step(loss_fn, threefry.PRNGKey(i))
    moved = [not torch.equal(a, b) for a, b in zip(before,
                                                   _leaves(opt.params))]
    assert sum(moved) == 1
    assert not torch.equal(opt.params["bsdfs"][0]["reflectance"], before[0])
    opt.save(str(tmp_path / "ckpt.npz"))
    opt.step(loss_fn, threefry.PRNGKey(3))
    after4 = opt.params["bsdfs"][0]["reflectance"].clone()

    opt2 = Optimizer(ts, ["BSDF[id=white].reflectance"], lr=0.05)
    opt2.load(str(tmp_path / "ckpt.npz"))
    assert opt2.state["count"] == 3
    opt2.step(loss_fn, threefry.PRNGKey(3))
    assert torch.equal(opt2.params["bsdfs"][0]["reflectance"], after4)
    opt2.write_back()
    np.testing.assert_array_equal(ts.bsdfs[0].reflectance.data,
                                  after4.numpy())
    with pytest.raises(ValueError, match="does not match"):
        Optimizer(t_scenes.sphere_light_scene(subdiv=2, **CPU),
                  ["BSDF[id=white].reflectance"]).load(
                      str(tmp_path / "ckpt.npz"))


def _twist(vp, amount):
    """A twist about y, proportional to height: reorders the Morton
    codes, as a large deformation does."""
    a = amount * vp[:, 1:2]
    c, s = np.cos(a), np.sin(a)
    return np.concatenate([c * vp[:, :1] - s * vp[:, 2:], vp[:, 1:2],
                           s * vp[:, :1] + c * vp[:, 2:]], 1).astype(np.float32)


def test_refit_quality_and_rebuild_match_jax():
    """On a twisted 1,280-face icosphere (the BVH path) ``refit_quality``
    equals the JAX package's to 1e-5 and ``maybe_rebuild_accel`` decides
    as it does; after a rebuild a ``render_fn`` made before it renders the
    image of a fresh one, on the new tree."""
    js = j_sphere(16, 16, spp=2, subdiv=3)
    ts = t_scenes.sphere_light_scene(16, 16, spp=2, subdiv=3, **CPU)
    js.prepare_accel()
    ts.prepare_accel()
    np.testing.assert_array_equal(ts._bvh_topo.perm,
                                  np.asarray(js._bvh_topo.perm))
    assert ts.refit_quality() == pytest.approx(1.0, abs=1e-6)
    p = js.params()
    p["meshes"][0]["vertex_positions"] = _twist(
        np.asarray(p["meshes"][0]["vertex_positions"]), 3.0)
    q_j = js.refit_quality(p)
    q_t = ts.refit_quality(p)
    assert q_t == pytest.approx(q_j, rel=1e-5) and q_t > 1.05
    for thr in (q_t + 0.01, q_t - 0.01):
        assert js.maybe_rebuild_accel(p, threshold=thr) is (thr < q_t)
    integ = T.DirectIntegrator(1, 1)
    old_render = integ.render_fn(ts, with_boundary=False, detached=True)
    old_perm = ts._bvh_topo.perm.copy()
    assert not ts.maybe_rebuild_accel(p, threshold=q_t + 0.01)
    assert ts.maybe_rebuild_accel(p, threshold=q_t - 0.01)
    np.testing.assert_array_equal(ts._bvh_topo.perm,
                                  np.asarray(js._bvh_topo.perm))
    assert not np.array_equal(ts._bvh_topo.perm, old_perm)
    assert ts.refit_quality() == pytest.approx(1.0, abs=1e-6)
    tp = params_from_numpy(p, **CPU)
    key = threefry.PRNGKey(5)
    a = old_render(tp, key)
    b = integ.render_fn(ts, with_boundary=False, detached=True)(tp, key)
    assert torch.equal(a, b) and float(a.mean()) > 0


def test_optimizer_rebuild_uses_its_params():
    ts = t_scenes.sphere_light_scene(12, 12, spp=2, subdiv=3, **CPU)
    ts.prepare_accel()
    opt = Optimizer(ts, ["Mesh[0].vertex_positions"])
    vp = opt.params["meshes"][0]["vertex_positions"]
    assert not opt.maybe_rebuild_accel(threshold=1.5)
    vp.copy_(torch.as_tensor(_twist(vp.numpy(), 3.0)))
    q = ts.refit_quality(opt.params)
    assert opt.maybe_rebuild_accel(threshold=q - 0.01)
    np.testing.assert_array_equal(ts.meshes[0].vertex_positions, vp.numpy())


def _offset_scene(lib, width=16, height=16, spp=2):
    """A subdiv-2 icosphere with the 1D vertex offset under an area light."""
    sc = lib.Scene(**({} if lib is J else CPU))
    b = sc.add_bsdf(lib.Diffuse([0.8, 0.6, 0.4]), "white")
    sc.add_mesh(lib.primitives.make_icosphere(
        subdiv=2, radius=1.0, bsdf_id=b, enable_vertex_offset=True))
    light = lib.primitives.make_quad(size=1.0, bsdf_id=-1,
                                     enable_edges=False,
                                     use_face_normals=True)
    light.set_transform(xf.translate([0.0, 3.0, 1.0])
                        @ xf.rotate([1, 0, 0], 90.0))
    sc.add_emitter(lib.AreaLight([10.0, 10.0, 10.0],
                                 mesh_index=sc.add_mesh(light)))
    cam = lib.PerspectiveCamera(fov_x=40.0, near=0.1, far=100.0)
    cam.set_transform(xf.look_at([0, 1.0, 5.0], [0, 0, 0], [0, 1, 0]))
    sc.add_sensor(cam)
    sc.opts = lib.RenderOptions(width=width, height=height, spp=spp)
    return sc


def _offset():
    return (0.05 * np.sin(np.arange(162) * 0.37)).astype(np.float32)


def test_vertex_offset_geometry_matches_jax(tmp_path):
    """``world_positions`` with an offset and an appended transform,
    ``shift_vertices`` and ``dump`` (the offset baked into the file)."""
    js, ts = _offset_scene(J), _offset_scene(T)
    jm, tm = js.meshes[0], ts.meshes[0]
    assert "vertex_offset" in tm.params() and tm.vertex_offset.shape == (162,)
    for m in (jm, tm):
        m.vertex_offset = _offset()
        m.set_transform(xf.rotate([0, 1, 0], 30.0))
        m.append_transform(xf.translate([0.1, 0.2, -0.3]))
    want = np.asarray(jm.world_positions(
        {k: jnp.asarray(v) for k, v in jm.params().items()}))
    got = tm.world_positions(params_from_numpy(tm.params(), **CPU)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    jm.dump(str(tmp_path / "j.obj"))
    tm.dump(str(tmp_path / "t.obj"))
    assert (tmp_path / "t.obj").read_bytes() == (tmp_path / "j.obj").read_bytes()
    jm.shift_vertices()
    tm.shift_vertices()
    np.testing.assert_array_equal(tm.vertex_positions, jm.vertex_positions)
    assert not tm.vertex_offset.any()
    got2 = tm.world_positions(params_from_numpy(tm.params(), **CPU)).numpy()
    np.testing.assert_allclose(got2, got, rtol=1e-5, atol=1e-6)


def test_vertex_offset_gradient_matches_jax():
    """value_and_grad of mean(img^2) with every leaf, ``vertex_offset``
    among them (at a nonzero offset), against ``jax.value_and_grad``: loss
    to 1e-5, every leaf within 1e-2 relative L2 and cosine 0.999."""
    js, ts = _offset_scene(J), _offset_scene(T)
    js.meshes[0].vertex_offset = _offset()
    render = J.DirectIntegrator(1, 1).render_fn(js, with_boundary=False)

    def loss(p):
        return jnp.mean(render(p, jax.random.PRNGKey(3)) ** 2)

    j_value, j_grad = jax.jit(jax.value_and_grad(loss))(js.params())
    p = params_from_numpy(js.params(), **CPU, requires_grad=True)
    t_loss = torch.mean(T.DirectIntegrator(1, 1).render_fn(
        ts, with_boundary=False)(p, threefry.PRNGKey(3)) ** 2)
    t_loss.backward()
    assert abs(t_loss.item() - float(j_value)) <= 1e-5 * float(j_value)
    off = p["meshes"][0]["vertex_offset"].grad
    assert off is not None and off.abs().max() > 0
    _assert_grads_match(
        [np.asarray(g).ravel() for g in jax.tree.leaves(j_grad)],
        [np.zeros(x.numel(), np.float32) if x.grad is None
         else x.grad.numpy().ravel() for x in _leaves(p)],
        rel_l2=1e-2, min_cos=0.999)


def test_recover_translation_via_boundary_gradients():
    """tests/test_inverse_geometry.py in the port: the sphere's position,
    offset by (0.45, -0.3), recovered from a target image through the
    interior and both boundary terms, 60 Adam steps (the port's
    ``adam_update``, optax's arithmetic), under that test's asserts."""
    ts = t_scenes.sphere_light_scene(32, 32, spp=8, sppe=2, sppse=8, **CPU)
    render = T.DirectIntegrator(1, 1).render_fn(ts, with_boundary=True)
    base = params_from_numpy(ts.params(), **CPU)
    with torch.no_grad():
        target = render(base, threefry.PRNGKey(42))

    offset = torch.tensor([0.45, -0.3])
    mu, nu = torch.zeros(2), torch.zeros(2)
    start = offset.clone()
    losses = []
    for it in range(60):
        o = offset.clone().requires_grad_(True)
        m = dict(base["meshes"][0])
        m["to_world"] = translate(torch.cat([o, torch.zeros(1)])) \
            @ m["to_world"]
        p = dict(base, meshes=[m] + base["meshes"][1:])
        loss = torch.mean((render(p, threefry.PRNGKey(100 + it))
                           - target) ** 2)
        (g,) = torch.autograd.grad(loss, [o])
        mu, nu = adam_update(offset, g, mu, nu, it, 0.05)
        losses.append(loss.item())
    final = offset.numpy()
    assert np.linalg.norm(final) < 0.12, f"final offset {final}"
    assert np.linalg.norm(final) < 0.3 * np.linalg.norm(start.numpy())
    assert losses[-1] < losses[0] * 0.5
