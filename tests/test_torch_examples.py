"""The six ported examples (``psdr_tpu_torch/examples``) at their
``--small`` size on the CPU, and the flagship's pieces against the JAX
script's (``examples/flagship_recovery.py``).

Each example runs in this process through its ``main(argv)`` (the
multi-view one spawns two gloo ranks) for one or two iterations and must
write its files. The flagship's deformation and Laplacian smoothing are
held against the JAX script's on the same vertices (1e-6), and its first
step's loss and occluder gradient (three views with every boundary term)
against the JAX package's on the same params, keys and targets: the loss
to 1e-4 relative, the gradient to 1e-2 relative L2 and cosine 0.999
(``tests/test_torch_boundary.py``'s bounds).
"""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psdr_tpu import DirectIntegrator as JDirect
from psdr_tpu_torch import DirectIntegrator as TDirect
from psdr_tpu_torch.convert import params_from_numpy
from psdr_tpu_torch.core import threefry
from psdr_tpu_torch.examples import (flagship_recovery, inverse_albedo,
                                     inverse_geometry, multiview_inverse,
                                     render_simple, validate_gradients)
from psdr_tpu_torch.testing.scenes import flagship_deform

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_flagship():
    """The JAX script as a module (its ``main`` does not run)."""
    spec = importlib.util.spec_from_file_location(
        "jax_flagship_recovery",
        os.path.join(ROOT, "examples", "flagship_recovery.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("module,args,files", [
    (render_simple, [], ["cbox.exr", "cbox_depth.exr", "cbox_shNormal.exr"]),
    (validate_gradients, ["mesh_transform"],
     ["mesh_transform_ad.exr", "mesh_transform_fd.exr"]),
    (inverse_albedo, ["2"], ["inverse_albedo_log.json"]),
    (inverse_geometry, ["2"], ["inverse_geometry_log.json"]),
    (multiview_inverse, ["2", "--ranks", "2"],
     ["multiview_inverse_log.json"]),
    (flagship_recovery, ["1"],
     ["flagship_recovery_log.jsonl", "recovered_occluder.obj"])],
    ids=lambda x: getattr(x, "__name__", "").rsplit(".", 1)[-1] or None)
def test_example_runs_small(module, args, files, tmp_path):
    assert module.main(args + ["--small", "--device", "cpu",
                               "--out", str(tmp_path)]) in (None, 0)
    for f in files:
        assert (tmp_path / f).stat().st_size > 0, f
    if module is flagship_recovery:
        lines = [json.loads(s) for s in
                 (tmp_path / "flagship_recovery_log.jsonl").read_text()
                 .splitlines()]
        assert lines[0]["event"] == "start" and lines[-1]["event"] == "done"
        assert np.isfinite(lines[1]["loss"]) and lines[1]["loss"] > 0.0
        assert 0.0 < lines[-1]["chamfer_final"] and 0.0 < lines[0]["chamfer0"]
    if module is multiview_inverse:
        log = json.loads((tmp_path / files[0]).read_text())
        assert log["ranks"] == 2 and np.isfinite(log["losses"]).all()


def test_flagship_checkpoint_round_trip(tmp_path):
    """``save_ckpt`` (every tenth iteration) reads back through
    ``load_ckpt`` as the params and Adam state it holds."""
    from psdr_tpu_torch.opt import adam, tree_leaves
    p = {"meshes": [{"vertex_positions": torch.rand(5, 3)}]}
    opt = adam(1e-2)
    state = opt.init(p)
    _, state = opt.update({"meshes": [{"vertex_positions":
                                       torch.rand(5, 3)}]}, state, p)
    path = str(tmp_path / "ckpt.npz")
    flagship_recovery.save_ckpt(path, p, state)
    q, s2 = flagship_recovery.load_ckpt(path, p, opt.init(p))
    assert s2["count"] == 1
    for a, b in zip(tree_leaves((p, state["mu"], state["nu"])),
                    tree_leaves((q, s2["mu"], s2["nu"]))):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_flagship_chamfer_distance():
    """The symmetric Chamfer distance: 0 between a set and itself, blind
    to the order of the points (a vertex sliding onto its neighbour's
    place), and half a small shift's length for two sparse sets the shift
    keeps apart."""
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.uniform(size=(300, 3)).astype(np.float32))
    assert flagship_recovery.chamfer(a, a) == 0.0
    assert flagship_recovery.chamfer(a, a.flip(0), block=7) == 0.0
    pts = torch.eye(3) * 10.0
    shift = torch.tensor([0.0, 0.0, 0.01])
    assert flagship_recovery.chamfer(pts, pts + shift) == pytest.approx(
        0.01, rel=1e-5)


def test_flagship_deform_and_smoothing_match_the_jax_script():
    jmod = _jax_flagship()
    sc = flagship_recovery.build_scene(True, "cpu")
    v = np.asarray(sc.meshes[flagship_recovery.OCCLUDER].vertex_positions,
                   np.float32)
    np.testing.assert_allclose(flagship_deform(v), np.asarray(jmod.deform(v)),
                               rtol=1e-6, atol=1e-6)

    # the JAX script's smoothing (examples/flagship_recovery.py:175-191)
    faces = np.asarray(sc.meshes[flagship_recovery.OCCLUDER].faces, np.int64)
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                        faces[:, [2, 0]]], axis=0)
    e = np.unique(np.sort(e, axis=1), axis=0)
    src = jnp.asarray(np.concatenate([e[:, 0], e[:, 1]]), jnp.int32)
    dst = jnp.asarray(np.concatenate([e[:, 1], e[:, 0]]), jnp.int32)
    nv = v.shape[0]
    deg = jnp.maximum(jax.ops.segment_sum(
        jnp.ones_like(src, jnp.float32), dst, num_segments=nv), 1.0)

    def smooth_grad(g, rounds=10, lam=0.9):
        for _ in range(rounds):
            nb = jax.ops.segment_sum(g[src], dst,
                                     num_segments=nv) / deg[:, None]
            g = (1.0 - lam) * g + lam * nb
        return g

    g = np.random.default_rng(0).normal(size=(nv, 3)).astype(np.float32)
    ours = flagship_recovery.laplacian_smoother(faces, nv, "cpu")(
        torch.as_tensor(g))
    np.testing.assert_allclose(ours.numpy(), np.asarray(smooth_grad(g)),
                               rtol=1e-5, atol=1e-6)


def _rel_l2_cos(ref, port):
    ref, port = ref.ravel().astype(np.float64), port.ravel().astype(np.float64)
    return (np.linalg.norm(port - ref) / np.linalg.norm(ref),
            port @ ref / (np.linalg.norm(port) * np.linalg.norm(ref)))


def test_flagship_first_step_matches_jax():
    """Three views of the small flagship scene cut to 16 x 16 (spp 2, sppe
    2, sppse 4): the port's step program (``make_train_step``: the loss,
    the occluder's gradient, its smoothing and the masked Adam update on
    ``exponential_decay``) against the JAX script's jitted ``train_step``
    (``examples/flagship_recovery.py:199-205``, rebuilt here from its
    ``build_scene``, ``deform``, loss, smoothing and optax chain on the
    same targets) under PRNGKey(0): the loss to 1e-4, the raw and the
    smoothed gradient to 1e-2 relative L2 and cosine 0.999; and the
    update equal to optax's chain on the port's own smoothed gradient to
    1e-6 (a first Adam step is about the rate times the gradient's sign,
    so the two packages' updates are compared through the arithmetic,
    not entry by entry)."""
    import dataclasses
    jmod = _jax_flagship()
    occ = flagship_recovery.OCCLUDER
    cut = dict(width=16, height=16, spp=2, sppe=2, sppse=4)
    ts = flagship_recovery.build_scene(True, "cpu")
    js = jmod.build_scene(True)
    ts.opts = dataclasses.replace(ts.opts, **cut)
    js.opts = dataclasses.replace(js.opts, **cut)
    ts.prepare_accel()
    js.prepare_accel()
    integ = TDirect(1, 1)
    truth = params_from_numpy(js.params(), "cpu")
    targets = flagship_recovery.render_targets(ts, integ, truth)

    v0 = np.asarray(js.params()["meshes"][occ]["vertex_positions"])
    start = np.asarray(jmod.deform(v0))
    j_renders = [JDirect(1, 1).render_fn(js, s, with_boundary=True)
                 for s in range(js.num_sensors)]
    j_tgt = [jnp.asarray(t.numpy()) for t in targets]

    def j_loss(v, key):
        p = js.params()
        p["meshes"][occ] = dict(p["meshes"][occ], vertex_positions=v)
        total = 0.0
        for s, render in enumerate(j_renders):
            img = render(p, jax.random.fold_in(key, s))
            total = total + jnp.mean((img - j_tgt[s]) ** 2)
        return total / len(j_renders)

    faces = np.asarray(js.meshes[occ].faces, np.int64)
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                        faces[:, [2, 0]]], axis=0)
    e = np.unique(np.sort(e, axis=1), axis=0)
    src = jnp.asarray(np.concatenate([e[:, 0], e[:, 1]]), jnp.int32)
    dst = jnp.asarray(np.concatenate([e[:, 1], e[:, 0]]), jnp.int32)
    nv = v0.shape[0]
    deg = jnp.maximum(jax.ops.segment_sum(
        jnp.ones_like(src, jnp.float32), dst, num_segments=nv), 1.0)

    def smooth_grad(g, rounds=10, lam=0.9):
        for _ in range(rounds):
            nb = jax.ops.segment_sum(g[src], dst,
                                     num_segments=nv) / deg[:, None]
            g = (1.0 - lam) * g + lam * nb
        return g

    import optax
    sched = optax.exponential_decay(1e-2, transition_steps=4,
                                    decay_rate=0.05)
    j_mask = jnp.ones_like(jnp.asarray(start))
    j_opt = optax.chain(optax.adam(learning_rate=sched),
                        optax.GradientTransformation(
                            lambda p: optax.EmptyState(),
                            lambda u, s, p=None: (u * j_mask, s)))

    @jax.jit
    def j_train_step(v, opt_state, key):
        loss, g = jax.value_and_grad(j_loss)(v, key)
        updates, opt_state = j_opt.update(smooth_grad(g), opt_state, v)
        return optax.apply_updates(v, updates), opt_state, loss, g

    j_v1, _, j_l, j_g = j_train_step(jnp.asarray(start),
                                     j_opt.init(jnp.asarray(start)),
                                     jax.random.PRNGKey(0))

    from psdr_tpu_torch.opt import (adam, exponential_decay, masked,
                                    tree_leaves, tree_map)
    params = tree_map(lambda x: x.clone(), truth)
    params["meshes"][occ]["vertex_positions"] = torch.tensor(start)
    mask = tree_map(torch.zeros_like, params)
    mask["meshes"][occ]["vertex_positions"][:] = 1.0
    smooth = flagship_recovery.laplacian_smoother(
        ts.meshes[occ].faces, v0.shape[0], "cpu")
    opt = masked(adam(exponential_decay(1e-2, 4, 0.05)), mask)
    step = flagship_recovery.make_train_step(
        ts, flagship_recovery.make_loss(ts, integ, targets), smooth, opt)
    p1, s1, loss, g = step(params, opt.init(params), threefry.PRNGKey(0))
    assert abs(loss.item() - float(j_l)) <= 1e-4 * float(j_l)
    assert np.isfinite(g.numpy()).all()
    err, cos = _rel_l2_cos(np.asarray(j_g), g.numpy())
    assert err <= 1e-2 and cos >= 0.999, (err, cos)
    err, cos = _rel_l2_cos(np.asarray(smooth_grad(j_g)),
                           smooth(g).numpy())
    assert err <= 1e-2 and cos >= 0.999, (err, cos)
    assert int(s1["count"]) == 1
    moved = [k for k, (a, b) in enumerate(zip(tree_leaves(params),
                                               tree_leaves(p1)))
             if not torch.equal(a, b)]
    assert len(moved) == 1     # only the occluder's vertices
    # the port's update against optax's chain on the port's own gradient
    s = jnp.asarray(smooth(g).numpy())
    want, _, _, _ = jax.jit(lambda v, st: (optax.apply_updates(
        v, j_opt.update(s, st, v)[0]), 0, 0, 0))(
            jnp.asarray(start), j_opt.init(jnp.asarray(start)))
    np.testing.assert_allclose(
        p1["meshes"][occ]["vertex_positions"].numpy(), np.asarray(want),
        rtol=1e-6, atol=1e-7)
    assert np.isfinite(np.asarray(j_v1)).all()


def test_inverse_geometry_step_grad_matches_jax():
    """``inverse_geometry.make_step_grad`` (the JAX script's jitted
    ``step_grad``: the L2 loss of the sphere moved by a 2D offset, through
    every boundary term) against ``jax.value_and_grad`` of the script's
    loss on the same target, offset and key (16 x 16, spp 2, sppe 2, sppse
    4): the loss to 1e-5, the offset's gradient within 1e-2 relative L2
    and cosine 0.999 (``tests/test_torch_boundary.py``'s bounds)."""
    from psdr_tpu.core import transform as j_xf
    from psdr_tpu_torch.examples.inverse_geometry import make_step_grad
    from psdr_tpu_torch.testing.scenes import sphere_light_scene
    from scenes import sphere_light_scene as j_sphere
    kw = dict(width=16, height=16, spp=2, sppe=2, sppse=4)
    js, ts = j_sphere(**kw), sphere_light_scene(**kw, device="cpu")
    base_np = js.params()
    target = TDirect(1, 1).render_fn(ts, with_boundary=False,
                                     detached=True)(
        params_from_numpy(base_np, "cpu"), threefry.PRNGKey(42))
    j_render = JDirect(1, 1).render_fn(js, with_boundary=True)
    j_target = jnp.asarray(target.numpy())

    def j_loss(offset, key):
        p = jax.tree.map(lambda x: x, base_np)
        m = dict(p["meshes"][0])
        shift = jnp.concatenate([offset, jnp.zeros((1,), jnp.float32)])
        m["to_world"] = j_xf.translate(shift) @ m["to_world"]
        p["meshes"] = [m] + list(p["meshes"][1:])
        return jnp.mean((j_render(p, key) - j_target) ** 2)

    start = np.array([0.35, -0.25], np.float32)
    j_l, j_g = jax.jit(jax.value_and_grad(j_loss))(jnp.asarray(start),
                                                   jax.random.PRNGKey(3))
    step = make_step_grad(ts, TDirect(1, 1),
                          params_from_numpy(base_np, "cpu"), target)
    loss, g = step(torch.tensor(start), threefry.PRNGKey(3))
    assert abs(float(loss) - float(j_l)) <= 1e-5 * float(j_l)
    err, cos = _rel_l2_cos(np.asarray(j_g), g.numpy())
    assert err <= 1e-2 and cos >= 0.999, (err, cos, g, j_g)
