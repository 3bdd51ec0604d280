"""The port's sharded render and train steps (``psdr_tpu_torch.parallel``)
against its serial emulation and against the JAX package's.

The load-bearing property, as in ``tests/test_parallel.py``: the image and
the parameter gradients of a render over the ranks of a gloo group (CPU
processes, ``parallel.run_ranks``) equal a serial emulation that runs
each rank's arithmetic in one process (``per_device_render_fn`` in a loop),
rtol 2e-5, atol 2e-6. A reduction that double-counted the replicated
cotangent would scale every gradient by the rank count and fail. The
emulation in turn equals the JAX package's on the same params and key, at
``tests/test_torch_render.py``'s tolerances (at least 99% of pixels within
rtol 1e-4, atol 1e-5; means to 1e-4) and, for gradients,
``tests/test_torch_boundary.py``'s (1e-2 relative L2, cosine 0.999 per
leaf). The children import only the port; the parent compares.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psdr_tpu import DirectIntegrator as JDirect
from psdr_tpu.integrator import base as j_base
from psdr_tpu.parallel import device_mesh as j_device_mesh
from psdr_tpu.parallel.sharding import (make_multiview_train_step as
                                        j_multiview_step,
                                        per_device_render_fn as j_per_device)
from psdr_tpu import PerspectiveCamera as JCamera
from psdr_tpu.core import transform as j_xf
from psdr_tpu_torch import DirectIntegrator as TDirect
from psdr_tpu_torch import PathTracer as TPath
from psdr_tpu_torch.convert import params_from_numpy
from psdr_tpu_torch.core import threefry
from psdr_tpu_torch.integrator import base as t_base
from psdr_tpu_torch.opt import leaf_items
from psdr_tpu_torch.parallel import run_ranks
from psdr_tpu_torch.parallel.sharding import per_device_render_fn
from psdr_tpu_torch.testing import ranks
from psdr_tpu_torch.testing.scenes import cbox_scene as t_cbox

from scenes import cbox_scene as j_cbox
from scenes import sphere_light_scene as j_sphere

torch.set_num_threads(2)

CPU = dict(device="cpu")     # the port defaults to the card
RTOL, ATOL = 2e-5, 2e-6      # sharded against serial emulation


def _serial(integ, sc, n_dev, with_boundary, mode="auto"):
    """The mean over d of rank d's partial, in one process."""
    g = per_device_render_fn(integ, sc, n_dev, with_boundary=with_boundary,
                             mode=mode)
    return lambda p, k: sum(g(p, k, d) for d in range(n_dev)) / n_dev


def _serial_grads(integ, sc, n_dev, with_boundary, seed):
    p = params_from_numpy(sc.params(), **CPU, requires_grad=True)
    img = _serial(integ, sc, n_dev, with_boundary)(p, threefry.PRNGKey(seed))
    ranks.sharded_loss(img).backward()
    return img.detach().numpy(), [
        np.zeros(x.shape, np.float32) if x.grad is None else x.grad.numpy()
        for _, x in leaf_items(p)]


def _close(a, b, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)


def _images_match_jax(t_img, j_img):
    assert np.isfinite(t_img).all() and t_img.mean() > 0.0
    close = np.isclose(t_img, j_img, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(t_img.mean() - j_img.mean()) / j_img.mean() < 1e-4


def _grads_match(ref, port, rel_l2=1e-2, min_cos=0.999):
    for i, (a, g) in enumerate(zip(ref, port)):
        a, g = np.ravel(a).astype(np.float64), np.ravel(g).astype(np.float64)
        assert np.isfinite(g).all(), i
        na = np.linalg.norm(a)
        assert np.linalg.norm(g - a) <= rel_l2 * na + 1e-12, (i, na)
        if na > 0:
            assert g @ a / (np.linalg.norm(g) * na) >= min_cos, i


# -- lane slices and keys --------------------------------------------------

def test_shard_lane_range_matches_jax():
    for n in (1, 5, 64, 1280, 1125, 2 ** 21 + 3):
        for n_dev in (1, 2, 3, 4, 8):
            spans = [t_base.shard_lane_range(n, (d, n_dev))
                     for d in range(n_dev)]
            assert spans == [j_base.shard_lane_range(n, (d, n_dev))
                             for d in range(n_dev)]
            # the slices tile [0, n) and the last one may run past it
            assert all(s == d * spans[0][1] for d, (s, _) in enumerate(spans))
            assert n_dev * spans[0][1] >= n > n_dev * (spans[0][1] - 1)


def test_fold_in_by_rank_matches_jax():
    for seed in (0, 3, 2 ** 31 - 1):
        for d in range(9):
            ours = threefry.fold_in(threefry.PRNGKey(seed), d)
            ref = jax.random.fold_in(jax.random.PRNGKey(seed), jnp.int32(d))
            np.testing.assert_array_equal(
                ours.numpy().astype(np.uint32),
                np.asarray(jax.random.key_data(ref)
                           if jnp.issubdtype(ref.dtype, jax.dtypes.prng_key)
                           else ref).astype(np.uint32))


# -- the serial emulation against the JAX package's ------------------------

@pytest.mark.parametrize("scene,mode,with_boundary,seed", [
    (dict(width=24, height=24, spp=8), "budget", False, 3),
    (dict(width=24, height=24, spp=6), "lanes", False, 3),
    (dict(width=16, height=16, spp=4, sppe=6, sppse=6), "lanes", True, 2)],
    ids=["budget", "lanes", "lanes-boundary"])
def test_serial_emulation_matches_jax(scene, mode, with_boundary, seed):
    """Four ranks' partials summed in one process, per pixel against
    ``psdr_tpu``'s ``per_device_render_fn`` on the same params and key (the
    boundary terms are zero in the primal; their lane-sliced gradients are
    held to the emulation below, and the emulation's per-term gradients to
    the JAX package's in ``test_torch_boundary.py``)."""
    js, ts = j_cbox(**scene), t_cbox(**scene, **CPU)
    jg = j_per_device(JDirect(1, 1), js, 4, with_boundary=with_boundary,
                      mode=mode)

    def j_render(p, k):
        return sum(jg(p, k, jnp.int32(d)) for d in range(4)) / 4

    key = jax.random.PRNGKey(seed)
    j_img = np.asarray(jax.jit(j_render)(js.params(), key))
    t_render = _serial(TDirect(1, 1), ts, 4, with_boundary, mode)
    t_img = t_render(params_from_numpy(js.params(), **CPU),
                     threefry.PRNGKey(seed))
    _images_match_jax(t_img.detach().numpy(), j_img)


def test_lane_slices_cover_the_full_budget():
    """Every lane goes to exactly one rank (ceil split, masked tail): the
    silhouette AOV is 1 on every sample of the enclosed camera, so the
    summed lane partials give 1 per pixel or a lane was lost or doubled."""
    from psdr_tpu_torch import FieldExtractionIntegrator
    sc = t_cbox(16, 16, spp=5, **CPU)
    for n_dev in (8, 3):
        img = _serial(FieldExtractionIntegrator("silhouette"), sc, n_dev,
                      False, "lanes")(params_from_numpy(sc.params(), **CPU),
                                      threefry.PRNGKey(1))
        _close(img.numpy(), 1.0, rtol=1e-5, atol=0)


# -- over gloo ranks --------------------------------------------------------

@pytest.fixture(scope="module", params=[2, 4], ids=["2 ranks", "4 ranks"])
def sharded(request):
    """``ranks.sharded_checks`` on each rank of a gloo group (one torch
    thread a rank, joined within 600 s)."""
    world = request.param
    return world, run_ranks(ranks.sharded_checks, world, timeout=600)


def test_sharded_render_and_gradient_match_serial_emulation(sharded):
    """Every case of ``ranks.sharded_cases``: the image on each rank (all
    equal) and the gradient summed over the ranks against the serial
    emulation; every gradient leaf finite and the gradient not zero."""
    world, out = sharded
    for name, kw, integ, with_boundary, seed in ranks.sharded_cases():
        img, grads = out[0][name][:2]
        for r in range(1, world):
            np.testing.assert_array_equal(out[r][name][0], img)
            for a, b in zip(out[r][name][1], grads):
                np.testing.assert_array_equal(a, b)
        ref_img, ref_grads = _serial_grads(integ(), t_cbox(**kw, **CPU),
                                           world, with_boundary, seed)
        _close(img, ref_img, what=name)
        assert len(grads) == len(ref_grads)
        for i, (a, b) in enumerate(zip(grads, ref_grads)):
            assert np.isfinite(a).all(), (name, i)
            _close(a, b, what=f"{name} leaf {i}")
        assert sum(float(np.abs(g).sum()) for g in grads) > 0.0, name


def test_one_rank_group_equals_the_plain_render():
    """A one-rank gloo group: ``shard_render_fn`` with the boundary terms is
    the plain ``render_fn`` under ``fold_in(key, 0)``, image and gradient
    bit for bit, with the same K1 and K2 launch counts; its train step (in
    gloo's form, programs around the collectives) applies the plain
    gradient: the loss to 1e-6, each leaf's applied gradient within 1e-4
    relative L2 (the step's SGD rate of 1e3 carries the gradient's digits;
    the two backwards round the L2's derivative apart). ``step_forms``
    runs the whole and the split form of that step: on CPU tensors both
    run eagerly and give the same loss bit for bit."""
    small = dict(width=8, height=8, spp=1)
    out = run_ranks(ranks.one_rank_render, 1, args=("cpu", (small,), 1),
                    timeout=600)[0]
    (img, grads, launches), (p_img, p_grads, p_launches) = (
        out["sharded"], out["plain"])
    np.testing.assert_array_equal(img, p_img)
    for a, b in zip(grads, p_grads):
        np.testing.assert_array_equal(a, b)
    assert launches == p_launches    # 0 here: the CPU runs no kernel
    (loss, grads, _), (p_loss, p_grads, _) = out["step"], out["step_plain"]
    assert abs(loss - p_loss) <= 1e-6 * p_loss
    for a, b in zip(grads, p_grads):
        assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b)
    assert [c for c, _, _ in out["step_programs"]] == [False, False]
    ((kw, whole, split, (l_whole, l_split)),) = out["forms"]
    assert kw == small and len(whole) == len(split) == 1
    assert l_whole == l_split


def test_overlapped_reduction_equals_one_bucket(sharded):
    """``make_train_step`` under ``sgd(1.0)``: the per-leaf asynchronous
    reduction (``overlap=True``) and the one-bucket reduction give the same
    loss and updated params (to the last place, rtol 2e-5, atol 2e-6), and
    both equal the serial emulation's step."""
    world, out = sharded
    (la, pa), (lb, pb) = out[0]["steps"]
    # gloo sums a bucket and a lone tensor in different orders: the last
    # place may differ
    assert abs(la - lb) <= 1e-6 * la
    for a, b in zip(pa, pb):
        _close(a, b)
    sc = t_cbox(24, 24, spp=8, **CPU)
    p = params_from_numpy(sc.params(), **CPU, requires_grad=True)
    img = _serial(TDirect(1, 1), sc, world, False)(p, threefry.PRNGKey(4))
    loss = torch.mean(img * img)
    loss.backward()
    assert abs(la - loss.item()) <= 1e-6 * loss.item()
    for a, (_, x) in zip(pa, leaf_items(p)):
        g = 0.0 if x.grad is None else x.grad
        _close(a, (x - g).detach().numpy())


def test_split_steps_equal_whole_steps(sharded):
    """Over gloo a train step runs as programs around its collectives
    (``make_train_step``: a ``VJPProgram``'s forward and backward, then
    the update program; ``make_multiview_train_step``: the local loss and
    gradients, then the update); over NCCL as one program. On CPU tensors
    both forms run eagerly: the split steps' loss and updated params equal
    the one-body steps' bit for bit, on every rank, both overlap flags and
    the multi-view step."""
    world, out = sharded
    for r in range(world):
        for split, whole in ((out[r]["steps"], out[r]["steps_whole"]),
                             out[r]["multiview"]):
            pairs = (zip(split, whole) if isinstance(split, list)
                     else [(split, whole)])
            for (la, pa), (lb, pb) in pairs:
                assert la == lb
                for a, b in zip(pa, pb):
                    np.testing.assert_array_equal(a, b)


class _OneRank(ranks.LocalRank):
    """One rank's share of a build, without a group: its ``all_reduce``
    keeps the rank's raw cell masses in ``masses`` for the serial
    emulation to sum."""
    masses: list = []

    def all_reduce(self, tensor, async_op=False):
        _OneRank.masses.append(tensor.clone())


def test_collective_guiding_masses_match_serial(sharded):
    """``DirectIntegrator.preprocess_secondary_edges(mesh=)`` equals the
    serial build (each lane draws the serial build's uniform);
    ``PathTracer.preprocess_indirect_edges(mesh=)`` (each rank's lanes draw
    from ``fold_in(key, rank)``) equals the sum of the ranks' tables built
    one at a time, and is finite, non-negative and normalized."""
    world, out = sharded
    direct, indirect = out[0]["guiding"]
    for r in range(1, world):
        np.testing.assert_array_equal(out[r]["guiding"][0], direct)
        np.testing.assert_array_equal(out[r]["guiding"][1], indirect)
    sc = ranks.guiding_scene()
    serial = TDirect(1, 1)
    g = ranks.GUIDING
    serial.preprocess_secondary_edges(sc, 0, g["reso"], g["nrounds"],
                                      g["seed"])
    assert direct.sum() > 0.0
    _close(direct, serial.warpper[0].distrb.pmf.numpy(), atol=1e-7)

    g = ranks.IND_GUIDING
    assert g["nrounds"] == 1
    _OneRank.masses.clear()
    for d in range(world):
        TPath(max_depth=2).preprocess_indirect_edges(
            sc, 0, g["reso"], g["nrounds"], g["seed"],
            mesh=_OneRank(None, d, world, torch.device("cpu")))
    ref = sum(m.numpy() for m in _OneRank.masses)
    assert np.isfinite(indirect).all() and (indirect >= 0).all()
    assert ref.sum() > 0.0
    _close(indirect, ref, atol=1e-7)


def _multiview_targets(n_views):
    """Targets at the true params, one per view, from the port."""
    sc = ranks.multiview_scene(n_views)
    sc.prepare_accel()
    p = params_from_numpy(sc.params(), **CPU)
    integ = TDirect(1, 1)
    with torch.no_grad():
        flat = sc.build(p)
        return [integ.radiance_image(sc, flat, s,
                                     threefry.PRNGKey(900 + s), False).numpy()
                for s in range(n_views)]


def _j_multiview_scene(n_views):
    sc = j_sphere(width=16, height=16, spp=2)
    sc.opts = dataclasses.replace(sc.opts, sppe=2, sppse=4)
    for eye in ([6.0, 1.5, 0.0], [0.0, 1.5, 6.0],
                [-6.0, 1.5, 0.0])[:n_views - 1]:
        cam = JCamera(fov_x=40.0)
        cam.set_transform(np.asarray(j_xf.look_at(eye, [0, 0, 0],
                                                  [0, 1, 0])))
        sc.add_sensor(cam)
    return sc


@pytest.mark.parametrize("world", [2, 4], ids=["2 ranks", "4 ranks"])
def test_multiview_step_matches_serial_and_jax(world):
    """Two views at 16 x 16 (spp 2, sppe 2, sppse 4) on ``world`` ranks,
    rank d on view d % 2, one ``sgd(0.5)`` step: loss and updated params
    equal on every rank and equal to the serial emulation (mean over d of
    the L2 of view d % 2 under fold_in(key, d)); loss within 1e-4 and each
    leaf's update within 1e-2 relative L2 (cosine 0.999) of
    ``psdr_tpu``'s ``make_multiview_train_step`` on the same params, key
    and targets."""
    n_views, lr, seed = 2, 0.5, 3
    targets = _multiview_targets(n_views)
    out = run_ranks(ranks.multiview_step, world,
                    args=(functools.partial(ranks.multiview_start, n_views),
                          targets, lr, seed), timeout=600)
    loss, p1 = out[0]["loss"], out[0]["params"]
    for r in range(1, world):
        assert out[r]["loss"] == loss
        for a, b in zip(out[r]["params"], p1):
            np.testing.assert_array_equal(a, b)

    sc = ranks.multiview_scene(n_views)
    sc.prepare_accel()
    p = params_from_numpy(sc.params(), **CPU, requires_grad=True)
    flat = sc.build(p)
    total = 0.0
    for d in range(world):
        v = d % n_views
        img = TDirect(1, 1).radiance_image(
            sc, flat._replace(sensors=(flat.sensors[v],)), 0,
            threefry.fold_in(threefry.PRNGKey(seed), d), True)
        total = total + torch.mean((img - torch.as_tensor(targets[v])) ** 2)
    total = total / world
    total.backward()
    assert abs(loss - total.item()) <= 1e-6 * total.item()
    p0 = [x.detach().numpy() for _, x in leaf_items(p)]
    for a, (_, x), q in zip(p1, leaf_items(p), p0):
        assert np.isfinite(a).all()
        g = np.zeros_like(q) if x.grad is None else x.grad.numpy()
        _close(a - q, -lr * g)

    import optax
    js = _j_multiview_scene(n_views)
    step, st = j_multiview_step(JDirect(1, 1), js, j_device_mesh(world),
                                targets, optimizer=optax.sgd(lr),
                                with_boundary=True)
    j_p1, _, j_loss = step(js.params(), st, jax.random.PRNGKey(seed))
    assert abs(float(j_loss) - loss) <= 1e-4 * abs(float(j_loss))
    _grads_match([np.asarray(b) - q for b, q in
                  zip(jax.tree.leaves(j_p1), p0)],
                 [a - q for a, q in zip(p1, p0)])
