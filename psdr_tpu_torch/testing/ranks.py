"""The rank bodies of the sharding tests and of ``chip_smoke.py``'s
sharded phases (``tests/test_torch_parallel.py``, ``tests/test_torch_gpu.py``),
run on each rank by ``parallel.run_ranks``; they return numpy arrays for the
parent to compare with its serial emulation.

``LocalRank`` is one rank of a mesh held in this process, without a group:
the serial emulations render each rank's share through it.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import DirectIntegrator, PathTracer, PerspectiveCamera
from ..convert import params_from_numpy
from ..core import threefry
from ..core import transform as xf
from ..opt import leaf_items, sgd
from ..parallel import (device_mesh, make_multiview_train_step,
                        make_train_step, reduce_gradients, shard_render_fn)
from ..parallel.sharding import DeviceMesh
from .scenes import cbox_scene, sphere_light_scene


class _Done:
    """The handle of a collective that has finished."""

    def wait(self) -> bool:
        return True


class LocalRank(DeviceMesh):
    """Rank ``rank`` of ``size`` in this process, without a group: its sum
    over the ranks leaves this rank's share as it is. With ``size`` 1 it is
    a whole mesh; otherwise the serial emulations add the shares up."""

    def all_reduce(self, tensor, async_op=False):
        return _Done() if async_op else None

    def captures_collectives(self) -> bool:
        return True        # there are none


class LocalSplitRank(LocalRank):
    """A ``LocalRank`` whose train steps take gloo's form, programs around
    the collectives."""

    def captures_collectives(self) -> bool:
        return False


class WholeStep(DeviceMesh):
    """A mesh whose train steps take the one-program form that NCCL's
    take (``captures_collectives``): over gloo on CPU tensors, where the
    programs run eagerly, the step's one body against the split form."""

    def captures_collectives(self) -> bool:
        return True


class SplitStep(DeviceMesh):
    """A mesh whose train steps take gloo's form, programs around the
    collectives: over NCCL, the split form timed against the whole one."""

    def captures_collectives(self) -> bool:
        return False


# -- rank bodies --------------------------------------------------------------

def leaves_np(tree) -> list:
    """A params tree's leaves as numpy arrays, in ``jax.tree.leaves``
    order (``opt.leaf_items``)."""
    return [x.detach().cpu().numpy() for _, x in leaf_items(tree)]


def sharded_loss(img: torch.Tensor) -> torch.Tensor:
    """The tests' loss of an image (``tests/test_parallel.py``'s)."""
    return torch.mean(img * img) + torch.mean(img)


def sharded_cases():
    """(name, ``cbox_scene`` arguments, integrator maker, with_boundary,
    key) of the sharded render and gradient checks: the budget split (spp
    8), the lane split at an spp that 2 and 4 ranks do not divide (5), on
    whole pixels and on a 15 x 15 film whose slices end inside a pixel,
    and both integrators with their boundary terms (budget split on 2
    ranks, lanes on 4)."""
    return (
        ("budget", dict(width=24, height=24, spp=8), DirectIntegrator, False,
         3),
        ("lanes", dict(width=24, height=24, spp=5), DirectIntegrator, False,
         0),
        ("lanes unaligned", dict(width=15, height=15, spp=5),
         DirectIntegrator, False, 1),
        ("direct boundary", dict(width=16, height=16, spp=4, sppe=6,
                                 sppse=6), DirectIntegrator, True, 2),
        ("path boundary", dict(width=12, height=12, spp=2, sppe=4, sppse=4),
         lambda: PathTracer(max_depth=2, camera_depth=2), True, 5),
    )


def _mesh(device):
    return device_mesh(device="cpu" if str(device) == "cpu" else None)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


GUIDING = dict(reso=(4, 4, 4, 2), nrounds=2, seed=3)
IND_GUIDING = dict(reso=(4, 4, 4, 1), nrounds=1, seed=5)
GUIDING_SCENE = dict(width=16, height=16, spp=2, sppse=2)
# make_train_step's check: (cbox_scene arguments, SGD rate, key, the
# overlap flag of each step in turn)
STEP_CHECK = (dict(width=24, height=24, spp=8), 1.0, 4, (False, True))
# the collective guiding tables: (cbox_scene arguments, the
# DirectIntegrator's table, the PathTracer's indirect table or None)
GUIDING_CHECK = (GUIDING_SCENE, GUIDING, IND_GUIDING)


def guiding_scene(device="cpu", scene=GUIDING_SCENE):
    """``tests/test_parallel.py``'s guiding scene, or ``cbox_scene`` with
    the arguments ``scene``, its tree built."""
    sc = cbox_scene(**scene, device=device)
    sc.prepare_accel()
    return sc


def sharded_checks(device="cpu", cases=None, step=STEP_CHECK,
                   guiding=GUIDING_CHECK, repeats: int = 1) -> dict:
    """On each rank (on ``device``: "cpu", or "cuda" for the rank's card):
    every case of ``cases`` (default ``sharded_cases()``) through
    ``shard_render_fn`` ``repeats`` times; ``out[name]`` is the last run's
    (image, gradient of ``sharded_loss`` summed by ``reduce_gradients``,
    seconds, K1 and K2 launches). Then one ``make_train_step`` step for
    each overlap flag of ``step`` (laid out as ``STEP_CHECK``) under
    ``sgd(rate)``: ``out["steps"]``, (loss, updated params) each, in the
    backend's form (over gloo: programs around the collectives). On CPU
    tensors also ``out["steps_whole"]``, the same steps in the one-body
    form (``WholeStep``), and ``out["multiview"]``, one
    ``make_multiview_train_step`` step on the two-view
    ``multiview_scene`` in each form ((loss, updated params) each). Then
    the collective guiding tables of ``guiding`` (laid out as
    ``GUIDING_CHECK``): ``out["guiding"]``, the ``DirectIntegrator``'s
    and the ``PathTracer``'s (None where its table is None)."""
    from ..accel import intersect
    mesh = _mesh(device)
    dev = mesh.device
    out = {}
    for name, kw, integ, with_boundary, seed in (cases or sharded_cases()):
        sc = cbox_scene(**kw, device=dev)
        render = shard_render_fn(integ(), sc, mesh,
                                 with_boundary=with_boundary)
        for _ in range(repeats):
            p = params_from_numpy(sc.params(), dev, requires_grad=True)
            _sync(dev)
            intersect.reset_launch_counts()
            t0 = time.perf_counter()
            img = render(p, threefry.PRNGKey(seed))
            sharded_loss(img).backward()
            grads = reduce_gradients(
                [torch.zeros_like(x) if x.grad is None else x.grad
                 for _, x in leaf_items(p)], mesh)
            _sync(dev)
            dt = time.perf_counter() - t0
        out[name] = (img.detach().cpu().numpy(),
                     [g.cpu().numpy() for g in grads], dt,
                     dict(intersect.LAUNCHES))

    kw, lr, seed, overlaps = step
    sc = cbox_scene(**kw, device=dev)
    target = np.zeros((sc.opts.num_pixels, 3), np.float32)
    forms = {"steps": mesh}
    if dev.type == "cpu":
        forms["steps_whole"] = WholeStep(*mesh)
    for name, m in forms.items():
        out[name] = []
        for overlap in overlaps:
            train, state = make_train_step(DirectIntegrator(1, 1), sc, m,
                                           target, optimizer=sgd(lr),
                                           overlap=overlap)
            p1, _, loss = train(params_from_numpy(sc.params(), dev), state,
                                threefry.PRNGKey(seed))
            out[name].append((loss.item(), leaves_np(p1)))
    if dev.type == "cpu":
        mv = multiview_scene(2, device=dev)
        targets = np.zeros((2, mv.opts.num_pixels, 3), np.float32)
        out["multiview"] = []
        for m in forms.values():
            step, state = make_multiview_train_step(
                DirectIntegrator(1, 1), mv, m, targets, optimizer=sgd(lr))
            p1, _, loss = step(params_from_numpy(mv.params(), dev), state,
                               threefry.PRNGKey(seed))
            out["multiview"].append((loss.item(), leaves_np(p1)))

    kw, direct, indirect = guiding
    sc = guiding_scene(dev, kw)
    integ = DirectIntegrator(1, 1)
    integ.preprocess_secondary_edges(sc, 0, direct["reso"],
                                     direct["nrounds"], direct["seed"],
                                     mesh=mesh)
    pmf = None
    if indirect is not None:
        pt = PathTracer(max_depth=2)
        pt.preprocess_indirect_edges(sc, 0, indirect["reso"],
                                     indirect["nrounds"], indirect["seed"],
                                     mesh=mesh)
        pmf = pt.ind_warpper[0].distrb.pmf.cpu().numpy()
    out["guiding"] = (integ.warpper[0].distrb.pmf.cpu().numpy(), pmf)
    return out


def multiview_scene(n_views: int, width=16, height=16, spp=2, sppe=2,
                    sppse=4, device="cpu"):
    """``tests/test_parallel.py``'s multi-view scene with ``n_views``
    views: the sphere-and-light scene seen from its own camera and from
    ``n_views - 1`` more around the sphere."""
    sc = sphere_light_scene(width, height, spp=spp, device=device)
    sc.opts = dataclasses.replace(sc.opts, sppe=sppe, sppse=sppse)
    for eye in ([6.0, 1.5, 0.0], [0.0, 1.5, 6.0],
                [-6.0, 1.5, 0.0])[:n_views - 1]:
        cam = PerspectiveCamera(fov_x=40.0)
        cam.set_transform(np.asarray(xf.look_at(eye, [0, 0, 0], [0, 1, 0])))
        sc.add_sensor(cam)
    return sc


def multiview_start(n_views: int, device):
    """(``multiview_scene(n_views)``, its params) on ``device``."""
    sc = multiview_scene(n_views, device=device)
    return sc, params_from_numpy(sc.params(), device)


def multiview_step(start, targets, lr: float, seed: int, device="cpu",
                   timed: int = 0) -> dict:
    """On each rank: ``start(device)`` gives (scene, params); one
    ``make_multiview_train_step`` step under ``sgd(lr)`` with
    ``PRNGKey(seed)``, then ``timed`` more from the same params under the
    keys that follow, each timed. Returns {"loss", "params" (the first
    step's updated leaves), "seconds" (of the timed steps), "launches"
    (K1 and K2 of the last step)}."""
    from ..accel import intersect
    mesh = _mesh(device)
    sc, p0 = start(mesh.device)
    step, state = make_multiview_train_step(DirectIntegrator(1, 1), sc, mesh,
                                            targets, optimizer=sgd(lr))
    intersect.reset_launch_counts()
    p1, _, loss = step(p0, state, threefry.PRNGKey(seed))
    seconds = []
    for i in range(timed):
        _sync(mesh.device)
        intersect.reset_launch_counts()
        t0 = time.perf_counter()
        step(p0, state, threefry.PRNGKey(seed + 1 + i))
        _sync(mesh.device)
        seconds.append(time.perf_counter() - t0)
    return {"loss": loss.item(), "params": leaves_np(p1), "seconds": seconds,
            "launches": dict(intersect.LAUNCHES)}


ONE_RANK_LR = 1e3     # the SGD rate of ``one_rank_render``'s train step


def step_forms(mesh, scenes, reps: int) -> list:
    """``make_train_step`` (L2 to a black target, ``sgd(ONE_RANK_LR)``) in
    both forms on ``mesh``, the whole step as one program and the split
    form (``SplitStep``), on ``cbox_scene(**kw)`` for each ``kw`` of
    ``scenes``: each captured, then called ``reps`` times in turns (whole,
    split, split, whole, ...) under one key. One entry a scene: (kw,
    seconds of the whole form's calls, of the split form's, the loss of
    each form)."""
    out = []
    for kw in scenes:
        sc = cbox_scene(**kw, device=mesh.device)
        target = np.zeros((sc.opts.num_pixels, 3), np.float32)
        p0 = params_from_numpy(sc.params(), mesh.device)
        steps = [make_train_step(DirectIntegrator(1, 1), sc, m, target,
                                 optimizer=sgd(ONE_RANK_LR))
                 for m in (WholeStep(*mesh), SplitStep(*mesh))]
        losses = [train(p0, state, threefry.PRNGKey(3))[2].item()
                  for train, state in steps]
        secs = ([], [])
        for i in range(reps):
            for j in ((0, 1) if i % 2 == 0 else (1, 0)):
                train, state = steps[j]
                _sync(mesh.device)
                t0 = time.perf_counter()
                train(p0, state, threefry.PRNGKey(3))
                _sync(mesh.device)
                secs[j].append(time.perf_counter() - t0)
        out.append((kw, secs[0], secs[1], losses))
    return out


def one_rank_render(device="cuda", timed=(), reps: int = 0) -> dict:
    """On a one-rank group (NCCL on the card, or gloo): ``shard_render_fn``
    against the plain ``render_fn`` under ``fold_in(key, 0)``, image and
    gradient (reduced per leaf, asynchronously), and the K1 and K2 launch
    counts of each (``out["sharded"]``, ``out["plain"]``). Then one
    ``make_train_step`` step (L2 to a black target, ``sgd(ONE_RANK_LR)``)
    in the group's form (over NCCL one captured program) called twice,
    against the plain gradient: ``out["step"]``, (loss, the gradient the
    second call applied, (params - updated) / ONE_RANK_LR, its launches),
    ``out["step_plain"]``, (loss, the plain gradient, its launches), and
    ``out["step_programs"]``, (captured, graph nodes, capture seconds) of
    each of the step's programs. ``out["forms"]`` is ``step_forms(mesh,
    timed, reps)``."""
    from ..accel import intersect
    mesh = _mesh(device)
    sc = cbox_scene(32, 32, spp=4, sppe=2, sppse=16, occluder_subdiv=3,
                    device=mesh.device)
    out = {}
    for name in ("sharded", "plain"):
        p = params_from_numpy(sc.params(), mesh.device, requires_grad=True)
        intersect.reset_launch_counts()
        if name == "sharded":
            img = shard_render_fn(DirectIntegrator(1, 1), sc, mesh)(
                p, threefry.PRNGKey(3))
        else:
            img = DirectIntegrator(1, 1).render_fn(sc)(
                p, threefry.fold_in(threefry.PRNGKey(3), 0))
        sharded_loss(img).backward()
        grads = [torch.zeros_like(x) if x.grad is None else x.grad
                 for _, x in leaf_items(p)]
        if name == "sharded":
            grads = reduce_gradients(grads, mesh, overlap=True)
        out[name] = (img.detach().cpu().numpy(),
                     [g.cpu().numpy() for g in grads],
                     dict(intersect.LAUNCHES))

    target = np.zeros((sc.opts.num_pixels, 3), np.float32)
    train, state = make_train_step(DirectIntegrator(1, 1), sc, mesh, target,
                                   optimizer=sgd(ONE_RANK_LR))
    p0 = params_from_numpy(sc.params(), mesh.device)
    train(p0, state, threefry.PRNGKey(3))          # the capture on NCCL
    intersect.reset_launch_counts()
    p1, _, loss = train(p0, state, threefry.PRNGKey(3))
    out["step"] = (loss.item(), [(a - b) / ONE_RANK_LR for a, b in zip(
        leaves_np(p0), leaves_np(p1))], dict(intersect.LAUNCHES))
    out["step_programs"] = [(bool(getattr(prog, "captured", False)),
                             prog.nodes, prog.capture_seconds)
                            for prog in train.programs]
    p = params_from_numpy(sc.params(), mesh.device, requires_grad=True)
    intersect.reset_launch_counts()
    loss = torch.mean(DirectIntegrator(1, 1).render_fn(sc)(
        p, threefry.fold_in(threefry.PRNGKey(3), 0)) ** 2)
    loss.backward()
    out["step_plain"] = (loss.item(), [
        np.zeros(tuple(x.shape), np.float32) if x.grad is None
        else x.grad.cpu().numpy() for _, x in leaf_items(p)],
        dict(intersect.LAUNCHES))
    out["forms"] = step_forms(mesh, timed, reps)
    return out
