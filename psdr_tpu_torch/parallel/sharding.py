"""Data-parallel Monte-Carlo rendering over the ranks of a process group.

Counterpart of ``psdr_tpu/parallel/sharding.py`` on ``torch.distributed``.
Monte-Carlo estimators are linear in their sample count, so splitting the
samples over ranks is exact: every rank renders the whole image from its
share of the samples under its own fold of the key (``threefry.fold_in(key,
rank)``, bit for bit the JAX package's ``fold_in(key, d)``), and the mean of
the ranks' partial images is the full-budget estimator. The scene is
replicated; the only collectives are the sum of the partial images and the
sum of the parameter gradients.

``jax.sharding.Mesh`` becomes ``DeviceMesh``: the group, this process's
rank in it, the group's size, the device this rank renders on and an axis
name. ``device_mesh()`` reads it from the initialized default group.

Gradients follow the JAX package's explicit-VJP scheme: each rank renders
its partial image with autograd on, the mean image is summed from detached
copies, the loss's cotangent (an analytic constant of the mean image, the
same on every rank) goes into the local partial's backward, and each
gradient leaf is then summed over the ranks. The cotangent is never reduced
by a collective's backward: it is already replicated, and reducing it again
would multiply it by the rank count (the trap
``psdr_tpu/parallel/sharding.py:197-200`` records).

The train steps run as captured programs (``program.py``), the JAX
package's jitted steps, in one of two forms that the group's backend
decides (``DeviceMesh.captures_collectives``): over NCCL, whose
collectives a CUDA graph can hold, the whole step is one program; over
gloo, which copies through the host, the step is programs around its
collectives, and the collectives run between them.
"""
from __future__ import annotations

import copy
import dataclasses
import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..convert import params_from_numpy
from ..core import threefry
from ..opt import adam, apply_updates, tree_leaves, tree_unflatten
from ..program import Program, VJPProgram


class DeviceMesh(NamedTuple):
    """The ranks of one process group along one data-parallel axis."""
    group: Optional[object]     # a ProcessGroup; None: the default group
    rank: int
    size: int
    device: torch.device
    axis_name: str = "dp"

    def all_reduce(self, tensor: torch.Tensor, async_op: bool = False):
        """Sum ``tensor`` over the ranks, in place."""
        return dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=self.group,
                               async_op=async_op)

    def captures_collectives(self) -> bool:
        """Whether a CUDA graph can hold this group's collectives: NCCL's
        can, gloo's (through the host) cannot."""
        return dist.get_backend(self.group) == "nccl"


def device_mesh(axis_name: str = "dp", device=None) -> DeviceMesh:
    """The mesh of the initialized default process group. ``device``
    defaults to this rank's card (``LOCAL_RANK``, else the rank, modulo
    the cards of this host); there is no CPU fallback (pass
    ``device="cpu"`` for that)."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized "
                           "(initialize_distributed)")
    rank = dist.get_rank()
    size = dist.get_world_size()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to render "
                               "on the CPU")
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return DeviceMesh(None, rank, size, torch.device(device), axis_name)


def initialize_distributed(backend: str, init_method: str = "env://",
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Join the process group: ``backend`` is "gloo" (CPU tensors, and CUDA
    tensors through the host; several ranks may share one card) or "nccl"
    (one card a rank). ``init_method`` is "env://" (``torchrun`` sets
    ``MASTER_ADDR``, ``RANK``, ``WORLD_SIZE``) or an address such as
    "tcp://localhost:29500", with ``num_processes`` and ``process_id``.

    NCCL with more ranks on this host than it has cards raises: NCCL cannot
    put two ranks on one card, and the backend is never switched
    silently."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', not {backend!r}")
    if backend == "nccl":
        world = (num_processes if num_processes is not None
                 else int(os.environ.get("WORLD_SIZE", "1")))
        on_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        cards = torch.cuda.device_count()
        if on_host > cards:
            raise RuntimeError(f"nccl needs a card a rank: {on_host} ranks on "
                               f"this host, {cards} cards")
        rank = process_id if process_id is not None else int(
            os.environ.get("RANK", "0"))
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) % cards)
    kwargs = {}
    if num_processes is not None:
        kwargs = dict(world_size=num_processes, rank=process_id)
    dist.init_process_group(backend, init_method=init_method, **kwargs)


def _scaled_opts_scene(scene, n_dev: int):
    """A shallow scene copy whose sample budgets are 1/n_dev."""
    opts = scene.opts
    local = copy.copy(scene)
    local.opts = dataclasses.replace(opts, spp=opts.spp // n_dev,
                                     sppe=opts.sppe // n_dev,
                                     sppse=opts.sppse // n_dev)
    return local


def _budgets_divisible(opts, n_dev: int) -> bool:
    return all(v % n_dev == 0 for v in (opts.spp, opts.sppe, opts.sppse))


def per_device_render_fn(integrator, scene, n_dev: int, sensor_id: int = 0,
                         with_boundary: bool = True, mode: str = "auto"):
    """Rank ``d``'s partial render ``g(params, key, d) -> (num_pixels, 3)``,
    whose mean over d = 0 .. n_dev - 1 is the full-budget estimator. A loop
    over d runs the same arithmetic in one process (the serial emulation the
    tests hold the sharded steps to).

    ``mode``: "budget" splits spp, sppe and sppse over the ranks (each must
    divide); "lanes" gives every rank a contiguous 1/n_dev slice of each
    term's full-budget lane domain (``base.shard_lane_range``), exact for
    any sample count, and scales it by n_dev; "auto" takes "budget" where
    the budgets divide."""
    if mode == "auto":
        mode = "budget" if _budgets_divisible(scene.opts, n_dev) else "lanes"
    scene.prepare_accel()
    if mode == "budget":
        if not _budgets_divisible(scene.opts, n_dev):
            raise ValueError(f"budget mode: {n_dev} ranks do not divide the "
                             f"sample counts of {scene.opts}")
        local_scene = _scaled_opts_scene(scene, n_dev)

        def g(params, key, d):
            flat = local_scene.build(params)
            return integrator.radiance_image(local_scene, flat, sensor_id,
                                             threefry.fold_in(key, d),
                                             with_boundary)
    elif mode == "lanes":
        def g(params, key, d):
            flat = scene.build(params)
            # the slices sum to the estimator; times n_dev, their mean does
            return n_dev * integrator.radiance_image(
                scene, flat, sensor_id, threefry.fold_in(key, d),
                with_boundary, shard=(d, n_dev))
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return g


class _MeanOverRanks(torch.autograd.Function):
    """The mean of the ranks' partial images. Its backward hands this
    rank's partial its share of the (replicated) cotangent, 1/n, through no
    collective: the parameter gradients are summed over the ranks after the
    backward (``reduce_gradients``)."""

    @staticmethod
    def forward(ctx, img_local, mesh):
        ctx.n = mesh.size
        img = img_local.detach().clone()
        mesh.all_reduce(img)
        return img / mesh.size

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.n, None


def shard_render_fn(integrator, scene, mesh: DeviceMesh, sensor_id: int = 0,
                    with_boundary: bool = True, mode: str = "auto"):
    """``f(params, key) -> (num_pixels, 3)``: this rank's partial image
    (``per_device_render_fn``) summed over the ranks and divided by their
    count, the same image on every rank. Under autograd a backward leaves
    this rank's share of the gradient in ``params``; sum it over the ranks
    with ``reduce_gradients`` for the full gradient."""
    g = per_device_render_fn(integrator, scene, mesh.size, sensor_id,
                             with_boundary, mode)

    def render(params, key):
        return _MeanOverRanks.apply(g(params, key, mesh.rank), mesh)
    return render


def reduce_gradients(grads: list, mesh: DeviceMesh,
                     overlap: bool = False) -> list:
    """Sum gradient tensors over the ranks, in place. ``overlap=False``: one
    flattened bucket, one all-reduce. ``overlap=True``: one asynchronous
    all-reduce a tensor, the largest first, all waited on before return
    (the JAX package's per-leaf psums in descending size). Both give the
    same numbers, up to the order of the sums."""
    if not overlap:
        flat = torch.cat([g.reshape(-1) for g in grads])
        mesh.all_reduce(flat)
        out, at = [], 0
        for g in grads:
            out.append(flat[at:at + g.numel()].view_as(g))
            at += g.numel()
        return out
    order = sorted(range(len(grads)), key=lambda i: -grads[i].numel())
    works = [mesh.all_reduce(grads[i], async_op=True) for i in order]
    for w in works:
        w.wait()
    return grads


def replicate_scene_params(params, mesh: DeviceMesh):
    """The params tree on ``mesh.device`` with rank 0's values on every
    rank (a broadcast from rank 0, leaf by leaf)."""
    out = params_from_numpy(params, mesh.device)
    src = dist.get_global_rank(mesh.group, 0) if mesh.group is not None else 0
    for leaf in tree_leaves(out):
        dist.broadcast(leaf, src=src, group=mesh.group)
    return out


def _value_and_local_grads(render_local, params, cot_of):
    """Render this rank's image with autograd on every leaf of ``params``,
    take the loss and the cotangent from ``cot_of(img_local) -> (loss,
    cot)`` and run the local backward. Returns (loss, gradient leaves)."""
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    img_local = render_local(tree_unflatten(params, leaves))
    loss, cot = cot_of(img_local.detach())
    grads = torch.autograd.grad(img_local, leaves, cot, allow_unused=True)
    return loss, [torch.zeros_like(x) if g is None else g
                  for x, g in zip(leaves, grads)]


def _update_program(optimizer) -> Program:
    """``optimizer``'s update and its application as a program over
    (params, grads, opt_state) -> (params, opt_state)."""
    def update(params, grads, opt_state):
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state
    return Program(update, "train step update")


def _whole_step(render_local, cot_of, mesh, optimizer, overlap, name,
                retrace_on):
    """The step, collectives included, as one program (NCCL)."""
    def body(params, opt_state, key):
        loss, grads = _value_and_local_grads(
            lambda q: render_local(q, key), params, cot_of)
        grads = tree_unflatten(params, reduce_gradients(grads, mesh, overlap))
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss
    prog = Program(body, name, grad=True, retrace_on=retrace_on)

    def step(params, opt_state, key):
        return prog(params, opt_state, key.to(mesh.device))
    step.programs = (prog,)
    return step


def make_train_step(integrator, scene, mesh: DeviceMesh, target_image,
                    optimizer=None, sensor_id: int = 0,
                    with_boundary: bool = True, overlap: bool = False):
    """The data-parallel inverse-rendering step. Returns ``(step,
    opt_state)``; ``step(params, opt_state, key) -> (params, opt_state,
    loss)`` renders over the ranks, takes the L2 loss of the mean image
    against ``target_image`` ((num_pixels, 3), the same on every rank),
    backpropagates (every leaf: geometry, materials, emitters, sensors),
    sums the gradients over the ranks and applies one update of
    ``optimizer`` (``opt.adam(1e-2)`` by default; an ``(init, update)``
    pair of ``opt``). ``overlap`` chooses ``reduce_gradients``' schedule;
    the numbers are the same.

    The step runs as captured programs (``step.programs``). Over NCCL the
    whole step is one, its all-reduces inside (the warm-up's all-reduces
    create the communicator before the capture). Over gloo the image's
    all-reduce falls between the forward and the backward: the forward is
    one graph whose saved tensors stay in its pool and the backward one
    fed the cotangent (a ``VJPProgram``); the all-reduces of the image and
    of the gradients run eagerly, and the update is a third program. The
    key may lie on the host; the step moves it to the mesh's device."""
    if optimizer is None:
        optimizer = adam(1e-2)
    target = torch.as_tensor(target_image, dtype=torch.float32,
                             device=mesh.device)
    n_dev = mesh.size
    g = per_device_render_fn(integrator, scene, n_dev, sensor_id,
                             with_boundary)

    def cot_of(img_local):
        img = img_local.clone()
        mesh.all_reduce(img)
        diff = img / n_dev - target
        loss = torch.mean(diff * diff)
        return loss, 2.0 * diff / (diff.numel() * n_dev)

    state = optimizer.init(params_from_numpy(scene.params(), mesh.device))
    if mesh.captures_collectives():
        return _whole_step(lambda q, key: g(q, key, mesh.rank), cot_of, mesh,
                           optimizer, overlap, "make_train_step",
                           lambda: scene.accel_version), state
    forward = VJPProgram(lambda q, key: g(q, key, mesh.rank),
                         "make_train_step forward",
                         retrace_on=lambda: scene.accel_version)
    update = _update_program(optimizer)

    def step(params, opt_state, key):
        img_local = forward(params, key.to(mesh.device))
        loss, cot = cot_of(img_local)
        grads = tree_unflatten(params, reduce_gradients(
            tree_leaves(forward.vjp(cot)), mesh, overlap))
        params, opt_state = update(params, grads, opt_state)
        return params, opt_state, loss
    step.programs = (forward, update)
    return step, state


# -- multi-view (sensor-parallel) inverse rendering -------------------------

def _select_sensor(flat, view: int):
    """The flat scene with sensor ``view`` as its only sensor (index 0).
    The JAX package stacks the sensors to index them with a traced device
    index (``_stack_sensors``); a rank's view is a host integer here, so
    it is picked directly."""
    return flat._replace(sensors=(flat.sensors[view],))


def make_multiview_train_step(integrator, scene, mesh: DeviceMesh, targets,
                              optimizer=None, with_boundary: bool = True):
    """The multi-view inverse-rendering step: rank d renders view ``d %
    n_views`` at the full sample budget under ``fold_in(key, d)`` against
    ``targets[d % n_views]``. The loss is the mean over ranks of the
    per-view L2 (the mean over views, each view's ranks weighted alike),
    the gradients are summed over the ranks (one asynchronous all-reduce
    a leaf, largest first) and the update runs on every rank. Needs the
    rank count to be a multiple of the view count (a view's replicas draw
    independent folds, which lowers its variance). Returns ``(step,
    opt_state)`` as ``make_train_step``.

    Over NCCL the whole step is one captured program; over gloo one
    program renders this rank's view and takes its loss and gradients (the
    view's cotangent is local), the loss's and the gradients' all-reduces
    run eagerly, and the update is a second program."""
    if optimizer is None:
        optimizer = adam(1e-2)
    n_dev = mesh.size
    n_views = scene.num_sensors
    if n_dev % n_views:
        raise ValueError(f"{n_dev} ranks cannot evenly cover {n_views} views")
    if len(targets) != n_views:
        raise ValueError(f"{len(targets)} targets for {n_views} views")
    view = mesh.rank % n_views
    target = torch.as_tensor(targets[view], dtype=torch.float32,
                             device=mesh.device)
    scene.prepare_accel()

    def render_local(q, key):
        flat = _select_sensor(scene.build(q), view)
        return integrator.radiance_image(scene, flat, 0,
                                         threefry.fold_in(key, mesh.rank),
                                         with_boundary)

    def local_cot_of(img):
        diff = img - target
        return (torch.mean(diff * diff).reshape(1),
                2.0 * diff / (diff.numel() * n_dev))

    def cot_of(img):
        loss, cot = local_cot_of(img)
        mesh.all_reduce(loss)
        return loss[0] / n_dev, cot

    state = optimizer.init(params_from_numpy(scene.params(), mesh.device))
    if mesh.captures_collectives():
        return _whole_step(render_local, cot_of, mesh, optimizer, True,
                           "make_multiview_train_step",
                           lambda: scene.accel_version), state

    def local(params, key):
        return _value_and_local_grads(lambda q: render_local(q, key),
                                      params, local_cot_of)
    local_prog = Program(local, "make_multiview_train_step local",
                         grad=True, retrace_on=lambda: scene.accel_version)
    update = _update_program(optimizer)

    def step(params, opt_state, key):
        loss, grads = local_prog(params, key.to(mesh.device))
        mesh.all_reduce(loss)
        grads = tree_unflatten(params, reduce_gradients(grads, mesh, True))
        params, opt_state = update(params, grads, opt_state)
        return params, opt_state, loss[0] / n_dev
    step.programs = (local_prog, update)
    return step, state
