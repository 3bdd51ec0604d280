"""Flagship inverse-rendering recovery at benchmark scale.

Multi-view vertex recovery on the bench scene (``cbox_scene`` with the
20,492-face occluder): the occluder is deformed by a smooth bump and a
rigid shift (``testing.scenes.flagship_deform``), and masked Adam on its
raw ``vertex_positions`` recovers the shape from three rendered views
through the whole differentiable pipeline (interior, primary-edge and
secondary-edge estimators; the silhouette and shadow motion is most of the
signal). ``examples/flagship_recovery.py`` of the JAX package, whose
targets render in child processes for a reason of its TPU; here they
render in this process.

Each iteration is one captured program on the card (``make_train_step``:
the loss over the three views, the occluder's gradient, its smoothing and
the masked, scheduled Adam update, as the JAX script jits ``train_step``),
and the targets render through ``render_program``.

Every 10 iterations a checkpoint (params and optimizer state,
``flagship_recovery_ckpt.npz``); one JSON line an iteration in
``flagship_recovery_log.jsonl`` (loss, vertex RMSE against the truth, the
symmetric Chamfer distance between the vertex sets, seconds); the
recovered occluder as ``recovered_occluder.obj`` (``Mesh.dump``). The
vertex RMSE counts a vertex that slides along the surface as an error; the
Chamfer distance, the mean distance from each vertex to the nearest vertex
of the other set, both ways, does not.

Usage: python -m psdr_tpu_torch.examples.flagship_recovery [iters]
       [--out DIR] [--device cuda|cpu] [--small]
"""
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from psdr_tpu_torch import DirectIntegrator, PerspectiveCamera
from psdr_tpu_torch.convert import params_from_numpy
from psdr_tpu_torch.core import threefry
from psdr_tpu_torch.core import transform as xf
from psdr_tpu_torch.examples import out_dir, parser
from psdr_tpu_torch.opt import (adam, apply_updates, exponential_decay,
                                masked, tree_leaves, tree_map, tree_unflatten)
from psdr_tpu_torch.program import Program
from psdr_tpu_torch.testing.scenes import cbox_scene, flagship_deform

OCCLUDER = 5  # the mesh index of the sphere in cbox_scene


def build_scene(small: bool, device):
    """The bench scene with two more views: the box is open toward +z, so
    the cameras stay on that side, displaced; silhouettes move differently
    in each view, which makes the vertex recovery well posed."""
    if small:
        sc = cbox_scene(width=48, height=48, spp=8, occluder_subdiv=2,
                        device=device)
        sc.opts = dataclasses.replace(sc.opts, sppe=2, sppse=16)
    else:
        sc = cbox_scene(width=256, height=256, spp=16, occluder_subdiv=5,
                        device=device)
        sc.opts = dataclasses.replace(sc.opts, sppe=4, sppse=32)
    for eye in ([1.2, 0.7, 3.3], [-1.1, -0.6, 3.3]):
        cam = PerspectiveCamera(fov_x=39.0, near=0.01, far=100.0)
        cam.set_transform(np.asarray(xf.look_at(eye, [0, 0, 0], [0, 1, 0])))
        sc.add_sensor(cam)
    return sc


def laplacian_smoother(faces: np.ndarray, nv: int, device, rounds: int = 10,
                       lam: float = 0.9):
    """Gradient smoothing with uniform weights over the mesh's edges: raw
    per-vertex Monte-Carlo gradients are sparse (silhouette rims) and
    noisy; ``rounds`` diffusions over the 1-ring precondition the descent
    toward smooth deformations (Nicolet et al. 2021's idea in its simplest
    form), the class of deformation here."""
    f = np.asarray(faces, np.int64)
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    e = np.unique(np.sort(e, axis=1), axis=0)
    src = torch.as_tensor(np.concatenate([e[:, 0], e[:, 1]]), device=device)
    dst = torch.as_tensor(np.concatenate([e[:, 1], e[:, 0]]), device=device)
    deg = torch.clamp(torch.zeros(nv, device=device).index_add_(
        0, dst, torch.ones(dst.shape, device=device)), min=1.0)

    def smooth(g: torch.Tensor) -> torch.Tensor:
        for _ in range(rounds):
            nb = torch.zeros_like(g).index_add_(0, dst, g[src]) / deg[:, None]
            g = (1.0 - lam) * g + lam * nb
        return g
    return smooth


def render_targets(sc, integ, truth) -> list:
    """One target a view at the true shape, each under its own key, each
    through its ``render_program`` (the JAX script's jitted render)."""
    dev = tree_leaves(truth)[0].device
    return [integ.render_program(sc, s, with_boundary=False, detached=True)(
        truth, threefry.PRNGKey(1000 + s, device=dev))
        for s in range(sc.num_sensors)]


def make_loss(sc, integ, targets):
    """``loss(params, key)``: the mean over views of each view's L2 under
    ``fold_in(key, view)``."""
    renders = [integ.render_fn(sc, s, with_boundary=True)
               for s in range(sc.num_sensors)]

    def loss(params, key):
        total = 0.0
        for s, render in enumerate(renders):
            img = render(params, threefry.fold_in(key, s))
            total = total + torch.mean((img - targets[s]) ** 2)
        return total / len(renders)
    return loss


def chamfer(a: torch.Tensor, b: torch.Tensor, block: int = 4096) -> float:
    """Symmetric Chamfer distance of two point sets: the mean of each
    point's distance to the nearest point of the other set, both ways,
    halved."""
    def one_way(x, y):
        # the direct difference: the matmul form loses ~1e-4 to cancellation
        return torch.cat([torch.cdist(
            x[i:i + block], y,
            compute_mode="donot_use_mm_for_euclid_dist").min(dim=1).values
            for i in range(0, x.shape[0], block)]).mean()
    return float(0.5 * (one_way(a, b) + one_way(b, a)))


def make_train_step(sc, loss_fn, smooth, optimizer) -> Program:
    """The JAX script's jitted ``train_step`` as one ``Program`` (its
    backward captured with it on the card): ``step(params, opt_state, key)
    -> (params, opt_state, loss, raw gradient)``: the loss and the
    occluder's vertex gradient (the only leaf that carries a graph),
    smoothed, then the masked update at the schedule's rate for the
    state's device count. The key lies on the params' device. ``loss_fn``
    builds ``sc``; the program captures again after
    ``sc.maybe_rebuild_accel``."""
    def train_step(params, opt_state, key):
        live = tree_map(lambda x: x, params)
        v = params["meshes"][OCCLUDER]["vertex_positions"].detach()
        live["meshes"][OCCLUDER] = dict(
            live["meshes"][OCCLUDER], vertex_positions=v.requires_grad_(True))
        loss = loss_fn(live, key)
        (g,) = torch.autograd.grad(loss, [v])
        grads = tree_map(torch.zeros_like, params)
        grads["meshes"][OCCLUDER]["vertex_positions"] = smooth(g)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss.detach(), g
    return Program(train_step, "flagship train_step", grad=True,
                   retrace_on=lambda: sc.accel_version)


def save_ckpt(path, params, opt_state) -> None:
    """Params and optimizer state in one .npz."""
    leaves = (tree_leaves(params) + tree_leaves(opt_state["mu"])
              + tree_leaves(opt_state["nu"]))
    np.savez(path, n=len(leaves), count=int(opt_state["count"]),
             **{f"leaf_{i}": x.detach().cpu().numpy()
                for i, x in enumerate(leaves)})


def load_ckpt(path, params, opt_state):
    """(params, opt_state) from ``save_ckpt``'s file for the same trees."""
    data = np.load(path)
    like = (params, opt_state["mu"], opt_state["nu"])
    n = [len(tree_leaves(t)) for t in like]
    if int(data["n"]) != sum(n):
        raise ValueError("checkpoint does not match the params tree")
    dev = tree_leaves(params)[0].device
    leaves = [torch.tensor(data[f"leaf_{i}"], device=dev)
              for i in range(sum(n))]
    p = tree_unflatten(params, leaves[:n[0]])
    mu = tree_unflatten(params, leaves[n[0]:n[0] + n[1]])
    nu = tree_unflatten(params, leaves[n[0] + n[1]:])
    count = torch.tensor(int(data["count"]), dtype=torch.int32, device=dev)
    return p, {"count": count, "mu": mu, "nu": nu}


def run(iters: int, out: str, small: bool, device, on_iter=None) -> dict:
    """The recovery loop; ``on_iter(record, raw_gradient)`` is called after
    each step. Returns the summary the log ends with."""
    log_path = os.path.join(out, "flagship_recovery_log.jsonl")
    ckpt_path = os.path.join(out, "flagship_recovery_ckpt.npz")
    sc = build_scene(small, device)
    integ = DirectIntegrator(1, 1)
    sc.prepare_accel()
    truth = params_from_numpy(sc.params(), device)
    v_true = truth["meshes"][OCCLUDER]["vertex_positions"]

    t0 = time.perf_counter()
    targets = render_targets(sc, integ, truth)
    t_targets = time.perf_counter() - t0

    params = tree_map(lambda x: x.clone(), truth)
    params["meshes"][OCCLUDER]["vertex_positions"] = torch.as_tensor(
        flagship_deform(v_true.cpu().numpy()), device=device)
    loss_fn = make_loss(sc, integ, targets)
    occ = sc.meshes[OCCLUDER]
    smooth = laplacian_smoother(occ.faces, v_true.shape[0], device)

    # only the occluder's vertices move; the vertex gap closes in ~10
    # steps of ~lr each, after which the gradient is mostly Monte-Carlo
    # noise: decay the rate rather than walk around the optimum
    mask = tree_map(torch.zeros_like, params)
    mask["meshes"][OCCLUDER]["vertex_positions"] = torch.ones_like(v_true)
    optimizer = masked(adam(exponential_decay(1e-2, max(iters, 1), 0.05)),
                       mask)
    opt_state = optimizer.init(params)
    train_step = make_train_step(sc, loss_fn, smooth, optimizer)

    def vert_rmse(p):
        d = p["meshes"][OCCLUDER]["vertex_positions"] - v_true
        return float(torch.sqrt(torch.mean(torch.sum(d * d, dim=1))))

    def vert_chamfer(p):
        return chamfer(p["meshes"][OCCLUDER]["vertex_positions"], v_true)

    rmse0, chamfer0 = vert_rmse(params), vert_chamfer(params)
    o = sc.opts
    with open(log_path, "w") as f:
        f.write(json.dumps({
            "event": "start", "iters": iters, "views": sc.num_sensors,
            "vertices": int(v_true.shape[0]), "faces": int(occ.num_faces),
            "opts": [o.width, o.spp, o.sppe, o.sppse], "device": str(device),
            "target_seconds": t_targets, "rmse0": rmse0,
            "chamfer0": chamfer0}) + "\n")

    on_card = torch.device(device).type == "cuda"
    t_start, step_seconds = time.perf_counter(), 0.0
    for i in range(iters):
        t0 = time.perf_counter()
        params, opt_state, loss, g = train_step(
            params, opt_state, threefry.PRNGKey(i, device=device))
        if on_card:
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        step_seconds += dt
        rec = {"iter": i, "loss": loss.item(),
               "vertex_rmse": vert_rmse(params),
               "chamfer": vert_chamfer(params), "seconds": dt}
        with open(log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)
        if on_iter is not None:
            on_iter(rec, g)
        if (i + 1) % 10 == 0:
            save_ckpt(ckpt_path, params, opt_state)

    total = time.perf_counter() - t_start
    rmse1 = vert_rmse(params)
    occ.vertex_positions = (params["meshes"][OCCLUDER]["vertex_positions"]
                            .cpu().numpy())
    occ.dump(os.path.join(out, "recovered_occluder.obj"))
    chamfer1 = vert_chamfer(params)
    # an iteration's seconds: the step alone (the metrics, the log and the
    # checkpoints are in the wall time)
    summary = {"event": "done", "iters": iters, "wall_seconds": total,
               "seconds_per_iter": step_seconds / max(iters, 1),
               "rmse0": rmse0, "rmse_final": rmse1,
               "rmse_reduction": rmse0 / max(rmse1, 1e-9),
               "chamfer0": chamfer0, "chamfer_final": chamfer1,
               "chamfer_reduction": chamfer0 / max(chamfer1, 1e-9)}
    with open(log_path, "a") as f:
        f.write(json.dumps(summary) + "\n")
    print(json.dumps(summary), flush=True)
    return summary


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("iters", nargs="?", type=int, default=60)
    args = p.parse_args(argv)
    run(args.iters, out_dir(args), args.small, torch.device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
