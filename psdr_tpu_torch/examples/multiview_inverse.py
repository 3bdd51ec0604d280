"""Multi-view inverse rendering over the ranks of a process group.

N views of a displaced sphere, one view a rank
(``parallel.make_multiview_train_step``): the mean-over-views L2, the
parameter gradients summed over the ranks, masked Adam on the translation
column of the sphere's transform. ``examples/multiview_inverse.py`` of the
JAX package, whose ranks are devices of a mesh.

Usage: python -m psdr_tpu_torch.examples.multiview_inverse [iters]
       [--ranks N] [--backend gloo|nccl] [--out DIR] [--device cuda|cpu]
       [--small]

Started alone, it spawns ``--ranks`` processes (default 4, one view each)
on localhost: gloo lets them share one card or the CPU, nccl needs a card a
rank. Under ``torchrun`` (which sets ``WORLD_SIZE``) each process is one
rank: ``torchrun --nproc-per-node 4 -m
psdr_tpu_torch.examples.multiview_inverse --backend nccl``.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from psdr_tpu_torch import DirectIntegrator, PerspectiveCamera
from psdr_tpu_torch.convert import params_from_numpy
from psdr_tpu_torch.core import threefry
from psdr_tpu_torch.core import transform as xf
from psdr_tpu_torch.examples import out_dir, parser
from psdr_tpu_torch.opt import adam, masked, tree_map
from psdr_tpu_torch.parallel import (device_mesh, initialize_distributed,
                                     make_multiview_train_step, run_ranks)
from psdr_tpu_torch.testing.differential import apply_perturbation
from psdr_tpu_torch.testing.scenes import sphere_light_scene

EYES = ([6.0, 1.5, 0.0], [0.0, 1.5, 6.0], [-6.0, 1.5, 0.0])


def rank_main(args) -> dict:
    """One rank's loop; rank 0 prints and writes the log."""
    mesh = device_mesh(device="cpu" if args.device == "cpu" else None)
    n_views = min(4, mesh.size)
    size, spp, sppse = (16, 2, 4) if args.small else (32, 4, 8)
    sc = sphere_light_scene(width=size, height=size, spp=spp,
                            device=mesh.device)
    sc.opts = dataclasses.replace(sc.opts, sppe=2, sppse=sppse)
    for eye in EYES[:n_views - 1]:
        cam = PerspectiveCamera(fov_x=40.0)
        cam.set_transform(np.asarray(xf.look_at(eye, [0, 0, 0], [0, 1, 0])))
        sc.add_sensor(cam)

    integ = DirectIntegrator(1, 1)
    sc.prepare_accel()
    truth = params_from_numpy(sc.params(), mesh.device)
    with torch.no_grad():
        flat = sc.build(truth)
        targets = [integ.radiance_image(sc, flat, s,
                                        threefry.PRNGKey(1000 + s), False)
                   for s in range(n_views)]
    for t in targets:   # the same targets on every rank
        dist.broadcast(t, src=0, group=mesh.group)

    # only the sphere's translation column moves: the L2 loss also puts
    # noisy gradients on the rotation and the homogeneous row of its 4x4,
    # which Adam's per-entry normalization would amplify
    mask = tree_map(torch.zeros_like, truth)
    mask["meshes"][0]["to_world"][0:3, 3] = 1.0
    optimizer = masked(adam(5e-2), mask)
    step, opt_state = make_multiview_train_step(
        integ, sc, mesh, targets, optimizer=optimizer, with_boundary=True)

    params = apply_perturbation("mesh_transform", truth, 0.8, mesh_index=0,
                                direction=(1.0, 0.0, 0.0))
    log = []
    for i in range(args.iters):
        params, opt_state, loss = step(params, opt_state,
                                       threefry.PRNGKey(i))
        log.append({"iter": i, "loss": loss.item()})
        if mesh.rank == 0 and (i % 5 == 0 or i == args.iters - 1):
            print(f"iter {i:4d}  loss {loss.item():.4e}", flush=True)
    off = max(float((a - b).abs().max()) for m, t in zip(params["meshes"],
                                                          truth["meshes"])
              for a, b in zip(m.values(), t.values()))
    summary = {"ranks": mesh.size, "views": n_views, "iters": args.iters,
               "losses": [r["loss"] for r in log],
               "max_abs_param_error": off}
    if mesh.rank == 0:
        print(f"final max |param - truth| over mesh leaves = {off:.4f}",
              flush=True)
        with open(os.path.join(args.out, "multiview_inverse_log.json"),
                  "w") as f:
            json.dump(summary, f)
    return summary


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("iters", nargs="?", type=int, default=30)
    p.add_argument("--ranks", type=int, default=4,
                   help="processes to spawn when not under torchrun")
    p.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    args = p.parse_args(argv)
    out_dir(args)
    if "WORLD_SIZE" in os.environ:   # started by torchrun: one rank
        initialize_distributed(args.backend, "env://")
        try:
            rank_main(args)
        finally:
            dist.destroy_process_group()
        return 0
    threads = max(1, (os.cpu_count() or 1) // args.ranks)
    run_ranks(rank_main, args.ranks, args.backend, args=(args,),
              timeout=24 * 3600, threads=threads)
    return 0


if __name__ == "__main__":
    sys.exit(main())
