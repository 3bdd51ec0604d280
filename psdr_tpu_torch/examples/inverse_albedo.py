"""Inverse rendering: recover a sphere's albedo from a target image (Adam
on ``BSDF[id=white].reflectance`` through ``opt.Optimizer``). The target
renders as a program; each step's gradient runs eagerly and its Adam update
as the optimizer's program, as in the JAX package.

``examples/inverse_albedo.py`` of the JAX package.

Usage: python -m psdr_tpu_torch.examples.inverse_albedo [iters]
       [--out DIR] [--device cuda|cpu] [--small]
"""
import json
import os
import sys

import numpy as np
import torch

from psdr_tpu_torch import DirectIntegrator
from psdr_tpu_torch.convert import params_from_numpy
from psdr_tpu_torch.core import threefry
from psdr_tpu_torch.core.bitmap import Bitmap
from psdr_tpu_torch.examples import out_dir, parser
from psdr_tpu_torch.opt import Optimizer
from psdr_tpu_torch.testing.scenes import sphere_light_scene


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("iters", nargs="?", type=int, default=100)
    args = p.parse_args(argv)
    out = out_dir(args)
    size, spp = (16, 2) if args.small else (64, 8)
    scene = sphere_light_scene(width=size, height=size, spp=spp,
                               device=args.device)
    integ = DirectIntegrator(1, 1)
    render = integ.render_fn(scene, with_boundary=False)
    target = integ.render_program(scene, with_boundary=False, detached=True)(
        params_from_numpy(scene.params(), args.device),
        threefry.PRNGKey(1234, device=args.device))
    print("target albedo: [0.8 0.8 0.8]")

    scene.bsdfs[0].reflectance = Bitmap(np.full((1, 1, 3), 0.25, np.float32))
    opt = Optimizer(scene, ["BSDF[id=white].reflectance"], lr=5e-2)

    def loss_fn(params, key):
        return torch.mean((render(params, key) - target) ** 2)

    log = []
    for it in range(args.iters):
        loss = opt.step(loss_fn, threefry.PRNGKey(it))
        alb = opt.params["bsdfs"][0]["reflectance"].detach().cpu().numpy()
        log.append({"iter": it, "loss": loss, "albedo": alb.ravel().tolist()})
        if it % 10 == 0 or it == args.iters - 1:
            print(f"iter {it:4d}  loss {loss:.3e}  albedo "
                  f"{alb.ravel().round(3)}")
    opt.write_back()  # the recovered parameters into the scene
    with open(os.path.join(out, "inverse_albedo_log.json"), "w") as f:
        json.dump(log, f)


if __name__ == "__main__":
    sys.exit(main())
