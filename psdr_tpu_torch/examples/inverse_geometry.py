"""Inverse rendering: recover an object's position from a target image.

Interior gradients alone cannot move a silhouette, so the loop runs the
full differentiable pipeline (interior, primary-edge and secondary-edge
boundary estimators) under Adam on a 2D offset of the sphere. The target
render and each step's loss and gradient run as programs (captured on the
card), as the JAX script jits ``render`` and ``step_grad``.

``examples/inverse_geometry.py`` of the JAX package.

Usage: python -m psdr_tpu_torch.examples.inverse_geometry [iters]
       [--out DIR] [--device cuda|cpu] [--small]
"""
import json
import os
import sys

import torch

from psdr_tpu_torch import DirectIntegrator
from psdr_tpu_torch.convert import params_from_numpy
from psdr_tpu_torch.core import threefry
from psdr_tpu_torch.examples import out_dir, parser
from psdr_tpu_torch.opt import adam, apply_updates
from psdr_tpu_torch.program import Program, value_and_grad
from psdr_tpu_torch.testing.differential import translate
from psdr_tpu_torch.testing.scenes import sphere_light_scene


def offset_params(base, offset):
    """``base`` with the sphere (mesh 0) translated by (offset, 0)."""
    mesh = dict(base["meshes"][0])
    shift = torch.cat([offset, torch.zeros(1, device=offset.device)])
    mesh["to_world"] = translate(shift) @ mesh["to_world"]
    return {**base, "meshes": [mesh] + base["meshes"][1:]}


def make_step_grad(sc, integ, base, target) -> Program:
    """The JAX script's jitted ``step_grad`` as a ``Program`` over
    ``(offset, key)``: the L2 loss of ``integ``'s render of ``sc`` with
    every boundary term, the sphere moved by the offset, against
    ``target``, and its gradient in the offset. It captures again after
    ``sc.maybe_rebuild_accel``."""
    render = integ.render_fn(sc, with_boundary=True)

    def loss_fn(offset, key):
        return torch.mean((render(offset_params(base, offset), key)
                           - target) ** 2)
    return Program(value_and_grad(loss_fn), "step_grad", grad=True,
                   retrace_on=lambda: sc.accel_version)


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("iters", nargs="?", type=int, default=60)
    args = p.parse_args(argv)
    out = out_dir(args)
    dev = args.device
    size, spp, sppse = (16, 2, 4) if args.small else (48, 8, 8)
    sc = sphere_light_scene(width=size, height=size, spp=spp, sppe=2,
                            sppse=sppse, device=dev)
    integ = DirectIntegrator(1, 1)
    base = params_from_numpy(sc.params(), dev)
    target = integ.render_program(sc, with_boundary=True, detached=False)(
        base, threefry.PRNGKey(42, device=dev))
    step_grad = make_step_grad(sc, integ, base, target)
    # the initial misplacement; the truth is (0, 0)
    state = {"offset": torch.tensor([0.35, -0.25], device=dev)}
    opt = adam(2e-2)
    opt_state = opt.init(state)
    print(f"start offset: {state['offset'].tolist()} (truth: [0, 0])")
    log = []
    for it in range(args.iters):
        loss, g = step_grad(state["offset"], threefry.PRNGKey(it, device=dev))
        updates, opt_state = opt.update({"offset": g}, opt_state)
        state = apply_updates(state, updates)
        log.append({"iter": it, "loss": loss.item(),
                    "offset": state["offset"].tolist()})
        if it % 10 == 0 or it == args.iters - 1:
            print(f"iter {it:3d}  loss {loss.item():.3e}  "
                  f"offset {state['offset'].tolist()}", flush=True)
    err = float(torch.linalg.norm(state["offset"]))
    print(f"final |offset - truth| = {err:.4f}")
    with open(os.path.join(out, "inverse_geometry_log.json"), "w") as f:
        json.dump(log, f)


if __name__ == "__main__":
    sys.exit(main())
