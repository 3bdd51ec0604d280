"""AD-vs-FD derivative-image validation: d(image)/dP by forward-mode AD
(interior and boundary estimators, ``testing.run_ad``) and by central
finite differences (``testing.run_fd``), both written as EXRs.

``examples/validate_gradients.py`` of the JAX package.

Usage: python -m psdr_tpu_torch.examples.validate_gradients [mode]
       [--out DIR] [--device cuda|cpu] [--small]
  mode in: mesh_transform | mesh_rotate | vertex_transform |
           material_roughness (default mesh_transform)
"""
import os
import sys

import numpy as np

from psdr_tpu_torch import DirectIntegrator, RoughConductor
from psdr_tpu_torch.core.exr import write_exr
from psdr_tpu_torch.examples import out_dir, parser
from psdr_tpu_torch.testing import run_ad, run_fd
from psdr_tpu_torch.testing.scenes import sphere_light_scene

MODES = ("mesh_transform", "mesh_rotate", "vertex_transform",
         "material_roughness")
EPS = {"mesh_transform": 0.01, "mesh_rotate": 0.5, "vertex_transform": 0.02,
       "material_roughness": 0.01}


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("mode", nargs="?", default="mesh_transform", choices=MODES)
    args = p.parse_args(argv)
    out = out_dir(args)
    size, spp = (16, 4) if args.small else (64, 32)
    if args.mode == "material_roughness":
        # an interior-only perturbation of a rough conductor
        scene = sphere_light_scene(width=size, height=size, spp=spp,
                                   device=args.device)
        scene.bsdfs[0] = RoughConductor(alpha_u=0.2, alpha_v=0.2,
                                        bsdf_id="white")
        scene.param_map["BSDF[id=white]"] = scene.bsdfs[0]
    else:
        # boundary terms on: silhouette gradients need sppe / sppse
        scene = sphere_light_scene(width=size, height=size, spp=spp,
                                   sppe=2 if args.small else 4,
                                   sppse=4 if args.small else 16,
                                   device=args.device)
    integ = DirectIntegrator(1, 1)
    guiding = None
    if scene.opts.sppse:
        guiding = ((4, 4, 4, 1), 1) if args.small else ((8, 8, 8, 2), 2)
    ad = run_ad(scene, integ, args.mode, npass=1 if args.small else 4,
                guiding=guiding)
    fd = run_fd(scene, integ, args.mode, eps=EPS[args.mode],
                npass=2 if args.small else 16)

    write_exr(os.path.join(out, f"{args.mode}_ad.exr"), ad)
    write_exr(os.path.join(out, f"{args.mode}_fd.exr"), fd)
    err = np.abs(ad - fd) / max(np.abs(fd).max(), 1e-6)
    print(f"{args.mode}: |ad|max={np.abs(ad).max():.4f} "
          f"|fd|max={np.abs(fd).max():.4f}  rel-err "
          f"p50={np.percentile(err, 50):.3f} p95={np.percentile(err, 95):.3f}")
    print(f"wrote {out}/{args.mode}_ad.exr and {out}/{args.mode}_fd.exr")


if __name__ == "__main__":
    sys.exit(main())
