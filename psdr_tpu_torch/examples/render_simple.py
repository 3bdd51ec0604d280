"""Forward-render the Cornell-box test scene and write EXRs.

``examples/render_simple.py`` of the JAX package: the npass-averaged
``renderC`` (``testing.run_orig``) and two AOV passes.

Usage: python -m psdr_tpu_torch.examples.render_simple [--out DIR]
       [--device cuda|cpu] [--small]
"""
import os
import sys

import numpy as np

from psdr_tpu_torch import DirectIntegrator, FieldExtractionIntegrator
from psdr_tpu_torch.core.exr import write_exr
from psdr_tpu_torch.examples import out_dir, parser
from psdr_tpu_torch.testing import run_orig
from psdr_tpu_torch.testing.scenes import cbox_scene


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    out = out_dir(args)
    size, spp = (32, 2) if args.small else (128, 8)
    scene = cbox_scene(width=size, height=size, spp=spp, occluder_subdiv=3,
                       device=args.device)
    img = run_orig(scene, DirectIntegrator(1, 1), npass=2)
    write_exr(os.path.join(out, "cbox.exr"), img)
    print(f"wrote {out}/cbox.exr  mean={img.mean():.4f}")

    for field in ("depth", "shNormal"):
        aov = run_orig(scene, FieldExtractionIntegrator(field), npass=1)
        write_exr(os.path.join(out, f"cbox_{field}.exr"), np.abs(aov))
        print(f"wrote {out}/cbox_{field}.exr")


if __name__ == "__main__":
    sys.exit(main())
