"""psdr_tpu_torch: the PyTorch + CUDA port of psdr_tpu.

Imports torch and never jax. The JAX package ``psdr_tpu`` stays the
reference each ported module is tested against. Ported so far: the forward
render and the gradients (interior and boundary terms, guiding) of
``DirectIntegrator`` and ``PathTracer``, the AOV integrator, diffuse and
rough-conductor materials, image textures, authored vertex normals, area
lights and the environment map, the XML loader with OBJ and EXR IO, the
masked-Adam ``opt.Optimizer`` and the AD-vs-FD harness (``testing``), the
sharded render and train steps on ``torch.distributed`` (``parallel``) and
the six examples (``examples``), with the intersection kernels
(``accel/intersect.py``, ``csrc/*.cu``) and the random stream's
(``csrc/rng.cu``) written by hand for Hopper, and
the forward renders as captured CUDA graphs (``program.py``; renderC,
renderD and ``render_program``), their random keys on the device.
"""
__version__ = "0.1.0"

from .core.records import RenderOptions
from .scene import Scene
from .scene.loader import load_file, load_integrator, load_string
from .shape import Mesh, load_obj
from .shape import primitives
from .bsdf import Diffuse, RoughConductor
from .emitter import AreaLight, EnvironmentMap
from .sensor import PerspectiveCamera
from .integrator import (DirectIntegrator, FieldExtractionIntegrator,
                         PathTracer)
from . import opt
