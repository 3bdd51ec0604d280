"""psdr_tpu_torch: the PyTorch + CUDA port of psdr_tpu.

Imports torch and never jax. The JAX package ``psdr_tpu`` stays the
reference each ported module is tested against. This package holds slice 1:
the detached forward render of ``DirectIntegrator`` on area-lit diffuse
scenes, with the scene-intersection kernel K1 (``accel/intersect.py``,
``csrc/intersect.cu``) written by hand for Hopper.
"""
__version__ = "0.1.0"

from .core.records import RenderOptions
from .scene import Scene
from .shape import Mesh
from .shape import primitives
from .bsdf import Diffuse
from .emitter import AreaLight
from .sensor import PerspectiveCamera
from .integrator import DirectIntegrator
