"""Numerical constants, with the JAX package's values
(``psdr_tpu/core/constants.py``), as far as slice 1 uses them."""
import math

RayEpsilon = 1e-3      # minimum ray distance to avoid self-intersection
ShadowEpsilon = 1e-3

Pi = math.pi
InvPi = 1.0 / math.pi
