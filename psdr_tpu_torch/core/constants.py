"""Numerical constants, with the JAX package's values
(``psdr_tpu/core/constants.py``), as far as the ported slices use them."""
import math

Epsilon = 1e-5
RayEpsilon = 1e-3      # minimum ray distance to avoid self-intersection
ShadowEpsilon = 1e-3
EdgeEpsilon = 1e-5

Pi = math.pi
InvPi = 1.0 / math.pi
