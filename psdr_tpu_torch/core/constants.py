"""Numerical constants, with the JAX package's values
(``psdr_tpu/core/constants.py``)."""
import math

Epsilon = 1e-5
RayEpsilon = 1e-3      # minimum ray distance to avoid self-intersection
ShadowEpsilon = 1e-3
EdgeEpsilon = 1e-5

E = math.e
Pi = math.pi
InvPi = 1.0 / math.pi
InvTwoPi = 0.5 / math.pi
InvFourPi = 0.25 / math.pi
SqrtPi = math.sqrt(math.pi)
InvSqrtPi = 1.0 / math.sqrt(math.pi)
TwoPi = 2.0 * math.pi
HalfPi = 0.5 * math.pi

Infinity = float("inf")
