from .base import Integrator
from .direct import DirectIntegrator
from .path import PathTracer

__all__ = ["DirectIntegrator", "Integrator", "PathTracer"]
