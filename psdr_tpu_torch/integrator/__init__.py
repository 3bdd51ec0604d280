from .base import Integrator
from .direct import DirectIntegrator
from .field import FieldExtractionIntegrator
from .path import PathTracer

__all__ = ["DirectIntegrator", "FieldExtractionIntegrator", "Integrator",
           "PathTracer"]
