from .base import Integrator
from .direct import DirectIntegrator

__all__ = ["DirectIntegrator", "Integrator"]
