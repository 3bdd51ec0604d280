from .area import AreaLight
from .envmap import EnvironmentMap

__all__ = ["AreaLight", "EnvironmentMap"]
