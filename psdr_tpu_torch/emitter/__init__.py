from .area import AreaLight

__all__ = ["AreaLight"]
