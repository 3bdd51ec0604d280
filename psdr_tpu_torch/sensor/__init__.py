from .perspective import PerspectiveCamera

__all__ = ["PerspectiveCamera"]
