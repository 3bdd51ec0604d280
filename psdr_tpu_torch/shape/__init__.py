from .mesh import Mesh

__all__ = ["Mesh"]
