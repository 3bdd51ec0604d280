from .mesh import Mesh, load_obj

__all__ = ["Mesh", "load_obj"]
