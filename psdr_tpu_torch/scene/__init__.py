from .scene import FlatScene, Scene, detach_flat

__all__ = ["FlatScene", "Scene", "detach_flat"]
