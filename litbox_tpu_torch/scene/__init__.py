from .gbuffer import rasterize
from .scene import Lights, Scene, SceneBuilder, Shapes

__all__ = ["Lights", "Scene", "SceneBuilder", "Shapes", "rasterize"]
