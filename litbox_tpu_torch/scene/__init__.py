from .gbuffer import build_pyramid, rasterize
from .scene import Lights, Scene, SceneBuilder, Shapes

__all__ = ["Lights", "Scene", "SceneBuilder", "Shapes", "build_pyramid", "rasterize"]
