from .factory import (
    DEFAULT_CONVERGENCE_PROFILE,
    DEFAULT_INPUT_PROFILES,
    TrainingFactory,
    build_scene_from_description,
    generate_random_scene_description,
)
from .substrate import SubstrateParams, generate_random, generate_texture

__all__ = [
    "DEFAULT_CONVERGENCE_PROFILE", "DEFAULT_INPUT_PROFILES", "TrainingFactory",
    "build_scene_from_description", "generate_random_scene_description",
    "SubstrateParams", "generate_random", "generate_texture",
]
