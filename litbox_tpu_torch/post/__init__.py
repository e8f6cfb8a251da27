from .compositor import composite_additive, composite_premultiplied
from .tonemap import UchimuraShape, UE5Shape, srgb_encode, tonemap_uchimura, tonemap_ue5
from .tracer_post import compute_cv_and_mips, importance_pyramid, measure_convergence

__all__ = [
    "composite_additive", "composite_premultiplied",
    "UchimuraShape", "UE5Shape", "srgb_encode", "tonemap_uchimura", "tonemap_ue5",
    "compute_cv_and_mips", "importance_pyramid", "measure_convergence",
]
