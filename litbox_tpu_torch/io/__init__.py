from .exr import read_exr, read_exr_rgb, write_exr, write_exr_rgb
from .images import read_image_linear, read_png_linear, write_png

__all__ = [
    "read_exr", "read_exr_rgb", "write_exr", "write_exr_rgb",
    "read_image_linear", "read_png_linear", "write_png",
]
