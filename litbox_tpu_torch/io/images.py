"""PNG/EXR image helpers (counterpart of the JAX package's io/images.py;
reference: Util/TextureExtensions.cs:283-350, litbox_dataset.py:60-65).

PNG reads convert sRGB to linear with the same `pow(2.2)` approximation as
`litbox_dataset.load_srgb`. PIL is imported inside the PNG functions, so
that the package (and its EXR path) imports where PIL is not installed.
"""

from __future__ import annotations

import numpy as np

from .exr import read_exr_rgb


def read_png_linear(path: str) -> np.ndarray:
    """(H, W, 3) float32 linear RGB; sRGB decoded with pow(2.2) like the reference."""
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"), dtype=np.float32) / 255.0
    return img ** 2.2


def write_png(path: str, rgb: np.ndarray, srgb_encode: bool = True) -> None:
    from PIL import Image

    rgb = np.asarray(rgb, dtype=np.float32)
    if srgb_encode:
        rgb = np.clip(rgb, 0.0, 1.0) ** (1.0 / 2.2)
    out = (np.clip(rgb, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    Image.fromarray(out).save(path)


def read_image_linear(path: str) -> np.ndarray:
    """Dispatch on extension like litbox_dataset.load_image.

    EXRs go through the native multithreaded decoder (litbox_tpu_torch.native),
    and through the Python codec when the decoder does not take the file
    (RLE, or no R, G and B channels)."""
    if path.lower().endswith(".exr"):
        from ..native import read_exr_rgb_native

        out = read_exr_rgb_native(path)
        if out is not None:
            return out
        return read_exr_rgb(path)
    return read_png_linear(path)
