"""Texture sampling (counterpart of the JAX package's core/sampling.py).

Conventions: fields are (H, W[, C]) tensors indexed [y, x]; continuous
positions are in texel units with texel centers at (i + 0.5); `uv` variants
take [0, 1] coordinates like the reference's samplers.
"""

from __future__ import annotations

import torch


def sample_bilinear(field: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Linear-clamp sample at texel coords (..., 2) = (x, y).

    Matches GPU bilinear filtering: texel centers at integer+0.5.
    """
    h, w = field.shape[0], field.shape[1]
    x = xy[..., 0] - 0.5
    y = xy[..., 1] - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    if field.ndim == 3:
        fx, fy = fx[..., None], fy[..., None]
    ix0 = x0.long().clamp(0, w - 1)
    iy0 = y0.long().clamp(0, h - 1)
    ix1 = (ix0 + 1).clamp(0, w - 1)
    iy1 = (iy0 + 1).clamp(0, h - 1)
    top = field[iy0, ix0] * (1 - fx) + field[iy0, ix1] * fx
    bot = field[iy1, ix0] * (1 - fx) + field[iy1, ix1] * fx
    return top * (1 - fy) + bot * fy


def sample_bilinear_uv(field: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    size = torch.tensor([field.shape[1], field.shape[0]], dtype=torch.float32,
                        device=uv.device)
    return sample_bilinear(field, uv * size)
