"""Texture and LUT sampling (counterpart of the JAX package's
core/sampling.py).

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
    # Scaled per component by Python numbers: a size tensor built on the
    # device would be a host-to-device copy on every call.
    xy = torch.stack([uv[..., 0] * float(field.shape[1]),
                      uv[..., 1] * float(field.shape[0])], -1)
    return sample_bilinear(field, xy)


def sample_nearest(field: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Point-clamp sample at texel coords (..., 2) = (x, y)."""
    h, w = field.shape[0], field.shape[1]
    ix = torch.floor(xy[..., 0]).long().clamp(0, w - 1)
    iy = torch.floor(xy[..., 1]).long().clamp(0, h - 1)
    return field[iy, ix]


def sample_nearest_uv(field: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    xy = torch.stack([uv[..., 0] * float(field.shape[1]),
                      uv[..., 1] * float(field.shape[0])], -1)
    return sample_nearest(field, xy)


def sample_lut(table: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Sample a (N, C) LUT at u in [0, 1] with the reference's texel-center
    window adjustment (LUT.cs remarks: u' = 0.5/N + u*(1 - 1/N)) followed by
    linear filtering; net effect: x = u * (N - 1)."""
    n = table.shape[0]
    x = torch.clamp(u, 0.0, 1.0) * (n - 1)
    i0 = torch.floor(x).long().clamp(0, n - 2)
    f = (x - i0.to(x.dtype))[..., None]
    return table[i0] * (1 - f) + table[i0 + 1] * f


def sample_lut_mxu(table: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """sample_lut as a one-hot matmul: each row of the (B, N) weight matrix
    holds the two linear weights. The JAX version's form for the TPU's
    matrix unit; here a float32 `torch.matmul`."""
    n = table.shape[0]
    x = torch.clamp(u, 0.0, 1.0) * (n - 1)
    idx = torch.arange(n, dtype=x.dtype, device=x.device)
    w = torch.clamp(1.0 - torch.abs(x[..., None] - idx), min=0.0)
    return torch.matmul(w, table.to(torch.float32))


def gather_2d(field: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor) -> torch.Tensor:
    """Clamped integer gather from (H, W[, C])."""
    h, w = field.shape[0], field.shape[1]
    return field[iy.long().clamp(0, h - 1), ix.long().clamp(0, w - 1)]


def downsample2x_mean(img: torch.Tensor) -> torch.Tensor:
    """2x2 box downsample of (H, W[, C]); standard mip step."""
    h, w = img.shape[0] // 2, img.shape[1] // 2
    x = img[: h * 2, : w * 2]
    x = x.reshape((h, 2, w, 2) + tuple(x.shape[2:]))
    return x.mean(dim=(1, 3))
