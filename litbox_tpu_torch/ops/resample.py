"""Bilinear resampling of a field at arbitrary points (counterpart of the JAX
package's ops/resample.py::gather_bilinear_mxu).

The JAX package writes the sample as factorized tent-weight matmuls because
the TPU's matrix unit is its fastest gather, and it rounds the field and the
row weights to bf16 by default. Here it is a direct 4-tap gather computed in
float32 throughout, so it agrees with `gather_bilinear_mxu(precision="f32")`
and differs from the bf16 default by bf16 rounding. This is not a TPU kernel
(no `pallas_call`), so plain PyTorch is its port.
"""

from __future__ import annotations

import torch


def gather_bilinear(field: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Sample field (H, W[, C]) at points (P, 2) = (x, y) texel coords -> (P[, C]).

    Texel centers at integer + 0.5; a tap outside the field has weight 0, so
    samples off the field fade to 0 (the tent weights of the JAX version).
    """
    squeeze = field.ndim == 2
    if squeeze:
        field = field[..., None]
    h, w, c = field.shape
    flat = field.reshape(h * w, c)
    x = points[:, 0] - 0.5
    y = points[:, 1] - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    ix0 = x0.long()
    iy0 = y0.long()
    out = torch.zeros((points.shape[0], c), dtype=torch.float32, device=field.device)
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        iy = iy0 + dy
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            ix = ix0 + dx
            inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            idx = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1))
            wgt = torch.where(inside, wy * wx, 0.0)
            out += flat[idx] * wgt[:, None]
    return out[:, 0] if squeeze else out
