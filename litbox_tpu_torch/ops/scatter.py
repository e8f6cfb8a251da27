"""Splat a deposit stream into a lightmap (counterpart of the JAX package's
ops/scatter.py, the replacement for the reference's InterlockedAdd writes,
ForwardMonteCarlo.compute:68-105).

The JAX package writes the splat as tent-weighted one-hot matmuls because
the TPU has no atomics and its matrix unit is its fastest scatter; those
matmuls are not a Pallas kernel. Here each tap is an `index_add_` into the
flattened lightmap, atomic on the card, so the sum order may vary from run
to run. The weights are the same: the tent max(0, 1 - |p - i|) of the
reference's 4-tap bilinear write (WritePhoton_Bilinear,
ForwardMonteCarlo.compute:88-97), or the box of its indexed write, and a
tap outside the frame is dropped. The names and the `chunk` argument are
the JAX functions'.
"""

from __future__ import annotations

import torch


def _splat(out: torch.Tensor, h: int, w: int, iy: torch.Tensor, ix: torch.Tensor,
           weight: torch.Tensor, values: torch.Tensor) -> None:
    """out (H*W, C) += weight * values at (iy, ix), taps outside dropped."""
    inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    idx = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
    out.index_add_(0, idx, values * torch.where(inside, weight, 0.0)[:, None])


def scatter_add_bilinear_mxu(accum: torch.Tensor, pos: torch.Tensor,
                             values: torch.Tensor, chunk: int = 16384) -> torch.Tensor:
    """accum (H, W, C) + bilinear splat of values (D, C) at pos (D, 2) = (x, y).

    Positions are in texel coordinates (texel centers at integer + 0.5).
    Returns a new tensor; `accum` is not changed."""
    h, w, c = accum.shape
    out = accum.reshape(h * w, c).clone()
    for s in range(0, pos.shape[0], chunk):
        p = pos[s:s + chunk]
        v = values[s:s + chunk]
        x = p[:, 0] - 0.5
        y = p[:, 1] - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = x - x0
        fy = y - y0
        ix0 = x0.long()
        iy0 = y0.long()
        for dy, wy in ((0, 1.0 - fy), (1, fy)):
            for dx, wx in ((0, 1.0 - fx), (1, fx)):
                _splat(out, h, w, iy0 + dy, ix0 + dx, wy * wx, v)
    return out.reshape(h, w, c)


def scatter_add_nearest_mxu(accum: torch.Tensor, pos: torch.Tensor,
                            values: torch.Tensor, chunk: int = 16384) -> torch.Tensor:
    """Single-texel (indexed) variant: the texel floor(pos) takes each value
    (WritePhoton_Indexed's addressing)."""
    h, w, c = accum.shape
    out = accum.reshape(h * w, c).clone()
    for s in range(0, pos.shape[0], chunk):
        p = pos[s:s + chunk]
        one = torch.ones(p.shape[0], device=p.device)
        _splat(out, h, w, torch.floor(p[:, 1]).long(), torch.floor(p[:, 0]).long(),
               one, values[s:s + chunk])
    return out.reshape(h, w, c)
