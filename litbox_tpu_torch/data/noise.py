"""2D simplex noise (counterpart of the JAX package's data/noise.py;
reference: Assets/Shaders/Noise2D.cginc, the standard ashima/keijiro GLSL
simplex noise), on tensors.

The operations run in the JAX version's order, so on the CPU the two agree
bit for bit: `_mod289` and `_permute` multiply integer-valued floats whose
products stay below 2^24, and `torch.frac` keeps its argument's sign as
`jnp.modf` does.
"""

from __future__ import annotations

import torch


def _mod289(x):
    return x - torch.floor(x * (1.0 / 289.0)) * 289.0


def _permute(x):
    return _mod289((x * 34.0 + 1.0) * x)


def snoise(v: torch.Tensor) -> torch.Tensor:
    """Simplex noise at points (..., 2); output in [-1, 1]."""
    cx = 0.211324865405187
    cy = 0.366025403784439
    cz = -0.577350269189626
    cw = 0.024390243902439

    i = torch.floor(v + torch.sum(v, -1, keepdim=True) * cy)
    x0 = v - i + torch.sum(i, -1, keepdim=True) * cx

    i1x = (x0[..., 0] >= x0[..., 1]).to(v.dtype)
    i1 = torch.stack([i1x, 1.0 - i1x], -1)

    x1 = x0 + cx - i1
    x2 = x0 + cz

    i = _mod289(i)
    zeros, ones = torch.zeros_like(i1x), torch.ones_like(i1x)
    p = _permute(_permute(i[..., 1:2] + torch.stack([zeros, i1[..., 1], ones], -1))
                 + i[..., 0:1] + torch.stack([zeros, i1[..., 0], ones], -1))

    d = torch.stack([torch.sum(x0 * x0, -1), torch.sum(x1 * x1, -1),
                     torch.sum(x2 * x2, -1)], -1)
    m = torch.clamp(0.5 - d, min=0.0)
    m = m * m
    m = m * m

    x = 2.0 * torch.frac(p * cw) - 1.0
    h = torch.abs(x) - 0.5
    ox = torch.floor(x + 0.5)
    a0 = x - ox

    m = m * (1.79284291400159 - 0.85373472095314 * (a0 * a0 + h * h))

    g = torch.stack([
        a0[..., 0] * x0[..., 0] + h[..., 0] * x0[..., 1],
        a0[..., 1] * x1[..., 0] + h[..., 1] * x1[..., 1],
        a0[..., 2] * x2[..., 0] + h[..., 2] * x2[..., 1],
    ], -1)
    return 130.0 * torch.sum(m * g, -1)


def snoise01(v: torch.Tensor) -> torch.Tensor:
    return snoise(v) * 0.5 + 0.5
