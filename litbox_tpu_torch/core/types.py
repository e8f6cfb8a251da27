"""Core types and constants (counterpart of the JAX package's core/types.py).

Scenes and buffers are frozen dataclasses of tensors; the JAX package
registers the same layouts as pytrees.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Light kinds (reference kernel dispatch: ForwardMonteCarlo.compute:341-355).
LIGHT_DEFAULT = 0
LIGHT_POINT = 1
LIGHT_SPOT = 2
LIGHT_LASER = 3
LIGHT_AMBIENT = 4
LIGHT_FIELD = 5
LIGHT_DIRECTIONAL = 6
NUM_LIGHT_KINDS = 7

# Shape kinds (reference: Assets/Scripts/Shapes).
SHAPE_RECT = 0
SHAPE_ELLIPSE = 1
SHAPE_SPRITE = 2

LUMINANCE_WEIGHTS = (0.2126, 0.7152, 0.0722)


@dataclasses.dataclass(frozen=True)
class GBuffer:
    """Rasterized scene fields (reference: SimulationCamera.cs:7-19).

    albedo          (H, W, 4) premultiplied rgb + alpha; cleared (0,0,0,1)
    transmissibility(H, W)    per-texel transmissibility product; cleared 1
    normal          (H, W, 4) (nx, ny, nz, alignment); cleared 0
    """

    albedo: torch.Tensor
    transmissibility: torch.Tensor
    normal: torch.Tensor

    @property
    def height(self) -> int:
        return self.albedo.shape[0]

    @property
    def width(self) -> int:
        return self.albedo.shape[1]


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.709 luminance (LitboxCommon.cginc:103-105)."""
    wr, wg, wb = LUMINANCE_WEIGHTS
    return rgb[..., 0] * wr + rgb[..., 1] * wg + rgb[..., 2] * wb


def affine_2x3(scale=(1.0, 1.0), rotation: float = 0.0, translation=(0.0, 0.0)) -> np.ndarray:
    """Build a 2x3 local->target affine: T @ R @ S (column-vector convention)."""
    c, s = np.cos(rotation), np.sin(rotation)
    sx, sy = scale
    return np.array(
        [[c * sx, -s * sy, translation[0]],
         [s * sx, c * sy, translation[1]]],
        dtype=np.float32,
    )


def affine_apply(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply (..., 2, 3) affine to (..., 2) points."""
    return affine_linear(m, p) + m[..., 2]


def affine_linear(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Apply only the linear part to (..., 2) vectors."""
    return torch.stack([m[..., 0, 0] * v[..., 0] + m[..., 0, 1] * v[..., 1],
                        m[..., 1, 0] * v[..., 0] + m[..., 1, 1] * v[..., 1]], -1)


def affine_inverse(m) -> np.ndarray:
    """Invert a 2x3 affine (numpy, host-side)."""
    m = np.asarray(m, dtype=np.float32)
    lin = np.linalg.inv(m[:2, :2])
    return np.concatenate([lin, -(lin @ m[:2, 2:3])], axis=1).astype(np.float32)
