"""Tone mapping curves (counterpart of the JAX package's post/tonemap.py;
reference: Assets/Shaders/ToneMapping.cginc). The inverses are not ported."""

from __future__ import annotations

import dataclasses

import torch


def _smoothstep(lo, hi, x):
    t = torch.clamp((x - lo) / (hi - lo), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


@dataclasses.dataclass(frozen=True)
class UE5Shape:
    """ToneMap_UE5_DefaultShape (ToneMapping.cginc:7-10)."""

    exposure: float = 0.0
    white_point: float = 2.0
    black_point: float = -4.0


def tonemap_ue5(x: torch.Tensor, shape: UE5Shape = UE5Shape()) -> torch.Tensor:
    """smoothstep(black, white, log10(x) + exposure) (ToneMapping.cginc:14-16)."""
    return _smoothstep(shape.black_point, shape.white_point,
                       torch.log10(torch.clamp(x, min=1e-30)) + shape.exposure)


@dataclasses.dataclass(frozen=True)
class UchimuraShape:
    """GT tonemapper parameters (ToneMapping.cginc:24-35)."""

    contrast: float = 1.0
    linear_base: float = 0.22
    linear_span: float = 0.4
    black_tightness: float = 1.33
    black_pedestal: float = 0.0
    maximum_brightness: float = 1.0


def tonemap_uchimura(x: torch.Tensor, shape: UchimuraShape = UchimuraShape()) -> torch.Tensor:
    """Simplified GT tonemapper: toe / linear / shoulder (ToneMapping.cginc:39-63)."""
    a, m, l = shape.contrast, shape.linear_base, shape.linear_span
    c, b, p = shape.black_tightness, shape.black_pedestal, shape.maximum_brightness

    l0 = (p - m) * l / a
    s0 = m + l0
    s1 = m + a * l0
    c2 = (a * p) / (p - s1)
    cp = -c2 / p

    w0 = 1.0 - _smoothstep(0.0, m, x)
    w2 = (x >= m + l0).to(x.dtype)  # keeps a bf16 display in bf16
    w1 = 1.0 - w0 - w2

    t = m * torch.clamp(x / m, min=0.0) ** c + b
    lin = m + a * (x - m)
    s = p - (p - s1) * torch.exp(cp * (x - s0))
    return t * w0 + lin * w1 + s * w2


def srgb_encode(x: torch.Tensor) -> torch.Tensor:
    """pow(1/2.2) approximation used throughout the reference."""
    return torch.clamp(x, 0.0, 1.0) ** (1.0 / 2.2)
