"""Diagnostic analysis filters (counterpart of the JAX package's
diag/analysis.py; reference: Assets/Resources/Analysis.compute,
Assets/Scripts/AnalysisParameters.cs) — the prototype classical denoiser /
adaptive-sampling path."""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.types import luminance


@dataclasses.dataclass(frozen=True)
class AnalysisParameters:
    """Tunables (AnalysisParameters.cs:3-14)."""

    sigma_spatial: float = 1.2
    sigma_albedo: float = 0.05
    sigma_luminance_tight: float = 0.05
    sigma_luminance_loose: float = 2.5
    k_luminance: float = 2.0


def analysis_a(hdr_a: torch.Tensor, hdr_b: torch.Tensor) -> torch.Tensor:
    """Full-res relative variance of the tracer pair (Analysis.compute:27-41)."""
    mean = (hdr_a + hdr_b) / 2.0
    rel = ((hdr_a - hdr_b) ** 2 / (mean**2 + 1e-5))[..., :3].mean(-1)
    return rel


def _gw(delta, sigma):
    return torch.exp(-0.5 * delta * delta / (sigma * sigma))


def _smoothstep(lo, hi, x):
    t = torch.clamp((x - lo) / (hi - lo), 0.0, 1.0)
    return t * t * (3 - 2 * t)


def analysis_b(previous: torch.Tensor, albedo: torch.Tensor, hdr_final: torch.Tensor,
               variance: torch.Tensor,
               params: AnalysisParameters = AnalysisParameters()) -> torch.Tensor:
    """5x5 edge-preserving bilateral filter of the variance field with
    spatial/albedo/adaptive-luminance Gaussian weights (Analysis.compute:48-87).
    The neighbours wrap around the frame, as in the JAX version."""
    sig_adaptive = params.sigma_luminance_tight + (
        params.sigma_luminance_loose - params.sigma_luminance_tight
    ) * _smoothstep(0.0, 1.0 / params.k_luminance, variance)

    lum = luminance(hdr_final[..., :3])
    total_w = torch.zeros_like(lum)
    out = torch.zeros_like(previous)

    def shifted(x, dy, dx):
        return torch.roll(x, (-dy, -dx), (0, 1))

    rgb = albedo[..., :3]
    for j in range(-2, 3):
        for i in range(-2, 3):
            # A host constant, as the JAX version's float(jnp.exp(...)).
            spatial = math.exp(-0.5 * (i * i + j * j) / params.sigma_spatial**2)
            diff = shifted(rgb, j, i) - rgb
            albedo_w = _gw(torch.sqrt((diff * diff).sum(-1)), params.sigma_albedo)
            lum_w = _gw(torch.abs(shifted(lum, j, i) - lum), sig_adaptive)
            w = spatial * albedo_w * lum_w
            total_w = total_w + w
            out = out + shifted(previous, j, i) * (w[..., None] if previous.ndim == 3 else w)

    return out / (total_w[..., None] if previous.ndim == 3 else total_w)
