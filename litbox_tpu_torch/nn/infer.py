"""Blend factors of the dual-tracer display (counterpart of the part of the
JAX package's nn/infer.py that the realtime frame runs: the production
constants, `blend_pair_symmetric` and `blend_from_pair`).

Both functions take tensors and keep k on their device: clamps and
`torch.where`, no read-back to the host. Their sums run in the inputs'
dtype, in another order than XLA's, so they agree with the JAX package to
float32 rounding. The tiled inference, the blend fits and the golden-set
evaluation of that module are not ported.
"""

from __future__ import annotations

import torch

# The shipped floor of the per-frame k (measured on the JAX package's
# training and held-out scenes): k_floor 0.5 behind the noise-evidence gate
# sigma_rel^2 > 1e-4.
PRODUCTION_K_FLOOR = 0.5
PRODUCTION_FLOOR_GATE = 1e-4


def blend_pair_symmetric(out_a: torch.Tensor, out_b: torch.Tensor,
                         a: torch.Tensor, b: torch.Tensor, eps: float = 1e-12,
                         k_floor: float = 0.0, floor_gate: float | None = None):
    """Production auto-blend: returns (display, k) with

        display = x + k * dbar,   x = (a+b)/2,  dbar = (d_a+d_b)/2,  d_i = out_i - i,
        k = clip(<d_a - d_b, b - a> / 4 / max(<dbar, dbar>, eps), 0, 1),

    the cross-projection estimate of the MSE-optimal k from two independent
    tracers, raised to k_floor. With floor_gate the floor applies only when
    the pair disagrees: mean|a-b|^2 / max(mean(x^2), eps) > floor_gate.
    k is a 0-d tensor on the inputs' device.
    """
    d_a = out_a - a
    d_b = out_b - b
    dbar = (d_a + d_b) * 0.5
    num = ((d_a - d_b) * (b - a)).sum() * 0.25
    den = (dbar * dbar).sum()
    x = (a + b) * 0.5
    k = torch.clamp(num / torch.clamp(den, min=eps), 0.0, 1.0)
    floor = torch.full_like(k, k_floor)
    if floor_gate is not None:
        s2 = ((a - b) ** 2).mean() / torch.clamp((x * x).mean(), min=eps)
        floor = torch.where(s2 > floor_gate, floor, 0.0)
    k = torch.maximum(k, floor)
    return x + k * dbar, k


def blend_from_pair(out: torch.Tensor, x: torch.Tensor, other: torch.Tensor,
                    eps: float = 1e-12) -> torch.Tensor:
    """Per-image residual-blend factor calibrated from the tracer pair:
    k = clip(<d, other - x> / max(<d, d>, eps), 0, 1) with d = out - x, a 0-d
    tensor on the inputs' device."""
    d = out - x
    num = (d * (other - x)).sum()
    den = (d * d).sum()
    return torch.clamp(num / torch.clamp(den, min=eps), 0.0, 1.0)
