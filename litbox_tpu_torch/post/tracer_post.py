"""Tracer-pair post-processing: mean, relative temporal variance, mips
(counterpart of the JAX package's post/tracer_post.py).

Replaces the fused groupshared kernel `ComputeCVAndNMipsFromSamplePair`
(TracerPostProcessing.compute:80-155): per-pixel mean of the two tracer
outputs, per-pixel relative variance (a-b)^2/(mean^2+1e-5) averaged over
4x4 tiles into a quarter-res CV map, and a box-filter mip chain of the mean.
Plain reshapes and means; no shared-memory choreography is needed.
"""

from __future__ import annotations

import torch

from ..core.sampling import downsample2x_mean
from ..core.types import luminance


def _tile_mean(x: torch.Tensor, t: int) -> torch.Tensor:
    h, w = x.shape[0] // t, x.shape[1] // t
    return x[: h * t, : w * t].reshape(h, t, w, t).mean(dim=(1, 3))


def compute_cv_and_mips(source_a: torch.Tensor, source_b: torch.Tensor,
                        mip_count: int = 1) -> tuple[torch.Tensor, torch.Tensor, tuple]:
    """Returns (mean (H,W,C), cv (H/4,W/4), mips tuple of further levels)."""
    mean = (source_a + source_b) * 0.5
    rel_var = ((source_a - source_b) ** 2 / (mean**2 + 1e-5))[..., :3].mean(-1)
    cv = _tile_mean(rel_var, 4)
    mips = []
    level = mean
    for _ in range(max(0, mip_count - 1)):
        level = downsample2x_mean(level)
        mips.append(level)
    return mean, cv, tuple(mips)


def importance_pyramid(radiance_a: torch.Tensor, radiance_b: torch.Tensor,
                       levels: int = 4) -> tuple[torch.Tensor, ...]:
    """Half-res luminance(A+B) pyramid with SUM (not mean) reduction
    (ImportanceMap.compute:16-64). Level 0 is half the radiance resolution."""
    lum = luminance(radiance_a[..., :3] + radiance_b[..., :3])
    # Half-res base: a 2x2 box average, the statistic of the reference's
    # linear sample at texel corners.
    out = [_tile_mean(lum, 2)]
    for _ in range(levels - 1):
        h, w = out[-1].shape[0] // 2, out[-1].shape[1] // 2
        out.append(out[-1][: h * 2, : w * 2].reshape(h, 2, w, 2).sum(dim=(1, 3)))
    return tuple(out)


def measure_convergence(cv: torch.Tensor) -> torch.Tensor:
    """Scalar convergence xi: the mean of the CV map, a 0-d tensor on its
    device. The reference accumulates floor(cv*10000) in fixed point and
    divides by 10000*W*H (Convergence.compute:10-31,
    ConvergenceMeasurement.cs:52), i.e. the mean."""
    return torch.mean(cv)
