"""HDR conversion of the accumulated deposit map (counterpart of the JAX
package's sim/oracle.py::to_hdr; the rest of that module is not ported)."""

from __future__ import annotations

import torch

from ..core.types import GBuffer


def to_hdr(accum: torch.Tensor, iterations, gbuffer: GBuffer,
           finalize_outscatter: bool = True) -> torch.Tensor:
    """ConvertToHDR (ForwardMonteCarlo.compute:358-382) in float arithmetic."""
    if isinstance(iterations, torch.Tensor):
        out = accum / torch.clamp(iterations, min=1.0)
    else:
        out = accum / max(float(iterations), 1.0)
    out = out * gbuffer.albedo[..., :3]
    if finalize_outscatter:
        out = out * (1.0 - gbuffer.transmissibility)[..., None]
    return out
