"""Scene composition (counterpart of the JAX package's post/compositor.py;
reference: Assets/Shaders/SimulationCompositor.shader).

The compositor quad writes float4(hdr.rgb, 0) with Blend One OneMinusSrcAlpha:
with src alpha 0 this is additive light injection over the backdrop.
"""

from __future__ import annotations

import torch


def composite_additive(background: torch.Tensor, hdr: torch.Tensor) -> torch.Tensor:
    """dst * (1 - 0) + src = background + hdr (SimulationCompositor.shader:46-57)."""
    return background + hdr


def composite_premultiplied(background: torch.Tensor, rgba: torch.Tensor) -> torch.Tensor:
    """General premultiplied-over blend for layered content."""
    return rgba[..., :3] + background * (1.0 - rgba[..., 3:4])
