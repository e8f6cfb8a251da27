"""Multi-layer foreground cloud relighting (counterpart of the JAX package's
post/cloud_relight.py).

Reference: Assets/Resources/CloudGaussianBlur.compute (directional Gaussian
blur of HDR x transmissibility^depth along a kernel of sample offsets) +
Assets/Demo_Abduction/Shaders/CloudForegroundShader.shader +
Assets/Demo_Abduction/Scripts/CloudGroupController.cs:74-90 (two-pass
separable blur driving foreground sprite shading).

Foreground layers at depth d are lit by the simulation output blurred with a
Gaussian whose taps are attenuated by transmissibility^d: deeper layers see
softer, dimmer light. The taps wrap around the frame (`torch.roll`, as
`jnp.roll` in the JAX version) and are summed in the same order.
"""

from __future__ import annotations

import torch


def _gaussian_kernel(n: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(n, dtype=torch.float32, device=device) - (n - 1) / 2
    w = torch.exp(-0.5 * (x / sigma) ** 2)
    return w / w.sum()


def directional_blur(hdr: torch.Tensor, transmissibility: torch.Tensor,
                     transmission_depth, sigma, taps: int = 15,
                     axis: int = 1) -> torch.Tensor:
    """One pass of CloudForegroundBlur: sum_i w_i * hdr(uv_i) * t(uv_i)^depth."""
    w = _gaussian_kernel(taps, sigma, hdr.device)
    att = transmissibility[..., None] ** transmission_depth
    src = hdr[..., :3] * att
    out = torch.zeros_like(src)
    half = taps // 2
    for i in range(taps):
        shift = i - half
        out = out + w[i] * torch.roll(src, -shift, axis)
    return out


def relight_layer(hdr: torch.Tensor, transmissibility: torch.Tensor,
                  transmission_depth, sigma, taps: int = 15) -> torch.Tensor:
    """Two-pass separable blur (CloudGroupController.cs:74-90)."""
    h = directional_blur(hdr, transmissibility, transmission_depth, sigma, taps, axis=1)
    return directional_blur(h, torch.ones_like(transmissibility), 1.0, sigma, taps, axis=0)


def shade_foreground(sprite_rgba: torch.Tensor, blurred_light: torch.Tensor,
                     transmissibility: torch.Tensor, obscurity_power=1.5) -> torch.Tensor:
    """CloudForegroundShader-style puff shading: sprite color modulated by
    the blurred light with a transmissibility obscurity power law; returns
    premultiplied RGBA for compositing."""
    obscurity = transmissibility[..., None] ** obscurity_power
    lit = sprite_rgba[..., :3] * blurred_light * obscurity
    alpha = sprite_rgba[..., 3:4]
    return torch.cat([lit * alpha, alpha], -1)
