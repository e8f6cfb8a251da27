"""Scattering math at a bounce point (counterpart of the JAX package's
sim/materials.py; reference: SimulationCommon.cginc:341-379).

Batched over photons and branch-free: every material case is computed and
the result selected by mask.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def unit_from_angle(theta: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)


def scatter_materially(brdf_lut: torch.Tensor, normal4: torch.Tensor,
                       incoming: torch.Tensor, rand3: torch.Tensor,
                       fast: bool = False, enable_brdf: bool = True):
    """Material dispatch at a bounce point (SimulationCommon.cginc:341-379).

    normal4: (..., 4) sampled normal+alignment field. rand3: (..., 3) uniforms.
    Returns (new_direction, energy_scale, origin_pushback) where pushback is
    the -2.5 * incoming offset the mirror/BRDF branch applies to the origin.

    Branch map (all computed, mask-selected):
      no normal (|n|^2 < 1e-5)     -> uniform direction, scale 1
      normal aligned with incoming -> transmit-as-bounce (direction kept)
      alignment' > 0.999           -> perfect mirror
      alignment' == 0              -> uniform hemisphere about the normal
      else                         -> BRDF LUT sample (not ported yet); with
                                      enable_brdf=False the hemisphere, scale 1
    """
    if enable_brdf:
        raise NotImplementedError("sample_brdf_fast not ported yet")
    eps = 1e-5
    n2 = normal4[..., :2]
    alignment = normal4[..., 3]
    len2 = (n2 * n2).sum(-1)

    no_normal = len2 < eps
    transmit = (n2 * incoming).sum(-1) > 0

    length = torch.sqrt(torch.clamp(len2, min=1e-20))
    nhat = n2 / length[..., None]
    reflected = incoming - 2.0 * (incoming * nhat).sum(-1, keepdim=True) * nhat
    align = torch.clamp(alignment / length, 0.0, 1.0)

    uniform_dir = unit_from_angle(rand3[..., 0] * TWO_PI)
    hemi = torch.where(((uniform_dir * nhat).sum(-1) > 0)[..., None],
                       uniform_dir, -uniform_dir)
    mirror = align > 0.999
    refl_dir = torch.where(mirror[..., None], reflected, hemi)

    direction = torch.where(no_normal[..., None], uniform_dir,
                            torch.where(transmit[..., None], incoming, refl_dir))
    scale = torch.ones_like(align)
    pushback = torch.where((no_normal | transmit)[..., None],
                           torch.zeros_like(incoming), -incoming * 2.5)
    return direction, scale, pushback
