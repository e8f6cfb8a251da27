"""Scattering and BRDF math at a bounce point (counterpart of the JAX
package's sim/materials.py; reference: SimulationCommon.cginc:270-379).

Batched over photons and branch-free: every material case is computed and
the result selected by mask.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def cross2d(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """dot(a, (-b.y, b.x)) (LitboxCommon.cginc:94-97)."""
    return a[..., 0] * -b[..., 1] + a[..., 1] * b[..., 0]


def perp(v: torch.Tensor) -> torch.Tensor:
    """(-y, x) rotation by +90 degrees."""
    return torch.stack([-v[..., 1], v[..., 0]], dim=-1)


def unit_from_angle(theta: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)


def _hermite_weights(u: torch.Tensor):
    """Cubic Hermite basis (SimulationCommon.cginc:270-281)."""
    uu = u * u
    uuu = uu * u
    return (2 * uuu - 3 * uu + 1, uuu - 2 * uu + u, -2 * uuu + 3 * uu, uuu - uu)


def sample_brdf(brdf_lut: torch.Tensor, normal: torch.Tensor,
                reflected: torch.Tensor, roughness: torch.Tensor,
                u: torch.Tensor):
    """GGX BRDF LUT sample with Hermite interpolation along the random axis
    (StandardBRDF, SimulationCommon.cginc:294-339).

    brdf_lut: (NI, NJ, NK, 4) from core.luts.brdf_lut.
    Returns (unit direction (..., 2), energy scale weight^2).
    """
    ni, nj, nk = brdf_lut.shape[:3]
    v = (cross2d(normal, reflected) + 1.0) / 2.0
    tangent = perp(normal)

    x = torch.clamp(u, 0.0, 1.0) * (ni - 1)
    i0 = torch.floor(x).long().clamp(0, ni - 2)
    f = x - i0.to(x.dtype)

    jx = torch.clamp(v, 0.0, 1.0) * (nj - 1)
    j0 = torch.floor(jx).long().clamp(0, max(nj - 2, 0))
    jf = (jx - j0.to(jx.dtype))[..., None]
    kx = torch.clamp(roughness, 0.0, 1.0) * (nk - 1)
    k0 = torch.floor(kx).long().clamp(0, max(nk - 2, 0))
    kf = (kx - k0.to(kx.dtype))[..., None]
    j1 = (j0 + 1).clamp(max=nj - 1)
    k1 = (k0 + 1).clamp(max=nk - 1)

    def fetch(ii):
        v00 = brdf_lut[ii, j0, k0]
        v10 = brdf_lut[ii, j1, k0]
        v01 = brdf_lut[ii, j0, k1]
        v11 = brdf_lut[ii, j1, k1]
        return ((v00 * (1 - jf) + v10 * jf) * (1 - kf)
                + (v01 * (1 - jf) + v11 * jf) * kf)

    def tangent_of(sv):
        zero = torch.zeros_like(sv[..., 0])
        return torch.stack([-sv[..., 1], sv[..., 0], zero, zero], -1) * sv[..., 2:3]

    s1 = fetch(i0)
    s2 = fetch(i0 + 1)
    h0, h1, h2, h3 = _hermite_weights(f)
    scattered = (s1 * h0[..., None] + tangent_of(s1) * h1[..., None]
                 + s2 * h2[..., None] + tangent_of(s2) * h3[..., None])

    direction = scattered[..., 0:1] * normal + scattered[..., 1:2] * tangent
    direction = direction / torch.sqrt((direction**2).sum(-1, keepdim=True) + 1e-20)
    return direction, scattered[..., 3] ** 2


def sample_brdf_fast(brdf_lut: torch.Tensor, normal: torch.Tensor,
                     reflected: torch.Tensor, roughness: torch.Tensor,
                     u: torch.Tensor):
    """Single-gather nearest-neighbour BRDF sample for the production tracer:
    the scatter angle is quantized to the table's CDF steps (~1.4 deg at
    128), below the RBT engine's angular bin width."""
    ni, nj, nk = brdf_lut.shape[:3]
    flat = brdf_lut.reshape(ni * nj * nk, 4)
    v = (cross2d(normal, reflected) + 1.0) / 2.0
    i = torch.round(u * (ni - 1)).long().clamp(0, ni - 1)
    j = torch.round(v * (nj - 1)).long().clamp(0, nj - 1)
    k = torch.round(roughness * (nk - 1)).long().clamp(0, nk - 1)
    s = flat[(i * nj + j) * nk + k]
    tangent = perp(normal)
    direction = s[..., 0:1] * normal + s[..., 1:2] * tangent
    direction = direction / torch.sqrt((direction**2).sum(-1, keepdim=True) + 1e-20)
    return direction, s[..., 3] ** 2


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
      else                         -> BRDF LUT sample, scale weight^2 (with
                                      enable_brdf=False the hemisphere, scale 1)
    """
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
    if enable_brdf:
        brdf_fn = sample_brdf_fast if fast else sample_brdf
        brdf_dir, brdf_scale = brdf_fn(brdf_lut, nhat, reflected, 1.0 - align,
                                       rand3[..., 1])
    else:
        # Removed when the caller knows no shape carries a particle-alignment
        # (BRDF) material: the hemisphere instead.
        brdf_dir, brdf_scale = hemi, torch.ones_like(align)

    mirror = align > 0.999
    diffuse = align == 0.0
    refl_dir = torch.where(mirror[..., None], reflected,
                           torch.where(diffuse[..., None], hemi, brdf_dir))
    refl_scale = torch.where(mirror | diffuse, 1.0, brdf_scale)

    direction = torch.where(no_normal[..., None], uniform_dir,
                            torch.where(transmit[..., None], incoming, refl_dir))
    scale = torch.where(no_normal | transmit, 1.0, refl_scale)
    pushback = torch.where((no_normal | transmit)[..., None],
                           torch.zeros_like(incoming), -incoming * 2.5)
    return direction, scale, pushback
