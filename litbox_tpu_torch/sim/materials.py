"""Scattering and BRDF math (counterpart of the JAX package's
sim/materials.py; reference: SimulationCommon.cginc:95-379).

Batched over photons and branch-free: every material case is computed and
the result selected by mask.
"""

from __future__ import annotations

import math

import torch

from ..core.sampling import sample_lut

TWO_PI = 2.0 * math.pi


def cross2d(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """dot(a, (-b.y, b.x)) (LitboxCommon.cginc:94-97)."""
    return a[..., 0] * -b[..., 1] + a[..., 1] * b[..., 0]


def perp(v: torch.Tensor) -> torch.Tensor:
    """(-y, x) rotation by +90 degrees."""
    return torch.stack([-v[..., 1], v[..., 0]], dim=-1)


def unit_from_angle(theta: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)


def scatter_mie(mie_lut: torch.Tensor, incoming: torch.Tensor,
                u: torch.Tensor) -> torch.Tensor:
    """Rotate `incoming` by a Mie-LUT-sampled angle (SimulationCommon.cginc:95-101).

    The reference's perpendicular here is (y, -x) (perp.x *= -1 after the yx
    swizzle), the opposite handedness from scatter_importance_lobed.
    """
    s = sample_lut(mie_lut, u)
    p = torch.stack([incoming[..., 1], -incoming[..., 0]], dim=-1)
    return s[..., 0:1] * incoming + s[..., 1:2] * p


def scatter_importance_lobed(teardrop_lut: torch.Tensor, origin: torch.Tensor,
                             target: torch.Tensor, u: torch.Tensor):
    """Teardrop lobe toward `target` (SimulationCommon.cginc:103-118).

    Returns (direction (..., 2), inverse-density weight). The base direction
    points away from the target; the teardrop pdf peaks at +-pi, folding the
    samples back toward it.
    """
    d = target - origin
    lsq = (d * d).sum(-1, keepdim=True)
    base = -d / torch.sqrt(torch.clamp(lsq, min=1e-12))
    s = sample_lut(teardrop_lut, u)
    direction = base * s[..., 0:1] + perp(base) * s[..., 1:2]
    return direction, s[..., 2]


def scatter_importance_guided(pyramid: tuple, origin_uv: torch.Tensor,
                              rand2: torch.Tensor):
    """Hierarchical importance-map sampling (the intent of
    ScatterImportanceGuided / TestImportanceMapPDF,
    SimulationCommon.cginc:145-255; the reference's own version is dead
    code).

    A top-down categorical descent of the sum pyramid of
    post.tracer_post.importance_pyramid: pick a coarsest-level cell in
    proportion to its energy, then refine through each level's 2x2
    children. Returns (uv offset from origin_uv to the sampled point,
    inverse density = uniform pdf / sample pdf).
    """
    coarsest = pyramid[-1]
    ch, cw = coarsest.shape
    selector = rand2[..., 0]

    # Coarsest level: categorical over all cells.
    flat = coarsest.reshape(-1)
    cdf = torch.cumsum(flat, 0)
    total = cdf[-1] + 1e-20
    idx = torch.searchsorted(cdf, selector * total, right=True)
    idx = idx.clamp(0, flat.shape[0] - 1)
    lo = torch.where(idx > 0, cdf[(idx - 1).clamp(min=0)], 0.0)
    p_cell = flat[idx] / total
    selector = torch.clamp((selector * total - lo) / torch.clamp(flat[idx], min=1e-20),
                           0.0, 1.0)
    cy, cx = idx // cw, idx % cw
    inv_density = (1.0 / (ch * cw)) / torch.clamp(p_cell, min=1e-20)

    # Refine through finer levels: a 4-way pick among the 2x2 children.
    for level in reversed(pyramid[:-1]):
        lh, lw = level.shape
        cy2, cx2 = cy * 2, cx * 2
        y0, y1 = cy2.clamp(0, lh - 1), (cy2 + 1).clamp(0, lh - 1)
        x0, x1 = cx2.clamp(0, lw - 1), (cx2 + 1).clamp(0, lw - 1)
        e00, e01, e10, e11 = level[y0, x0], level[y0, x1], level[y1, x0], level[y1, x1]
        tot = e00 + e01 + e10 + e11 + 1e-20
        p0, p1, p2, p3 = e00 / tot, e01 / tot, e10 / tot, e11 / tot
        c0, c1, c2 = p0, p0 + p1, p0 + p1 + p2
        sel = selector
        k0 = sel < c0
        k1 = ~k0 & (sel < c1)
        k2 = ~k0 & ~k1 & (sel < c2)
        k3 = ~(k0 | k1 | k2)
        dx = (k1 | k3).long()
        dy = (k2 | k3).long()
        p_child = torch.where(k0, p0, torch.where(k1, p1, torch.where(k2, p2, p3)))
        selector = torch.where(
            k0, sel / torch.clamp(c0, min=1e-20),
            torch.where(k1, (sel - c0) / torch.clamp(p1, min=1e-20),
                        torch.where(k2, (sel - c1) / torch.clamp(p2, min=1e-20),
                                    (sel - c2) / torch.clamp(p3, min=1e-20))))
        cy, cx = cy2 + dy, cx2 + dx
        inv_density = inv_density * 0.25 / torch.clamp(p_child, min=1e-20)

    h0, w0 = pyramid[0].shape
    jitter = rand2[..., 1]
    uv = torch.stack([(cx.to(torch.float32) + jitter) / w0,
                      (cy.to(torch.float32) + selector) / h0], -1)
    return uv - origin_uv, inv_density


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
