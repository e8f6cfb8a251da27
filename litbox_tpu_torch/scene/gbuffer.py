"""GBuffer rasterization (counterpart of the JAX package's scene/gbuffer.py).

An analytic rasterizer in place of the reference's hidden ortho camera +
RT/Object shader pass (`SimulationCamera.cs:87-171`, `RTObjectMat.shader:79-90`):
shapes are evaluated per pixel in draw order with the same blend modes
(albedo: premultiplied over; transmissibility: multiplicative;
normal+alignment: overwrite where covered).

Transmissibility per texel: t = (1 - density * alpha) ^ (100 / H), the
resolution-invariant exponent of RTObjectMat.shader:83-86.
"""

from __future__ import annotations

import torch

from ..core.sampling import sample_bilinear_uv
from ..core.types import SHAPE_ELLIPSE, SHAPE_RECT, GBuffer, affine_apply
from .scene import Scene


def _shape_normal(kind: torch.Tensor, local: torch.Tensor,
                  inv_lin_t: torch.Tensor) -> torch.Tensor:
    """World-space (nx, ny, nz) for pixels at `local` (..., 2) in shape space.

    `inv_lin_t` is the 2x2 inverse-transpose of the shape's linear part.
    Rect: constant outward edge normal per fan quadrant (RTRect.cs:21-66).
    Ellipse: fan interpolation between the center normal (0,0,-1) and radial
    rim normals (RTEllipse.cs:15-55). Sprite: flat (0,0,-1).
    """
    eps = 1e-20
    lx, ly = local[..., 0], local[..., 1]
    zeros = torch.zeros_like(lx)
    rect_local = torch.where(
        (lx.abs() > ly.abs())[..., None],
        torch.stack([torch.sign(lx), zeros], -1),
        torch.stack([zeros, torch.sign(ly)], -1))
    rect_world = rect_local @ inv_lin_t.T
    rect_world = rect_world / torch.sqrt((rect_world**2).sum(-1, keepdim=True) + eps)
    rect_n = torch.cat([rect_world, torch.zeros_like(rect_world[..., :1])], -1)

    r = torch.sqrt((local**2).sum(-1, keepdim=True) + eps)
    rhat_world = (local / r) @ inv_lin_t.T
    rhat_world = rhat_world / torch.sqrt((rhat_world**2).sum(-1, keepdim=True) + eps)
    ell_n = torch.cat([r * rhat_world, -(1.0 - r)], -1)

    sprite_n = torch.tensor([0.0, 0.0, -1.0], device=local.device).expand_as(rect_n)
    return torch.where(kind == SHAPE_RECT, rect_n,
                       torch.where(kind == SHAPE_ELLIPSE, ell_n, sprite_n))


def rasterize(scene: Scene, height: int, width: int) -> GBuffer:
    shapes = scene.shapes
    dev = shapes.affine.device
    xs = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    ys = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
    pix = torch.stack([xs[None, :].expand(height, width),
                       ys[:, None].expand(height, width)], -1)

    # Clear colors (SimulationCamera.cs:98-107).
    albedo = torch.zeros((height, width, 4), device=dev)
    albedo[..., 3] = 1.0
    trans = torch.ones((height, width), device=dev)
    normal = torch.zeros((height, width, 4), device=dev)

    t_exponent = 100.0 / height
    for i in range(shapes.capacity):
        kind = shapes.kind[i]
        inv = shapes.inv_affine[i]
        local = affine_apply(inv, pix)

        box_cover = local.abs().amax(-1) <= 1.0
        disk_cover = (local**2).sum(-1) <= 1.0
        cover = torch.where(kind == SHAPE_ELLIPSE, disk_cover, box_cover)
        cover = cover & shapes.active[i]

        tex = scene.textures[shapes.tex_index[i].long()]
        c = sample_bilinear_uv(tex, (local + 1.0) * 0.5)
        tint = shapes.color[i]

        src_a = c[..., 3] * tint[3]
        src_rgb = c[..., :3] * tint[:3] * src_a[..., None]

        img_density = shapes.density[i] * c[..., 3]
        t = torch.clamp(1.0 - img_density, min=0.0) ** t_exponent

        blended = torch.cat([albedo[..., :3] * (1 - src_a[..., None]) + src_rgb,
                             albedo[..., 3:] * (1 - src_a[..., None]) + src_a[..., None]], -1)
        albedo = torch.where(cover[..., None], blended, albedo)
        trans = torch.where(cover, trans * t, trans)

        n3 = _shape_normal(kind, local, inv[:2, :2].T)
        n4 = torch.cat([n3, shapes.alignment[i].expand_as(n3[..., :1])], -1)
        normal = torch.where(cover[..., None], n4, normal)
    return GBuffer(albedo=albedo, transmissibility=trans, normal=normal)
