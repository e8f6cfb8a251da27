"""GBuffer rasterization and the transmissibility pyramid (counterpart of
the JAX package's scene/gbuffer.py).

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
import torch.nn.functional as F

from ..core.sampling import sample_bilinear_uv
from ..core.types import SHAPE_ELLIPSE, SHAPE_RECT, GBuffer, GBufferPyramid, affine_apply
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

    sprite_n = torch.zeros_like(rect_n)  # (0, 0, -1), made on the device
    sprite_n[..., 2] = -1.0
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

        # index_select keeps the index on the device (a 0-d index would be
        # read back to the host).
        tex = scene.textures.index_select(0, shapes.tex_index[i:i + 1].long())[0]
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


def _downsample_trans_level(level: torch.Tensor, variation_epsilon: float) -> torch.Tensor:
    """One custom transmissibility mip step (GBuffer.compute:31-52).

    Input and output are (h, w, 4) with channels (avg, min, variance, leaf).
    """
    h, w = level.shape[0] // 2, level.shape[1] // 2
    q = level[: h * 2, : w * 2].reshape(h, 2, w, 2, 4).permute(0, 2, 1, 3, 4)
    a, b = q[..., 0, 0, :], q[..., 0, 1, :]
    c, d = q[..., 1, 0, :], q[..., 1, 1, :]

    average = (a[..., 0] * b[..., 0] + c[..., 0] * d[..., 0]
               + a[..., 0] * c[..., 0] + b[..., 0] * d[..., 0]) / 4.0
    minimum = torch.minimum(
        torch.minimum(a[..., 1] * b[..., 1], c[..., 1] * d[..., 1]),
        torch.minimum(a[..., 1] * c[..., 1], b[..., 1] * d[..., 1]))
    sr_avg = torch.sqrt(torch.clamp(average, min=0.0))
    var = ((a[..., 0] - sr_avg) ** 2 + (b[..., 0] - sr_avg) ** 2
           + (c[..., 0] - sr_avg) ** 2 + (d[..., 0] - sr_avg) ** 2) * 0.25
    leaf = (var < variation_epsilon).to(torch.float32)
    return torch.stack([average, minimum, var, leaf], dim=-1)


def _neighborhood_variance(level: torch.Tensor, variation_epsilon: float) -> torch.Tensor:
    """3x3 variance + leaf flags per mip texel (GBuffer.compute:70-102)."""
    x = level[..., 0]
    h, w = x.shape
    padded = F.pad(x[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    stack = torch.stack([padded[dy:dy + h, dx:dx + w]
                         for dy in range(3) for dx in range(3)], dim=0)
    mean = stack.mean(dim=0)
    variance = torch.sqrt(((stack - mean) ** 2).sum(dim=0)) / 3.0
    leaf = (variance < variation_epsilon).to(torch.float32)
    return torch.cat([level[..., :2], variance[..., None], leaf[..., None]], dim=-1)


def build_pyramid(gbuffer: GBuffer, levels: int = 0,
                  variation_epsilon: float = 1e-3) -> GBufferPyramid:
    """Custom transmissibility mips + quadtree-leaf LOD map.

    Mirrors SimulationCamera.OnPostRender (SimulationCamera.cs:111-171):
    downsample each level, run the 3x3 variance pass with epsilon halved per
    level, then resolve per-texel quadtree leaves from the coarsest usable
    level (mipcount - 3) down.
    """
    trans = gbuffer.transmissibility
    h, w = trans.shape
    dev = trans.device
    if levels <= 0:
        levels = max(1, min(h, w).bit_length() - 1)

    out = [torch.stack([trans, trans, torch.zeros_like(trans), torch.ones_like(trans)],
                       dim=-1)]
    eps = variation_epsilon
    for _ in range(levels):
        eps /= 2.0
        nxt = _neighborhood_variance(_downsample_trans_level(out[-1], eps), eps)
        out.append(nxt)
        if min(nxt.shape[:2]) <= 1:
            break

    # Quadtree leaves: the coarsest level whose leaf flag is set at this texel.
    lowest_lod = max(0, len(out) - 3)
    quad = torch.zeros((h, w), device=dev)
    ys = (torch.arange(h, device=dev) + 0.5) / h
    xs = (torch.arange(w, device=dev) + 0.5) / w
    found = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for lod in range(lowest_lod, -1, -1):
        lvl = out[lod]
        iy = (ys * lvl.shape[0]).to(torch.int64).clamp(0, lvl.shape[0] - 1)
        ix = (xs * lvl.shape[1]).to(torch.int64).clamp(0, lvl.shape[1] - 1)
        leaf = lvl[iy[:, None], ix[None, :], 3] == 1.0
        quad = torch.where(~found & leaf, float(lod), quad)
        found |= leaf
    return GBufferPyramid(levels=tuple(out), quadtree=quad)
