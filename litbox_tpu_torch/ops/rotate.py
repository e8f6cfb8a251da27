"""Batched image rotation by three shears (kernels K2 and K3).

Rotation decomposes into three shears (Paeth): R(t) = Sx(a) Sy(b) Sx(a)
with a = -tan(t/2), b = sin(t). A shear is a per-row 1-D resample with a
row-dependent fractional shift. Angles outside [-45, 45] degrees are handled
by a quadrant pre-rotation (`torch.rot90`). The batch axis carries a
different angle per image (the RBT engine's direction bins).

`shear` replaces the Pallas kernel `litbox_tpu/ops/rotate.py::shear`
(pallas_call at :163) and `shear_reduce` replaces `rotate.py::shear_reduce`
(pallas_call at :210); both are CUDA C++ in `csrc/rotate.cu`, one thread per
output element, bound by bytes (shear: one read and one write of the batch,
453 MB at (384, 384, 384), 0.14 ms at 3.35 TB/s; shear_reduce: one read of
the needed rows, 151 MB at the bench shape, 0.045 ms). The kernels compute
the shift exactly for any coefficient, so the Pallas version's static
`coef_bound` (which sized its roll loop) is not an argument here.

A CPU tensor takes the plain PyTorch version; a CUDA tensor takes the kernel
or the call raises.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_lib


def _check_shear(img, coef, row_div: int, elem_scale: int, n_texels: int) -> None:
    if img.ndim != 3:
        raise ValueError(f"img must be (N, R, W), got {tuple(img.shape)}")
    if coef.shape != (img.shape[0],):
        raise ValueError(f"coef {tuple(coef.shape)} must be ({img.shape[0]},)")
    if row_div < 1 or elem_scale < 1 or img.shape[2] != n_texels * elem_scale:
        raise ValueError(f"width {img.shape[2]} must be n_texels {n_texels} * "
                         f"elem_scale {elem_scale}, row_div {row_div} >= 1")


def _check_reduce(img, coef, row_div, elem_scale, n_texels, row_lo, row_hi,
                  groups) -> None:
    _check_shear(img, coef, row_div, elem_scale, n_texels)
    n, rows, _ = img.shape
    if not 0 <= row_lo < row_hi <= rows or groups < 1 or n % groups:
        raise ValueError(f"bad rows [{row_lo}, {row_hi}) of {rows} or "
                         f"{groups} groups of {n} images")


def _shear_rows_plain(img: torch.Tensor, coef: torch.Tensor, row0: int,
                      row_div: int, elem_scale: int, n_texels: int) -> torch.Tensor:
    """Shear rows row0 .. row0 + R of the images whose rows are `img` (N, R, W)."""
    _, rows, width = img.shape
    r = (torch.arange(row0, row0 + rows, device=img.device) // row_div).float()
    s = coef[:, None] * ((r + 0.5) - n_texels / 2.0)            # (N, R)
    fi = torch.floor(s)
    f = (s - fi)[..., None]
    i = fi.long()[..., None]
    lanes = torch.arange(width, device=img.device)
    texel = lanes // elem_scale + i                              # (N, R, W)
    idx0 = lanes + i * elem_scale
    g0 = img.gather(2, idx0.clamp(0, width - 1))
    g1 = img.gather(2, (idx0 + elem_scale).clamp(0, width - 1))
    v0 = (texel >= 0) & (texel < n_texels)
    v1 = (texel + 1 >= 0) & (texel + 1 < n_texels)
    return torch.where(v0, g0 * (1.0 - f), 0.0) + torch.where(v1, g1 * f, 0.0)


def shear_plain(img: torch.Tensor, coef: torch.Tensor, row_div: int,
                elem_scale: int, n_texels: int) -> torch.Tensor:
    """`shear` in plain PyTorch (two gathers and a lerp)."""
    _check_shear(img, coef, row_div, elem_scale, n_texels)
    return _shear_rows_plain(img, coef, 0, row_div, elem_scale, n_texels)


def shear_reduce_plain(img: torch.Tensor, coef: torch.Tensor, row_div: int,
                       elem_scale: int, n_texels: int, row_lo: int,
                       row_hi: int, groups: int = 1) -> torch.Tensor:
    """`shear_reduce` in plain PyTorch."""
    _check_reduce(img, coef, row_div, elem_scale, n_texels, row_lo, row_hi, groups)
    n, _, width = img.shape
    out = _shear_rows_plain(img[:, row_lo:row_hi], coef, row_lo, row_div,
                            elem_scale, n_texels)
    out = out.reshape(groups, n // groups, row_hi - row_lo, width).sum(1)
    return out if groups > 1 else out[0]


def shear(img: torch.Tensor, coef: torch.Tensor, row_div: int,
          elem_scale: int, n_texels: int) -> torch.Tensor:
    """out[d, r, l] = (1-f)*img[d, r, l + i*e] + f*img[d, r, l + (i+1)*e]
    with i + f = coef[d] * (r//row_div + 0.5 - n_texels/2) and e = elem_scale,
    a tap outside texels [0, n_texels) counting 0.

    img (N, R, W) with W = n_texels * elem_scale; the shift axis is the last
    (lane) axis in units of `elem_scale` lanes per texel.
    """
    if cuda_lib.on_cpu(img, coef):
        return shear_plain(img, coef, row_div, elem_scale, n_texels)
    cuda_lib.require_cuda_float32("shear", img, coef)
    _check_shear(img, coef, row_div, elem_scale, n_texels)
    n, rows, width = img.shape
    out = torch.empty_like(img)
    code = cuda_lib.library().litbox_shear(
        img.data_ptr(), coef.data_ptr(), out.data_ptr(), n, rows, width,
        row_div, elem_scale, n_texels, cuda_lib.stream_handle(img.device))
    cuda_lib.check(code, "shear")
    shear.launches += 1
    return out


shear.launches = 0


def shear_reduce(img: torch.Tensor, coef: torch.Tensor, row_div: int,
                 elem_scale: int, n_texels: int, row_lo: int, row_hi: int,
                 groups: int = 1) -> torch.Tensor:
    """Final-pass shear: apply each image's shear to rows [row_lo, row_hi)
    only and sum each contiguous group of N/groups images. Returns
    (groups, row_hi - row_lo, W), or (row_hi - row_lo, W) for groups=1.
    The sum runs over the images of a group in order."""
    if cuda_lib.on_cpu(img, coef):
        return shear_reduce_plain(img, coef, row_div, elem_scale, n_texels,
                                  row_lo, row_hi, groups)
    cuda_lib.require_cuda_float32("shear_reduce", img, coef)
    _check_reduce(img, coef, row_div, elem_scale, n_texels, row_lo, row_hi, groups)
    n, rows, width = img.shape
    out = torch.empty((groups, row_hi - row_lo, width), device=img.device)
    code = cuda_lib.library().litbox_shear_reduce(
        img.data_ptr(), coef.data_ptr(), out.data_ptr(), n, rows, width,
        row_div, elem_scale, n_texels, row_lo, row_hi, groups,
        cuda_lib.stream_handle(img.device))
    cuda_lib.check(code, "shear_reduce")
    shear_reduce.launches += 1
    return out if groups > 1 else out[0]


shear_reduce.launches = 0


def _quadrant_groups(angles) -> list:
    """Contiguous runs of equal quadrant index k = round(a / 90deg) % 4.
    RBT bin angles are monotonic, so runs stay contiguous and concatenation
    preserves bin order."""
    ks = [int(round(a / (np.pi / 2))) % 4 for a in angles]
    groups, start = [], 0
    for i in range(1, len(angles) + 1):
        if i == len(angles) or ks[i] != ks[start]:
            groups.append((start, i, ks[start]))
            start = i
    return groups


def rotate_planar_sum(channels: tuple, base_angles: tuple, delta,
                      row_lo: int, row_hi: int) -> torch.Tensor:
    """Planar-channel rotate-and-accumulate: the RBT display resolve path.

    channels: C tensors of (D, S, S), one per colour plane (the scan's
    outputs). Image d of every channel rotates by base_angles[d] + delta, all
    results sum over d per channel, restricted to output rows
    [row_lo, row_hi). Returns (C, row_hi - row_lo, S).

    base_angles are static: the quadrant pre-rotation is resolved on the
    host into contiguous rot90 slices. `delta` (a float or a 0-d tensor, the
    per-frame jitter phase * 2pi/D) folds into the shear residuals. The JAX
    version also takes `max_delta` to bound its kernels' roll loops; the
    kernels here need no bound, so the argument is gone.
    """
    c = len(channels)
    d, s, s2 = channels[0].shape
    if s != s2 or len(base_angles) != d:
        raise ValueError(f"channels {tuple(channels[0].shape)} vs {len(base_angles)} angles")
    dev = channels[0].device
    groups = _quadrant_groups(base_angles)
    base_res = np.asarray(
        [a - round(a / (np.pi / 2)) * (np.pi / 2) for a in base_angles],
        np.float32)
    if isinstance(delta, torch.Tensor):
        residual = torch.from_numpy(base_res).to(dev) + delta.to(dev, torch.float32)
    else:
        residual = torch.from_numpy(base_res + np.float32(delta)).to(dev)

    pre = torch.cat([
        torch.rot90(ch[a:b], k, dims=(1, 2)) if k else ch[a:b]
        for ch in channels for a, b, k in groups], dim=0)    # (C*D, S, S)

    alpha = (-torch.tan(residual / 2.0)).repeat(c)
    beta = torch.sin(residual).repeat(c)
    flat = shear(pre, alpha, row_div=1, elem_scale=1, n_texels=s)
    t = shear(flat.transpose(1, 2).contiguous(), beta, row_div=1,
              elem_scale=1, n_texels=s)
    flat = t.transpose(1, 2).contiguous()
    return shear_reduce(flat, alpha, row_div=1, elem_scale=1, n_texels=s,
                        row_lo=row_lo, row_hi=row_hi, groups=c)
