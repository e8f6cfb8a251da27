"""Batched image rotation by three shears (kernels K2 and K3).

Rotation decomposes into three shears (Paeth): R(t) = Sx(a) Sy(b) Sx(a)
with a = -tan(t/2), b = sin(t). A shear is a per-row 1-D resample with a
row-dependent fractional shift. Angles outside [-45, 45] degrees are handled
by a quadrant pre-rotation (`torch.rot90`). The batch axis carries a
different angle per image (the RBT engine's direction bins).

`shear` replaces the Pallas kernel `litbox_tpu/ops/rotate.py::shear`
(pallas_call at :163) and `shear_reduce` replaces `rotate.py::shear_reduce`
(pallas_call at :210); both are CUDA C++ in `csrc/rotate.cu`. Both are bound
by bytes: shear reads the floats its taps reach and writes its output (0.359
ms at (384, 640, 640) with coefficients up to 0.7 at 3.35 TB/s);
shear_reduce reads the reached floats of the needed rows and writes one
plane a group (0.110 ms at (384, 640, 640), rows [128, 512), 3 groups). A
warp owns an output row segment, so each row's shift is computed once, and
writes 16 bytes a lane: shear loads each chunk's two source chunks into
registers (0.406 ms there on an H100 80GB HBM3 at 700 W, 88%);
shear_reduce walks its group's images in order through a 3-window
cp.async ring a warp (0.137 ms, 80%) and equals the in-order sum of
shear's outputs bit for bit. Both take the JAX functions' arguments in the
JAX order, `coef_bound` included, so a call written for the JAX package
binds the same parameters here. The kernels compute the shift exactly for
any coefficient, so `coef_bound` (the static bound on |coef| that sized the
Pallas roll loop) bounds nothing here.

`rotate_planar_sum_fused` replaces the Pallas kernel
`litbox_tpu/ops/rotate.py::rotate_planar_sum_fused` (pallas_call at :458):
the whole-image three-shear rotation summed per quadrant run, CUDA C++ in
`csrc/rotfused.cu`. It is bound by bytes (one read of every input plane and
one write of each run's partial: 654 MB at 3 x (128, 640, 640), 0.195 ms at
3.35 TB/s). One launch covers every channel and run: a block owns a 32x32
output tile of one channel and one run, stages the source window its
composite reaches for each image of the run (cp.async, a ring of two),
runs the first two shears a column at a time into a shared tile and the
last into register accumulators, in bin order, with no intermediate planes
in device memory and no atomics. An image whose window does not fit a stage
(coefficients beyond the bins' residuals) is evaluated as 8 taps a texel
in the same kernel, chosen on the device, so `delta` may be any tensor and
is never read on the host.

`rotate_bins` and `rotate_bins_uniform` are the JAX version's
channel-interleaved rotation of (D, S, S, C) images (the rotate-back of
`sim/rbt.py::rotate_back`, which the exact collimated field runs on one
bin): K2 at elem_scale C on (D, S, S*C) rows and at row_div C on
(D, S*C, S) rows, then K3 (or K2) at elem_scale C.

A CPU tensor takes the plain PyTorch version; a CUDA tensor takes the kernel
or the call raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_lib

# The JAX package's static coefficient bounds of the Paeth decomposition
# (residual angles in [-45, 45] degrees), passed as `coef_bound` where the
# JAX package passes them.
ALPHA_BOUND = 0.41422  # tan(pi/8) + eps
BETA_BOUND = 0.70712   # sin(pi/4) + eps


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
                elem_scale: int, n_texels: int,
                coef_bound: float = 1.0) -> torch.Tensor:
    """`shear` in plain PyTorch (two gathers and a lerp)."""
    _check_shear(img, coef, row_div, elem_scale, n_texels)
    return _shear_rows_plain(img, coef, 0, row_div, elem_scale, n_texels)


def shear_reduce_plain(img: torch.Tensor, coef: torch.Tensor, row_div: int,
                       elem_scale: int, n_texels: int, coef_bound: float,
                       row_lo: int, row_hi: int, groups: int = 1) -> torch.Tensor:
    """`shear_reduce` in plain PyTorch."""
    _check_reduce(img, coef, row_div, elem_scale, n_texels, row_lo, row_hi, groups)
    n, _, width = img.shape
    out = _shear_rows_plain(img[:, row_lo:row_hi], coef, row_lo, row_div,
                            elem_scale, n_texels)
    out = out.reshape(groups, n // groups, row_hi - row_lo, width).sum(1)
    return out if groups > 1 else out[0]


def shear(img: torch.Tensor, coef: torch.Tensor, row_div: int,
          elem_scale: int, n_texels: int, coef_bound: float = 1.0) -> torch.Tensor:
    """out[d, r, l] = (1-f)*img[d, r, l + i*e] + f*img[d, r, l + (i+1)*e]
    with i + f = coef[d] * (r//row_div + 0.5 - n_texels/2) and e = elem_scale,
    a tap outside texels [0, n_texels) counting 0.

    img (N, R, W) with W = n_texels * elem_scale; the shift axis is the last
    (lane) axis in units of `elem_scale` lanes per texel. `coef_bound` is
    accepted for the JAX signature and not used: the shift is exact for any
    coefficient.
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
                 elem_scale: int, n_texels: int, coef_bound: float,
                 row_lo: int, row_hi: int, groups: int = 1) -> torch.Tensor:
    """Final-pass shear: apply each image's shear to rows [row_lo, row_hi)
    only and sum each contiguous group of N/groups images. Returns
    (groups, row_hi - row_lo, W), or (row_hi - row_lo, W) for groups=1.
    The sum runs over the images of a group in order. `coef_bound` is
    accepted for the JAX signature and not used, as in `shear`."""
    if cuda_lib.on_cpu(img, coef):
        return shear_reduce_plain(img, coef, row_div, elem_scale, n_texels,
                                  coef_bound, row_lo, row_hi, groups)
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


def _to_device(values: np.ndarray, dev) -> torch.Tensor:
    """A host array on `dev` as float32. It goes to the card from pinned
    memory without blocking: a copy from pageable memory would wait for the
    stream."""
    host = torch.from_numpy(np.ascontiguousarray(values, np.float32))
    if torch.device(dev).type == "cuda":
        host = host.pin_memory()
    return host.to(dev, non_blocking=True)


def _residuals(base_angles: tuple, delta, dev) -> torch.Tensor:
    """Per-bin shear residual angles base_res[d] + delta on `dev` (float32).
    A float delta is added on the host, so no scalar is copied to the device
    on its own."""
    base_res = np.asarray(
        [a - round(a / (np.pi / 2)) * (np.pi / 2) for a in base_angles],
        np.float32)
    if not isinstance(delta, torch.Tensor):
        base_res += np.float32(delta)
    res = _to_device(base_res, dev)
    return res + delta.to(dev, torch.float32) if isinstance(delta, torch.Tensor) else res


def rotate_planar_sum(channels: tuple, base_angles: tuple, delta,
                      max_delta: float, row_lo: int, row_hi: int) -> torch.Tensor:
    """Planar-channel rotate-and-accumulate: the RBT display resolve path.

    channels: C tensors of (D, S, S), one per colour plane (the scan's
    outputs). Image d of every channel rotates by base_angles[d] + delta, all
    results sum over d per channel, restricted to output rows
    [row_lo, row_hi). Returns (C, row_hi - row_lo, S).

    base_angles are static: the quadrant pre-rotation is resolved on the
    host into contiguous rot90 slices. `delta` (a float or a 0-d tensor, the
    per-frame jitter phase * 2pi/D, with |delta| <= max_delta) folds into
    the shear residuals. The JAX version widens its kernels' static roll
    bounds by max_delta; the kernels here need no bound, so max_delta only
    checks a float delta (a tensor delta is not read back to the host).
    """
    c = len(channels)
    d, s, s2 = channels[0].shape
    if s != s2 or len(base_angles) != d:
        raise ValueError(f"channels {tuple(channels[0].shape)} vs {len(base_angles)} angles")
    if not isinstance(delta, torch.Tensor) and abs(float(delta)) > max_delta:
        raise ValueError(f"|delta| {abs(float(delta))} exceeds max_delta {max_delta}")
    dev = channels[0].device
    groups = _quadrant_groups(base_angles)
    residual = _residuals(base_angles, delta, dev)

    pre = torch.cat([
        torch.rot90(ch[a:b], k, dims=(1, 2)) if k else ch[a:b]
        for ch in channels for a, b, k in groups], dim=0)    # (C*D, S, S)

    alpha = (-torch.tan(residual / 2.0)).repeat(c)
    beta = torch.sin(residual).repeat(c)
    flat = shear(pre, alpha, row_div=1, elem_scale=1, n_texels=s,
                 coef_bound=ALPHA_BOUND)
    t = shear(flat.transpose(1, 2).contiguous(), beta, row_div=1,
              elem_scale=1, n_texels=s, coef_bound=BETA_BOUND)
    flat = t.transpose(1, 2).contiguous()
    return shear_reduce(flat, alpha, row_div=1, elem_scale=1, n_texels=s,
                        coef_bound=ALPHA_BOUND, row_lo=row_lo, row_hi=row_hi,
                        groups=c)


def _shear_pipeline(pre: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                    d: int, s: int, c: int, reduce_rows: tuple | None) -> torch.Tensor:
    """Three-shear pipeline over pre-quadrant-rotated (D, S, S, C) images,
    channel-interleaved as in the JAX version: the x shears read (D, S, S*C)
    rows at elem_scale C, the y shear (D, S*C, S) rows at row_div C.

    reduce_rows=(row_lo, row_hi) fuses the final x shear with the sum over
    the bin axis (K3) and keeps output rows [row_lo, row_hi): returns
    (row_hi - row_lo, S, C); otherwise (D, S, S, C)."""
    flat = shear(pre.reshape(d, s, s * c), alpha, row_div=1, elem_scale=c,
                 n_texels=s, coef_bound=ALPHA_BOUND)
    # Vertical shear: transpose so y is the lane axis.
    t = flat.reshape(d, s, s, c).permute(0, 2, 3, 1).reshape(d, s * c, s).contiguous()
    t = shear(t, beta, row_div=c, elem_scale=1, n_texels=s, coef_bound=BETA_BOUND)
    flat = t.reshape(d, s, c, s).permute(0, 3, 1, 2).reshape(d, s, s * c).contiguous()
    if reduce_rows is not None:
        lo, hi = reduce_rows
        out = shear_reduce(flat, alpha, row_div=1, elem_scale=c, n_texels=s,
                           coef_bound=ALPHA_BOUND, row_lo=lo, row_hi=hi)
        return out.reshape(hi - lo, s, c)
    flat = shear(flat, alpha, row_div=1, elem_scale=c, n_texels=s,
                 coef_bound=ALPHA_BOUND)
    return flat.reshape(d, s, s, c)


def _check_bins(images: torch.Tensor, n_angles: int) -> tuple[int, int, int]:
    d, s, s2, c = images.shape
    if s != s2 or n_angles != d:
        raise ValueError(f"images {tuple(images.shape)} vs {n_angles} angles")
    return d, s, c


def rotate_bins(images: torch.Tensor, angles: torch.Tensor,
                reduce_rows: tuple | None = None) -> torch.Tensor:
    """Rotate each (S, S, C) image of (D, S, S, C) by its own angle:
    out[d][p] = images[d][R(angles[d]) (p - c) + c], zero outside.

    `angles` is a (D,) tensor and is never read on the host: the quadrant
    pre-rotation stacks the four rot90s and selects each image's on the
    device, as the JAX version does. With reduce_rows=(lo, hi) returns
    sum_d out[d][lo:hi] as (hi - lo, S, C)."""
    d, s, c = _check_bins(images, angles.shape[0])
    angles = angles.to(images.device, torch.float32)
    # Quadrant pre-rotation: sampling with R(t) = R(tr) R90^k means first
    # re-laying the image by R90^k (a rot90 of the array), then the residual.
    # torch.round rounds half to even, as jnp.round does.
    quarters = torch.round(angles / (np.pi / 2))
    k = quarters.long() % 4
    residual = angles - quarters * (np.pi / 2)
    sel = torch.stack([images] + [torch.rot90(images, i, dims=(1, 2))
                                  for i in (1, 2, 3)])       # (4, D, S, S, C)
    pre = sel[k, torch.arange(d, device=images.device)]
    return _shear_pipeline(pre, -torch.tan(residual / 2.0), torch.sin(residual),
                           d, s, c, reduce_rows)


def rotate_bins_uniform(images: torch.Tensor, angles: tuple,
                        reduce_rows: tuple | None = None) -> torch.Tensor:
    """rotate_bins with static per-image angles: the quadrant pre-rotation
    becomes contiguous rot90 slices resolved on the host, and the shear
    coefficients are computed in float64 on the host, as in the JAX
    version."""
    d, s, c = _check_bins(images, len(angles))
    residual = [a - round(a / (np.pi / 2)) * (np.pi / 2) for a in angles]
    pre = torch.cat([torch.rot90(images[a:b], k, dims=(1, 2)) if k else images[a:b]
                     for a, b, k in _quadrant_groups(angles)], dim=0).contiguous()
    alpha = _to_device(np.asarray([-np.tan(t / 2.0) for t in residual]), images.device)
    beta = _to_device(np.asarray([np.sin(t) for t in residual]), images.device)
    return _shear_pipeline(pre, alpha, beta, d, s, c, reduce_rows)


def _check_fused(channels: tuple, base_angles: tuple) -> tuple[int, int]:
    d, s, s2 = channels[0].shape
    if s != s2 or len(base_angles) != d or any(
            ch.shape != channels[0].shape for ch in channels):
        raise ValueError(f"channels {[tuple(ch.shape) for ch in channels]} "
                         f"vs {len(base_angles)} angles")
    return d, s


def _fused_epilogue(parts: torch.Tensor, groups: list) -> torch.Tensor:
    """(C, R, S, S) run partials -> (C, S, S): rot90 each run's partial by
    its quadrant and sum (the JAX version's epilogue, outside its kernel)."""
    total = parts[:, 0]
    if groups[0][2]:
        total = torch.rot90(total, groups[0][2], dims=(1, 2))
    for r, (_, _, k) in enumerate(groups[1:], 1):
        total = total + (torch.rot90(parts[:, r], k, dims=(1, 2)) if k else parts[:, r])
    return total


def rotate_planar_sum_fused_plain(channels: tuple, base_angles: tuple,
                                  delta) -> torch.Tensor:
    """`rotate_planar_sum_fused` in plain PyTorch: per channel, the three
    `shear_plain` passes with explicit transposes, then each run's sum."""
    d, s = _check_fused(channels, base_angles)
    groups = _quadrant_groups(base_angles)
    residual = _residuals(base_angles, delta, channels[0].device)
    alpha = -torch.tan(residual / 2.0)
    beta = torch.sin(residual)
    parts = []
    for ch in channels:
        t = shear_plain(ch, alpha, 1, 1, s)
        t = shear_plain(t.transpose(1, 2).contiguous(), beta, 1, 1, s)
        t = shear_plain(t.transpose(1, 2).contiguous(), alpha, 1, 1, s)
        parts.append(torch.stack([t[a:b].sum(0) for a, b, _ in groups]))
    return _fused_epilogue(torch.stack(parts), groups)


def rotate_planar_sum_fused(channels: tuple, base_angles: tuple,
                            delta, counts: torch.Tensor | None = None) -> torch.Tensor:
    """Fused planar rotate-and-accumulate: sum_d R(base_angles[d] + delta)
    applied to image d of each channel plane; returns (C, S, S).

    The kernel computes per-quadrant-run partial sums of the three shears
    WITHOUT the rot90 pre-rotation of `rotate_planar_sum`; the epilogue
    rotates the R <= 5 run partials by their quadrant instead (rotations
    about a common center commute, up to interpolation order). Any delta
    works: the shifts have no static bound. base_angles are static; `delta`
    is a float or a 0-d tensor. At most 8 runs; one launch for up to 8
    channels.

    `counts`, for measurement: an int64 (4,) tensor on the channels' card to
    which the kernel adds the (image, tile) windows it took, those it staged,
    their output texels and the bytes their copies read from device memory.
    The plain version counts nothing.
    """
    if cuda_lib.on_cpu(*channels):
        if counts is not None:
            raise ValueError("rotate_planar_sum_fused: counts come from the kernel only")
        return rotate_planar_sum_fused_plain(channels, base_angles, delta)
    cuda_lib.require_cuda_float32("rotate_planar_sum_fused", *channels)
    d, s = _check_fused(channels, base_angles)
    groups = _quadrant_groups(base_angles)
    dev = channels[0].device
    residual = _residuals(base_angles, delta, dev)
    alpha = (-torch.tan(residual / 2.0)).contiguous()
    beta = torch.sin(residual).contiguous()
    c, n_runs = len(channels), len(groups)
    out = torch.empty((c, n_runs, s, s), device=dev)
    counts_ptr = cuda_lib.counts_pointer("rotate_planar_sum_fused", counts, 4, dev)
    ptrs = (ctypes.c_void_p * c)(*[ch.data_ptr() for ch in channels])
    starts = (ctypes.c_int * (n_runs + 1))(*[g[0] for g in groups], d)
    code = cuda_lib.library().litbox_rot3sum(
        ctypes.cast(ptrs, ctypes.c_void_p), alpha.data_ptr(), beta.data_ptr(),
        out.data_ptr(), c, d, s, n_runs, ctypes.cast(starts, ctypes.c_void_p),
        counts_ptr, cuda_lib.stream_handle(dev))
    cuda_lib.check(code, "rotate_planar_sum_fused")
    rotate_planar_sum_fused.launches += 1
    return _fused_epilogue(out, groups)


rotate_planar_sum_fused.launches = 0
