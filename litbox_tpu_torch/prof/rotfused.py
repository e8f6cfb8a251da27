"""The cost split of the fused rotate-and-sum (K4): four stripped-down
variants, each summing N float32 (S, S) images into one (S, S) plane
(counterpart of runs/prof_rotfused.py::run_variant, pallas_call at :38).

    V1 copy_accum        sum_d img[d]                       the read floor
    V2 transpose2_accum  sum_d (img[d]^T)^T, both transposes in shared memory
    V3 shear1_accum      sum_d X_alpha[d](img[d])           one shear's 2 taps
    V4 shear3_accum      sum_d X_a(X_b(X_a(img[d])))        three shears, no transposes

V3 and V4 are one kernel, templated on the number of shears.

X_c shifts row y by c * (y + 0.5 - S/2) texels with a two-tap lerp, zero
outside the image (`ops.rotate.shear` with row_div = elem_scale = 1). The
kernels are CUDA C++ in `csrc/prof_rotfused.cu`, built into the port's one
library; each sums in image order. A CPU tensor takes the plain PyTorch
version; a CUDA tensor takes the kernel or the call raises.
"""

from __future__ import annotations

import torch

from ..ops import cuda_lib
from ..ops.rotate import shear_plain


def _check(img: torch.Tensor, *coefs: torch.Tensor) -> tuple[int, int]:
    if img.ndim != 3 or img.shape[1] != img.shape[2]:
        raise ValueError(f"img must be (N, S, S), got {tuple(img.shape)}")
    n, s = img.shape[0], img.shape[1]
    for c in coefs:
        if tuple(c.shape) != (n,):
            raise ValueError(f"coefficients {tuple(c.shape)} must be ({n},)")
    return n, s


def copy_accum_plain(img: torch.Tensor) -> torch.Tensor:
    _check(img)
    return img.sum(0)


def transpose2_accum_plain(img: torch.Tensor) -> torch.Tensor:
    _check(img)
    return img.transpose(1, 2).contiguous().transpose(1, 2).contiguous().sum(0)


def shear1_accum_plain(img: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    _, s = _check(img, alpha)
    return shear_plain(img, alpha, 1, 1, s).sum(0)


def shear3_accum_plain(img: torch.Tensor, alpha: torch.Tensor,
                       beta: torch.Tensor) -> torch.Tensor:
    _, s = _check(img, alpha, beta)
    t = shear_plain(img, alpha, 1, 1, s)
    t = shear_plain(t, beta, 1, 1, s)
    return shear_plain(t, alpha, 1, 1, s).sum(0)


def _prepare(name: str, img: torch.Tensor, *coefs: torch.Tensor):
    """Check a CUDA call's arguments; return (N, S, output plane, stream)."""
    cuda_lib.require_cuda_float32(name, img, *coefs)
    n, s = _check(img, *coefs)
    return n, s, torch.empty((s, s), device=img.device), cuda_lib.stream_handle(img.device)


def copy_accum(img: torch.Tensor) -> torch.Tensor:
    """V1: the images' sum, each byte read once with 16-byte loads."""
    if cuda_lib.on_cpu(img):
        return copy_accum_plain(img)
    n, s, out, stream = _prepare("copy_accum", img)
    if s * s % 4:
        raise ValueError(f"copy_accum needs S*S divisible by 4, got S={s}")
    cuda_lib.check(cuda_lib.library().litbox_prof_copy_accum(
        img.data_ptr(), out.data_ptr(), n, s, stream), "copy_accum")
    copy_accum.launches += 1
    return out


copy_accum.launches = 0


def transpose2_accum(img: torch.Tensor) -> torch.Tensor:
    """V2: one launch, no scratch in device memory. A block per 32x32 output
    tile walks the images in order; each image's tile arrives by cp.async
    in a ring of six shared stages, five images ahead, and is transposed
    twice in shared memory into the accumulator. Bound by the bytes read,
    as V1. Sums in V1's order, so the two agree bit for bit. Any S: 16-byte
    copies where S % 4 == 0, 4-byte ones otherwise."""
    if cuda_lib.on_cpu(img):
        return transpose2_accum_plain(img)
    n, s, out, stream = _prepare("transpose2_accum", img)
    cuda_lib.check(cuda_lib.library().litbox_prof_transpose2_accum(
        img.data_ptr(), out.data_ptr(), n, s, stream), "transpose2_accum")
    transpose2_accum.launches += 1
    return out


transpose2_accum.launches = 0


def shear1_accum(img: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """V3: one x-shear of every image by alpha[d], summed (S <= 1024, the
    widest row a window stages, as V4). V4's kernel with its last shear
    only: a block per row, its warps each summing a contiguous range of the
    images in order through a ring of two cp.async windows, the partials
    added in warp order (two calls agree bit for bit). The kernel chooses
    the warps a row from N."""
    if cuda_lib.on_cpu(img, alpha):
        return shear1_accum_plain(img, alpha)
    n, s, out, stream = _prepare("shear1_accum", img, alpha)
    if s > 1024:
        raise ValueError(f"shear1_accum stages a row of at most 1024, got S={s}")
    cuda_lib.check(cuda_lib.library().litbox_prof_shear1_accum(
        img.data_ptr(), alpha.data_ptr(), out.data_ptr(), n, s, stream),
        "shear1_accum")
    shear1_accum.launches += 1
    return out


shear1_accum.launches = 0


def shear3_accum(img: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                 counts: torch.Tensor | None = None) -> torch.Tensor:
    """V4: x-shears by alpha, beta and alpha of every image's rows, summed
    (S <= 1024). A block per row, four warps each summing a contiguous
    quarter of the images in order, the partials added in warp order (two
    calls agree bit for bit). Each warp keeps the next row in flight through
    a ring of two cp.async windows and runs the three uniform-shift shears
    in place in the window, the last into registers.

    `counts`, for measurement: an int64 (1,) tensor on the card to which the
    kernel adds the bytes its copies read from device memory. The plain
    version counts nothing."""
    if cuda_lib.on_cpu(img, alpha, beta):
        if counts is not None:
            raise ValueError("shear3_accum: counts come from the kernel only")
        return shear3_accum_plain(img, alpha, beta)
    n, s, out, stream = _prepare("shear3_accum", img, alpha, beta)
    if s > 1024:
        raise ValueError(f"shear3_accum stages a row of at most 1024, got S={s}")
    cuda_lib.check(cuda_lib.library().litbox_prof_shear3_accum(
        img.data_ptr(), alpha.data_ptr(), beta.data_ptr(), out.data_ptr(), n, s,
        cuda_lib.counts_pointer("shear3_accum", counts, 1, img.device), stream),
        "shear3_accum")
    shear3_accum.launches += 1
    return out


shear3_accum.launches = 0
