"""KPCN's reconstruction: each pixel's colour is the softmax of its K * K
predicted logits applied to the K x K window of the colour centred on it,
zero outside the image (Bako et al. 2017, eq. 7):

    out[n, c, p] = sum over taps q of softmax(logits[n, :, p])_q * colour[n, c, p + q]

with logits (N, K * K, H, W) (tap q = ky * K + kx at offset (ky - K // 2,
kx - K // 2)) and colour (N, 3, H, W), float32 NCHW. The gradient flows to
the logits only: the colour is data.

On the card `kernel_apply` is two hand-written kernels (`csrc/kpn.cu`): a
forward that makes one pass over each pixel's logits with an online maximum
and sum and keeps each pixel's log-sum-exp, and a backward,
dz_q = exp(z_q - lse) * (g . colour_{p+q} - g . out_p). Both launches count
one in `train.kpn_apply` (core/spans.py) and in `kernel_apply.launches`.
On the CPU the op is the plain composition (`kernel_apply_plain`: the
softmax and `F.unfold`), and `backward_plain` is the backward kernel's
formula. The JAX package has no KPCN, so there is no Pallas kernel here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import spans
from . import cuda_lib

CHANNELS = 3
# A block's pixels and thread groups (csrc/kpn.cu kPixels, kGroups).
BLOCK_PIXELS, GROUPS = 64, 3
# The shared memory a block may ask for on an H100.
MAX_SMEM_BYTES = 232448


def smem_bytes(width: int, k: int) -> int:
    """A block's shared memory at image width `width` and window k
    (csrc/kpn.cu smem_floats): the colour rows its pixels' windows reach."""
    rows = (BLOCK_PIXELS - 1 + width - 1) // width + 1
    staged = CHANNELS * (rows + k - 1) * (width + k - 1)
    return 4 * max(staged, (GROUPS - 1) * (2 + CHANNELS) * BLOCK_PIXELS)


def window(logits: torch.Tensor) -> int:
    """K of logits (N, K * K, H, W); raises unless K * K taps with K odd."""
    taps = logits.shape[1]
    k = round(taps ** 0.5)
    if k * k != taps or k % 2 == 0:
        raise ValueError(f"kernel_apply: {taps} logits a pixel are not an odd K x K window")
    return k


def _check(logits: torch.Tensor, colour: torch.Tensor) -> int:
    """What the kernels take, before anything reaches the card; returns K."""
    if logits.dim() != 4 or colour.dim() != 4:
        raise ValueError(f"kernel_apply: expected 4-d logits and colour, got "
                         f"{tuple(logits.shape)} and {tuple(colour.shape)}")
    k = window(logits)
    n, _, h, w = logits.shape
    if tuple(colour.shape) != (n, CHANNELS, h, w):
        raise ValueError(f"kernel_apply: colour {tuple(colour.shape)} for logits "
                         f"{tuple(logits.shape)}; expected ({n}, {CHANNELS}, {h}, {w})")
    if logits.numel() >= 2**31:
        raise ValueError(f"kernel_apply: {tuple(logits.shape)} is too large for 32-bit counts")
    if smem_bytes(w, k) > MAX_SMEM_BYTES:
        raise ValueError(f"kernel_apply: rows of width {w} with a {k}x{k} window need "
                         f"{smem_bytes(w, k)} bytes of shared memory a block")
    cuda_lib.require_cuda_float32("kernel_apply", logits, colour)
    return k


class _KernelApply(torch.autograd.Function):
    """The kernels' reconstruction of a K x K window; its backward launches
    the gradient to the logits."""

    @staticmethod
    def forward(ctx, logits, colour, k):
        n, _, h, w = logits.shape
        out = torch.empty_like(colour)
        lse = torch.empty((n, h, w), device=logits.device)
        code = cuda_lib.library().litbox_kpn_forward(
            logits.data_ptr(), colour.data_ptr(), out.data_ptr(), lse.data_ptr(), n, h, w, k,
            cuda_lib.stream_handle(logits.device))
        cuda_lib.check(code, "kernel_apply")
        _counted()
        ctx.save_for_backward(logits, colour, lse, out)
        ctx.k = k
        return out

    @staticmethod
    def backward(ctx, g):
        logits, colour, lse, out = ctx.saved_tensors
        g = g.contiguous()
        n, _, h, w = logits.shape
        dz = torch.empty_like(logits)
        code = cuda_lib.library().litbox_kpn_backward(
            logits.data_ptr(), colour.data_ptr(), lse.data_ptr(), out.data_ptr(), g.data_ptr(),
            dz.data_ptr(), n, h, w, ctx.k, cuda_lib.stream_handle(logits.device))
        cuda_lib.check(code, "kernel_apply")
        _counted()
        return dz, None, None


def _counted() -> None:
    kernel_apply.launches += 1
    spans.count("train.kpn_apply", 1)


def kernel_apply(logits: torch.Tensor, colour: torch.Tensor) -> torch.Tensor:
    """The reconstruction (N, 3, H, W) of `colour` by the softmax of
    `logits`, differentiable in the logits: on CPU tensors the plain
    composition; on CUDA tensors the kernels, or the call raises for what
    they do not take."""
    colour = colour.detach()
    if cuda_lib.on_cpu(logits, colour):
        return kernel_apply_plain(logits, colour)
    logits, colour = logits.contiguous(), colour.contiguous()
    return _KernelApply.apply(logits, colour, _check(logits, colour))


kernel_apply.launches = 0


# ----- the plain versions (on any device) -----

def kernel_apply_plain(logits: torch.Tensor, colour: torch.Tensor) -> torch.Tensor:
    """The reconstruction as a composition: the softmax over the taps, the
    colour's K x K windows by F.unfold (zero padding K // 2), their
    weighted sum."""
    k = window(logits)
    n, taps, h, w = logits.shape
    weights = torch.softmax(logits.reshape(n, 1, taps, h * w), dim=2)
    cols = F.unfold(colour, k, padding=k // 2).reshape(n, colour.shape[1], taps, h * w)
    return (weights * cols).sum(2).reshape(n, colour.shape[1], h, w)


def backward_plain(logits: torch.Tensor, colour: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The backward kernel's formula: with lse the log-sum-exp of each
    pixel's logits and out the forward, dz_q = exp(z_q - lse) *
    (g . colour_{p+q} - g . out_p)."""
    k = window(logits)
    n, taps, h, w = logits.shape
    z = logits.reshape(n, taps, h * w)
    lse = torch.logsumexp(z, dim=1, keepdim=True)
    out = kernel_apply_plain(logits, colour).reshape(n, colour.shape[1], 1, h * w)
    cols = F.unfold(colour, k, padding=k // 2).reshape(n, colour.shape[1], taps, h * w)
    gc = g.reshape(n, colour.shape[1], 1, h * w)
    dot = (gc * cols).sum(1) - (gc * out).sum(1)
    return (torch.exp(z - lse) * dot).reshape(logits.shape)
