"""The training step's convolutions: float32, NCHW, stride 1, a 1x1, 3x3 or
5x5 kernel with zero padding, over the whole batch, forward and backward.

On the card each direction is one hand-written implicit GEMM
(`csrc/conv.cu`): the forward, the data gradient (the gradient of the
tensor the convolution saw, the padded one where `Conv3x3` pads) and the
weight and bias gradients, each followed by a small reduction launch where
its sum is split across blocks. No column buffer is written and no loop
runs over the batch. The arithmetic is float32 FFMA with float32 sums, in
an order fixed by the shapes alone, so two calls give the same bits.

The JAX package has no Pallas kernel here: its convolutions are XLA's. With
cuDNN off, PyTorch's own convolution copies every item's input into columns
and multiplies them one item at a time; those copies were the step's
largest device operations.

`step_convolutions(device)` surrounds a training step's forward and
backward: on a CUDA device it turns cuDNN off and routes `convolve`, what
the net's convolutions (`nn.unet.StepConv2d`, in the UNet and in KPCN's
trunk, and the sharded step's channel slices) call, to `conv2d`;
elsewhere it changes nothing. `conv2d` alone places a call: CPU tensors
take `F.conv2d`; CUDA tensors take the kernels or the call raises, so
every convolution of the net in a step on a card runs the kernels (the
loss's Sobel filters, nn/loss.py, are not the net's and keep PyTorch's own
grouped convolution). Inside a step each call the
kernels serve counts one in `train.conv_kernel` (core/spans.py). Outside
a step, `convolve` is nn.Conv2d's own path, untouched. `conv2d.launches`
counts the kernel directions launched (the forward, the data gradient,
the weight gradient).

The tile each launch takes follows the layer's shape (`plan_forward`,
`plan_weight_grad`): the output channels choose a tile of 128, 64, 32 or 16
of them and a strip of pixels as wide as a block's 256 threads then cover;
where the tiles are fewer than the card holds at once, the depth of the sum
is split across blocks. A plan is reckoned once a shape (a step asks for
the same few dozen on every call).
"""

from __future__ import annotations

import contextlib
import fractions
import functools

import torch
import torch.nn.functional as F
from torch import nn

from ..core import spans
from . import cuda_lib

# (pixels, channels, input channels a depth step) of a block's output tile
# in the forward and the data gradient (csrc/conv.cu fwd_tile); a step takes
# one tap of its input channels.
FORWARD_TILES = ((128, 128, 16), (256, 64, 16), (512, 32, 8), (1024, 16, 4))
# (taps, channels, pixels a depth step) of the weight gradient's tiles
# (csrc/conv.cu wgrad_tile).
WEIGHT_GRAD_TILES = ((128, 128, 16), (128, 64, 16), (64, 32, 32), (64, 16, 64))
# Gradient floats of one plane a partial sum of the bias gradient takes
# (csrc/conv.cu kBiasChunk).
BIAS_CHUNK = 16384
# Blocks the card runs at once: two on each of an H100's 132 SMs. A grid of
# fewer tiles than two waves of these may split the depth of its sums.
CARD_BLOCKS = 264
# The fewest depth steps a split takes.
MIN_SPLIT_STEPS = 16
# The most sums of its tile a split of the weight gradient adds into its
# running total, whatever the card's waves (a group's register tile joins
# the total every FLUSH_ROWS of its depth rows, csrc/conv.cu
# kFlushWeightGrad). Longer running totals stray further from float64 than
# PyTorch's per-item products: KPCN's 100 -> 441 layer over 64 x 65^2
# pixels in three splits of 1,414 sums read 2.35 times PyTorch's distance.
# The UNet cells' plans take at most 80.
MAX_SPLIT_FLUSHES = 256
FLUSH_ROWS = 64
# Offsets inside the kernels are 32-bit.
MAX_ELEMENTS = 2**31 - 1
# The square kernels the launches are built for (csrc/conv.cu fwd_tile and
# wgrad_tile): the UNets' 1x1 and 3x3, KPCN's 5x5.
KERNEL_SIZES = (1, 3, 5)


def _tile(channels: int) -> int:
    """The tile index for a product of `channels` output channels."""
    return 0 if channels > 64 else 1 if channels > 32 else 2 if channels > 16 else 3


def _splits(tiles: int, steps: int, least: int = 1) -> int:
    """How many blocks share each tile's depth of `steps` steps: the count,
    from `least` up to two waves of CARD_BLOCKS blocks in all and
    MIN_SPLIT_STEPS steps a split (up to twice `least` where `least` is
    more), that takes the fewest waves of the card for its work (the fewest
    splits among equals), with no split empty."""
    most = min(steps // MIN_SPLIT_STEPS, -(-2 * CARD_BLOCKS // tiles))
    if least > 1 and least > most:
        most = min(2 * least, steps)
    if most < 2:
        return 1
    want = min(range(least, most + 1),
               key=lambda n: fractions.Fraction(-(-tiles * n // CARD_BLOCKS), n))
    per = -(-steps // want)
    return -(-steps // per)


@functools.cache
def plan_forward(pixels: int, channels: int, in_channels: int, k: int) -> tuple[int, int]:
    """(tile, splits) of the forward or the data gradient: `pixels` output
    pixels (N * Ho * Wo), `channels` output channels, a sum over k * k taps
    of `in_channels` input channels."""
    tile = _tile(channels)
    bm, bn, bk = FORWARD_TILES[tile]
    tiles = -(-pixels // bm) * -(-channels // bn)
    return tile, _splits(tiles, k * k * -(-in_channels // bk))


@functools.cache
def plan_weight_grad(images: int, plane: int, channels: int, depth: int) -> tuple[int, int]:
    """(tile, splits) of the weight gradient: `channels` output channels,
    `depth` taps (input channels * k * k), a sum over `images` planes of
    `plane` output pixels, no split adding more than MAX_SPLIT_FLUSHES sums
    of its tile into its total."""
    tile = _tile(channels)
    bm, bn, bk = WEIGHT_GRAD_TILES[tile]
    tiles = -(-depth // bm) * -(-channels // bn)
    plane_steps = -(-plane // bk)
    steps = images * plane_steps
    return tile, _splits(tiles, steps, -(-steps // (MAX_SPLIT_FLUSHES
                                                    * flush_steps(tile, plane_steps))))


def flush_steps(tile: int, plane_steps: int) -> int:
    """The depth steps between a weight-gradient tile's joins of its running
    total (csrc/conv.cu conv_wgrad_kernel): FLUSH_ROWS rows of its thread
    groups' (256 * 64 / (BM * BN) groups, a step's pixels shared among
    them), and at least once a plane."""
    bm, bn, bk = WEIGHT_GRAD_TILES[tile]
    return min(FLUSH_ROWS // (bk * bm * bn // (256 * 64)), plane_steps)


def _out_size(size: int, k: int, padding: int) -> int:
    return size + 2 * padding - k + 1


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
           padding: int) -> None:
    """What the kernels take, before anything reaches the card: x (N, Cin,
    H, W) and weight (Cout, Cin, k, k) with k in KERNEL_SIZES, padding below k, bias
    (Cout,) or None, contiguous float32 on the current CUDA device, and
    every tensor of the three directions under 2^31 elements."""
    dtypes = {t.dtype for t in (x, weight, bias) if t is not None}
    if dtypes != {torch.float32}:
        raise TypeError(f"conv2d: the kernels take float32, got {dtypes}")
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError(f"conv2d: expected 4-d input and weight, got {tuple(x.shape)} "
                         f"and {tuple(weight.shape)}")
    cout, cin, kh, kw = weight.shape
    n, c, h, w = x.shape
    if kh != kw or kh not in KERNEL_SIZES:
        raise ValueError(f"conv2d: the kernels take square weights, 1x1 and 3x3 as the UNets "
                         f"have them and 5x5 as KPCN has them; got {kh}x{kw}")
    if c != cin:
        raise ValueError(f"conv2d: input of {c} channels for a weight of {cin}")
    if not 0 <= padding < kh:
        raise ValueError(f"conv2d: padding {padding} for a {kh}x{kh} kernel")
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"conv2d: bias of {tuple(bias.shape)} for {cout} channels")
    ho, wo = _out_size(h, kh, padding), _out_size(w, kh, padding)
    if min(n, c, cout, ho, wo) < 1:
        raise ValueError(f"conv2d: an empty convolution, {tuple(x.shape)} by "
                         f"{tuple(weight.shape)} with padding {padding}")
    if max(n * c * (h + 2 * padding) * (w + 2 * padding), n * cout * ho * wo,
           kh * kh * cin * (cout + 3)) > MAX_ELEMENTS:
        raise ValueError(f"conv2d: {tuple(x.shape)} by {tuple(weight.shape)} is too large "
                         f"for the kernels' 32-bit offsets")
    cuda_lib.require_cuda_float32("conv2d", *(t for t in (x, weight, bias) if t is not None))


def _launch_forward(inp, weight, bias, out, pad: int, data_grad: bool, tile: int,
                    splits: int) -> None:
    """litbox_conv_fwd: out (N, C', H', W') from inp (N, C, H, W) and the
    layer's weight as conv_fwd_kernel states it (csrc/conv.cu), through a
    scratch copy of the weight laid out [tap][C][C' rounded up to 4]."""
    n, c, h, w = inp.shape
    k = weight.shape[2]
    ws = torch.empty(splits * out.numel(), device=out.device) if splits > 1 else None
    laid_out = torch.empty(k * k * c * -(-out.shape[1] // 4) * 4, device=out.device)
    code = cuda_lib.library().litbox_conv_fwd(
        inp.data_ptr(), weight.data_ptr(), laid_out.data_ptr(),
        None if bias is None else bias.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(), n, c, h, w, out.shape[1],
        out.shape[2], out.shape[3], pad, k, int(data_grad), tile, splits,
        cuda_lib.stream_handle(out.device))
    cuda_lib.check(code, "conv2d")


def _launch_weight_grad(x, gy, gw, gb, tile: int, splits: int) -> None:
    """litbox_conv_wgrad: gw (Cout, Cin, k, k) and gb (Cout,) or None of the
    unpadded convolution of x whose output's gradient is gy."""
    n, c, h, w = x.shape
    cout, ho, wo = gy.shape[1:]
    k = gw.shape[2]
    parts = n * -(-(ho * wo) // BIAS_CHUNK) if gb is not None else 0
    tiles = splits * cout * c * k * k if splits > 1 else 0
    ws = torch.empty(max(tiles + 2 * cout * parts, 1), device=x.device)
    code = cuda_lib.library().litbox_conv_wgrad(
        x.data_ptr(), gy.data_ptr(), gw.data_ptr(), None if gb is None else gb.data_ptr(),
        ws.data_ptr(), n, c, h, w, cout, ho, wo, k, tile, splits,
        cuda_lib.stream_handle(x.device))
    cuda_lib.check(code, "conv2d")


def _forward(x, weight, bias, padding: int) -> torch.Tensor:
    n, _, h, w = x.shape
    cout, cin, k, _ = weight.shape
    out = torch.empty((n, cout, _out_size(h, k, padding), _out_size(w, k, padding)),
                      device=x.device)
    tile, splits = plan_forward(n * out.shape[2] * out.shape[3], cout, cin, k)
    _launch_forward(x, weight, bias, out, padding, False, tile, splits)
    conv2d.launches += 1
    return out


def _data_grad(gy, weight, shape, padding: int) -> torch.Tensor:
    """The gradient of the convolution's input of `shape`: the forward
    kernel on gy with the weight transposed and its taps reversed, padding
    k - 1 - padding."""
    cout, cin, k, _ = weight.shape
    gx = torch.empty(shape, device=gy.device)
    tile, splits = plan_forward(shape[0] * shape[2] * shape[3], cin, cout, k)
    _launch_forward(gy, weight, None, gx, k - 1 - padding, True, tile, splits)
    conv2d.launches += 1
    return gx


def _weight_grad(x, gy, shape, padding: int, bias: bool):
    """The weight and bias gradients; a padded convolution's input is
    padded here, as the kernel takes unpadded ones."""
    cout, cin, k, _ = shape
    gw = torch.empty(shape, device=x.device)
    gb = torch.empty(cout, device=x.device) if bias else None
    if padding:
        x = F.pad(x, (padding,) * 4)
    tile, splits = plan_weight_grad(x.shape[0], gy.shape[2] * gy.shape[3], cout, cin * k * k)
    _launch_weight_grad(x, gy, gw, gb, tile, splits)
    conv2d.launches += 1
    return gw, gb


class _Conv2d(torch.autograd.Function):
    """The kernels' convolution; its backward launches the data gradient
    and the weight and bias gradients that autograd asks for."""

    @staticmethod
    def forward(ctx, x, weight, bias, padding):
        ctx.save_for_backward(x, weight)
        ctx.padding = padding
        ctx.has_bias = bias is not None
        return _forward(x, weight, bias, padding)

    @staticmethod
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        gy = gy.contiguous()
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = _data_grad(gy, weight, x.shape, ctx.padding)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            gw, gb = _weight_grad(x, gy, weight.shape, ctx.padding, ctx.has_bias)
        return gx, gw, gb, None


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
           padding: int = 0) -> torch.Tensor:
    """F.conv2d(x, weight, bias, padding=padding) at stride 1: on CPU tensors
    F.conv2d itself; on CUDA tensors the kernels (differentiable), or the
    call raises for what they do not take (see `_check`), counted in
    train.conv_kernel inside `step_convolutions`."""
    if cuda_lib.on_cpu(*(t for t in (x, weight, bias) if t is not None)):
        return F.conv2d(x, weight, bias, padding=padding)
    # .contiguous(): the net's input arrives permuted from NHWC.
    x = x.contiguous()
    _check(x, weight, bias, padding)
    y = _Conv2d.apply(x, weight, bias, padding)
    if _steps:
        spans.count("train.conv_kernel", 1)
    return y


conv2d.launches = 0


# ----- the plain versions of the kernels' products (on any device) -----

def data_grad_plain(gy: torch.Tensor, weight: torch.Tensor, padding: int) -> torch.Tensor:
    """The data gradient as the kernel forms it: the forward's product on gy
    with the weight transposed and its taps reversed, padding
    k - 1 - padding."""
    return forward_plain(gy, weight, None, weight.shape[2] - 1 - padding, True)


def forward_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, pad: int,
                  data_grad: bool = False) -> torch.Tensor:
    """The forward kernel's product: the sum over taps of the input shifted
    by the tap times that tap's matrix B[c][j], w[j][c][tap] for the
    forward, w[c][j][k*k-1-tap] for the data gradient."""
    n, c, h, w = x.shape
    k = weight.shape[2]
    xp = F.pad(x, (pad,) * 4)
    ho, wo = h + 2 * pad - k + 1, w + 2 * pad - k + 1
    taps = weight.reshape(*weight.shape[:2], k * k)
    out = 0
    for tap in range(k * k):
        ky, kx = divmod(tap, k)
        shifted = xp[:, :, ky:ky + ho, kx:kx + wo]
        b = taps[:, :, k * k - 1 - tap] if data_grad else taps[:, :, tap].T
        out = out + torch.einsum("nchw,cd->ndhw", shifted, b)
    return out if bias is None else out + bias[:, None, None]


def weight_grad_plain(x: torch.Tensor, gy: torch.Tensor, k: int, padding: int):
    """(weight gradient, bias gradient) as the kernels form them: the
    gathered taps of x times gy summed over every pixel of the batch, and
    the sum of gy."""
    n, cout = gy.shape[:2]
    cols = F.unfold(x, k, padding=padding)  # (N, Cin k k, pixels)
    g = torch.einsum("ncp,nkp->ck", gy.reshape(n, cout, -1), cols)
    return g.reshape(cout, x.shape[1], k, k), gy.sum((0, 2, 3))


# ----- the net's convolutions inside a training step -----

_steps = 0  # step_convolutions entered on a card and not yet left


@contextlib.contextmanager
def step_convolutions(device: str | torch.device):
    """The convolutions of a training step's forward and backward: on a
    CUDA device, `convolve` goes to `conv2d`, with cuDNN off (restored on
    exit); elsewhere nothing changes. In float32 on HDR crops, cuDNN's
    gradients of TrainConfig()'s net strayed up to 1.15e-3 of the largest
    gradient from float64 (the first residual block's conv1 weight, on an
    H100); the kernels stay within twice PyTorch's own float32 distance
    layer by layer. The backward launches its kernels when it runs, so the
    loss's backward belongs inside too. Inference keeps cuDNN."""
    global _steps
    if torch.device(device).type != "cuda":
        yield
        return
    saved = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    _steps += 1
    try:
        yield
    finally:
        _steps -= 1
        torch.backends.cudnn.enabled = saved


def _check_layer(conv: nn.Conv2d) -> None:
    """What `conv2d` cannot see of an nn.Conv2d: stride 1, no dilation or
    groups, and the same zero padding on every side."""
    p = conv.padding
    if (conv.stride != (1, 1) or conv.dilation != (1, 1) or conv.groups != 1
            or conv.padding_mode != "zeros" or isinstance(p, str) or p[0] != p[1]):
        raise ValueError(f"conv2d: the kernels take stride 1, zero padding alike on every "
                         f"side, no dilation or groups; got {conv}")


def convolve(conv: nn.Conv2d, x: torch.Tensor, weight: torch.Tensor,
             bias: torch.Tensor | None) -> torch.Tensor:
    """The convolution of layer `conv` with `weight` and `bias` (the
    layer's own, or a slice of them): inside `step_convolutions`,
    `conv2d` (raising for a layer it cannot take); outside, nn.Conv2d's
    own path."""
    if not _steps:
        return conv._conv_forward(x, weight, bias)
    _check_layer(conv)
    return conv2d(x, weight, bias, conv.padding[0])
