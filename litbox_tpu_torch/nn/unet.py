"""Litbox denoiser UNet in PyTorch (counterpart of the JAX package's
nn/unet.py; reference: litbox_model.py:27-302).

Single-channel UNet with
  conv_in:    3x3 conv -> ReLU -> ResidualBlock
  encoders:   unet_size x [ResBlock(C->2C), MaxPool2]
  bottleneck: ResBlock(C->2C), ResBlock(2C->2C)
  decoders:   unet_size x [3x3 conv C->4*(C/2), PixelShuffle(2),
              concat skip, 2x ResBlock]
  conv_out:   3x3 conv -> out_channels (+ optional sigmoid)
ResidualBlock = conv-BN-ReLU-conv-BN + 1x1 shortcut, final ReLU.

The public boundary is NHWC, as in the JAX package (`forward` takes and
returns (B, H, W, C)); inside, the layers run in PyTorch's NCHW. Module
and parameter names follow the Flax tree (`enc0.conv1.conv.weight` is Flax's
`enc0/conv1/Conv_0/kernel`), so `convert.unet_from_flax` carries weights
across by name.

`forward(x, train=False)` mirrors Flax's `train` argument: at inference
BatchNorm normalizes with its running statistics (eps 1e-5, as in Flax);
in training with the batch's biased statistics over (N, H, W), computed as
Flax computes them (E[x^2] - E[x]^2, clipped at 0), and it updates the
running statistics in place as Flax does, ra = 0.9 ra + 0.1 batch with the
biased variance (`F.batch_norm(training=True)` would take the unbiased
one). `init_weights` draws Flax's initialization, `import_torch_state`
reads the reference's `.pth` layout.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv

_PAD_MODES = {"reflect": "reflect", "zeros": "constant", "replicate": "replicate"}


class StepConv2d(nn.Conv2d):
    """nn.Conv2d whose convolution goes through `ops.conv.convolve`: inside
    a training step on a card (ops.conv.step_convolutions) the port's
    kernels, anywhere else nn.Conv2d's own."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv.convolve(self, x, self.weight, self.bias)


class Conv3x3(nn.Module):
    """3x3 convolution after a one-texel pad of `padding_mode`."""

    def __init__(self, in_channels: int, features: int, padding_mode: str = "reflect"):
        super().__init__()
        self.pad_mode = _PAD_MODES[padding_mode]
        self.conv = StepConv2d(in_channels, features, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (1, 1, 1, 1), mode=self.pad_mode))


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """The BatchNorm2d that `_bn` runs, with one hook: `reduce_moments`.

    None on a single device. Otherwise a function (mean, mean_sq) ->
    (mean, mean_sq) that `_bn` applies in training to the local batch's
    E[x] and E[x^2] over (N, H, W); the data-parallel step
    (parallel/train_sharded.py) sets it on every instance to average them
    over its ranks, so that the statistics are the global batch's."""

    reduce_moments = None


class ResidualBlock(nn.Module):
    """conv-BN-ReLU-conv-BN + shortcut, final ReLU (litbox_model.py:5-25)."""

    def __init__(self, in_channels: int, features: int, padding_mode: str = "reflect"):
        super().__init__()
        self.conv1 = Conv3x3(in_channels, features, padding_mode)
        self.bn1 = FlaxBatchNorm2d(features, eps=1e-5)
        self.conv2 = Conv3x3(features, features, padding_mode)
        self.bn2 = FlaxBatchNorm2d(features, eps=1e-5)
        self.shortcut = (StepConv2d(in_channels, features, 1)
                         if in_channels != features else None)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self.shortcut(x)
        y = F.relu(_bn(self.bn1, self.conv1(x), train))
        y = _bn(self.bn2, self.conv2(y), train)
        return F.relu(y + shortcut)


def _bn(bn: FlaxBatchNorm2d, x: torch.Tensor, train: bool) -> torch.Tensor:
    """Flax's BatchNorm on NCHW x, whatever the module's mode: the running
    statistics unless `train`; else the batch's, E[x^2] - E[x]^2 clipped at
    0 as jnp.maximum clips (half the gradient at a tie), with the running
    statistics moved towards them in place (bn.momentum 0.1 is Flax's 0.9).
    The batch's moments pass through `bn.reduce_moments` first, if set."""
    if not train:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                            training=False, eps=bn.eps)
    mean = x.mean(dim=(0, 2, 3))
    mean_sq = (x * x).mean(dim=(0, 2, 3))
    if bn.reduce_moments is not None:
        mean, mean_sq = bn.reduce_moments(mean, mean_sq)
    var = torch.maximum(mean_sq - mean * mean, x.new_zeros(()))
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.copy_((1.0 - m) * bn.running_mean + m * mean)
        bn.running_var.copy_((1.0 - m) * bn.running_var + m * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]


def pixel_shuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """torch.nn.PixelShuffle in NHWC: channel index c*r*r + i*r + j."""
    b, h, w, c = x.shape
    co = c // (r * r)
    x = x.reshape(b, h, w, co, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, co)


class LitboxDenoiserNet(nn.Module):
    """Denoiser UNet (litbox_model.py:27-302), every option of the JAX
    package's net.

    global_residual=True adds the network input to the output of a final
    3x3 conv with zero padding ("SAME"); out_channels=3 is the RGB realtime
    display variant, 1 the reference's mono net (channels as batch).
    """

    def __init__(self, unet_size: int = 5, initial_features: int = 32,
                 padding_mode: str = "reflect", use_sigmoid: bool = False,
                 global_residual: bool = False, out_channels: int = 1,
                 in_channels: int | None = None):
        super().__init__()
        self.unet_size = unet_size
        self.use_sigmoid = use_sigmoid
        self.global_residual = global_residual
        self.out_channels = out_channels
        in_channels = out_channels if in_channels is None else in_channels
        f, pm = initial_features, padding_mode
        self.conv_in = Conv3x3(in_channels, f, pm)
        self.res_in = ResidualBlock(f, f, pm)
        c = f
        for i in range(unet_size):
            self.add_module(f"enc{i}", ResidualBlock(c, 2 * c, pm))
            c *= 2
        self.bott0 = ResidualBlock(c, 2 * c, pm)
        self.bott1 = ResidualBlock(2 * c, 2 * c, pm)
        c *= 2
        for i in range(unet_size):
            # Decoder convs pad with zeros, as the reference's default-pad
            # conv (litbox_model.py:293).
            self.add_module(f"dec{i}", Conv3x3(c, (c // 2) * 4, "zeros"))
            c //= 2
            self.add_module(f"skip{i}a", ResidualBlock(2 * c, c, pm))
            self.add_module(f"skip{i}b", ResidualBlock(c, c, pm))
        self.conv_out = (StepConv2d(c, out_channels, 3, padding=1) if global_residual
                         else Conv3x3(c, out_channels, "zeros"))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, H, W, C) -> (B, H, W, out_channels); H and W divisible by
        2^unet_size. `train` normalizes with the batch's statistics and
        updates the running ones (Flax's train=True)."""
        x = x.permute(0, 3, 1, 2)
        y = F.relu(self.conv_in(x))
        y = self.res_in(y, train)
        skips = []
        for i in range(self.unet_size):
            y = getattr(self, f"enc{i}")(y, train)
            skips.append(y)
            y = F.max_pool2d(y, 2)
        y = self.bott1(self.bott0(y, train), train)
        for i in range(self.unet_size):
            y = F.pixel_shuffle(getattr(self, f"dec{i}")(y), 2)
            y = torch.cat([y, skips[self.unet_size - 1 - i]], dim=1)
            y = getattr(self, f"skip{i}a")(y, train)
            y = getattr(self, f"skip{i}b")(y, train)
        y = self.conv_out(y)
        if self.global_residual:
            y = y + x
        if self.use_sigmoid:
            y = torch.sigmoid(y)
        return y.permute(0, 2, 3, 1)


def conv_shapes(batch: int, height: int, width: int, **net_args) -> list[tuple]:
    """Each distinct convolution of a training forward of
    LitboxDenoiserNet(**net_args) on (batch, height, width, C), in the order
    of first use: (N, Cin, Cout, H, W, k, padding), H and W those of the
    tensor the convolution sees (padded by Conv3x3 where it pads). Traced on
    the meta device."""
    net = LitboxDenoiserNet(**net_args).to("meta")
    shapes = []

    def record(module, args, _out):
        n, c, h, w = args[0].shape
        shape = (n, c, module.out_channels, h, w, module.kernel_size[0], module.padding[0])
        if shape not in shapes:
            shapes.append(shape)

    for m in net.modules():
        if isinstance(m, StepConv2d):
            m.register_forward_hook(record)
    x = torch.empty((batch, height, width, net.conv_in.conv.in_channels), device="meta")
    net(x, train=True)
    return shapes


# Flax's lecun_normal: a normal truncated at two standard deviations, scaled
# so that the draws have variance 1/fan_in (the truncation's own standard
# deviation is 0.8796...).
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_weights(net: LitboxDenoiserNet, generator: torch.Generator) -> LitboxDenoiserNet:
    """Flax's initialization of the net, in place: conv kernels lecun_normal
    (a truncated normal of variance 1/fan_in, fan_in = I*kh*kw), conv biases
    0, BatchNorm scale 1 and bias 0, running mean 0 and var 1; under
    global_residual conv_out's kernel is 0, so the untrained net is the
    identity. The draws come from `generator`, which must lie on the
    weights' device."""
    for name, m in net.named_modules():
        if isinstance(m, nn.Conv2d):
            if net.global_residual and name == "conv_out":
                m.weight.zero_()
            else:
                fan_in = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return net


def reference_names(unet_size: int, global_residual: bool = False) -> list[tuple[str, str, str]]:
    """(the port's module, the reference's module, "conv" or "bn") for every
    layer: the layout of litbox_model.py's state_dict (conv_in.0,
    conv_in.2.primary.*, unet_encoders.*, bottleneck.*, unet_decoders.*.0,
    unet_skipconns.*.*, conv_out)."""
    out = [("conv_in.conv", "conv_in.0", "conv")]

    def resblock(dst, prefix, has_shortcut):
        out.extend([(f"{dst}.conv1.conv", f"{prefix}.primary.0", "conv"),
                    (f"{dst}.bn1", f"{prefix}.primary.1", "bn"),
                    (f"{dst}.conv2.conv", f"{prefix}.primary.3", "conv"),
                    (f"{dst}.bn2", f"{prefix}.primary.4", "bn")])
        if has_shortcut:
            out.append((f"{dst}.shortcut", f"{prefix}.shortcut", "conv"))

    resblock("res_in", "conv_in.2", False)
    for i in range(unet_size):
        resblock(f"enc{i}", f"unet_encoders.{i}", True)
    resblock("bott0", "bottleneck.0", True)
    resblock("bott1", "bottleneck.1", False)
    for i in range(unet_size):
        out.append((f"dec{i}.conv", f"unet_decoders.{i}.0", "conv"))
        resblock(f"skip{i}a", f"unet_skipconns.{i}.0", True)
        resblock(f"skip{i}b", f"unet_skipconns.{i}.1", False)
    out.append(("conv_out" if global_residual else "conv_out.conv", "conv_out", "conv"))
    return out


# The tensors of each kind of layer in both layouts.
LEAVES = {"conv": ("weight", "bias"),
          "bn": ("weight", "bias", "running_mean", "running_var")}


def import_torch_state(torch_state: dict, unet_size: int = 5) -> dict:
    """A litbox_model.py state_dict (the reference's `.pth`) -> the port's
    state_dict of the net without global_residual (CPU float32 tensors).
    Conv weights keep their (O, I, kh, kw) layout; num_batches_tracked is
    0, as the JAX package's import drops it."""
    state = {}
    for ours, ref, kind in reference_names(unet_size):
        for leaf in LEAVES[kind]:
            value = torch.as_tensor(torch_state[f"{ref}.{leaf}"], dtype=torch.float32)
            state[f"{ours}.{leaf}"] = value.detach().cpu().clone()
        if kind == "bn":
            state[f"{ours}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return state


@dataclasses.dataclass(frozen=True)
class TransformConfig:
    """pre/post transform flags (litbox_model.py:100-114, 257-266)."""

    use_log_space: bool = False
    normalize_input: bool = False
    epsilon: float = 1e-6


def _ln2(dtype: torch.dtype) -> float:
    """log(2) rounded to `dtype` (a host number, exact in that dtype)."""
    return float(torch.tensor(math.log(2.0), dtype=dtype))


def pre_transform(x: torch.Tensor, cfg: TransformConfig):
    """(B, H, W, C) -> (x, stats): optional log2 and per-image normalization,
    rounded where the JAX package's rounds, so that a bf16 input gives its
    bf16 result bit for bit: jnp.log2 is log(x) / log(2) in x's dtype (in
    bf16, log(2) itself is rounded, 0.2% low), and jnp.std the square root,
    in x's dtype, of a variance taken in float32."""
    stats = None
    if cfg.use_log_space:
        # A divisor on x's device: CUDA divides by a host scalar as a
        # product with its reciprocal, which rounds otherwise.
        x = torch.log(x + cfg.epsilon) / torch.full((), _ln2(x.dtype), dtype=x.dtype,
                                                    device=x.device)
    if cfg.normalize_input:
        mean = x.mean(dim=(1, 2), keepdim=True)
        std = x.float().var(dim=(1, 2), keepdim=True, correction=0).to(x.dtype).sqrt()
        x = (x - mean) / (std + cfg.epsilon)
        stats = (mean, std)
    return x, stats


def post_transform(x: torch.Tensor, stats, cfg: TransformConfig) -> torch.Tensor:
    if cfg.normalize_input and stats is not None:
        mean, std = stats
        x = x * (std + cfg.epsilon) + mean
    if cfg.use_log_space:
        # The exponent is clipped: 2^40 ~ 1e12 is beyond any radiance. 2^x
        # as jax.lax.exp2 lowers it, exp(x * log(2)) with log(2) in x's dtype.
        x = torch.exp(torch.clamp(x, -40.0, 40.0) * _ln2(x.dtype)) - cfg.epsilon
    return x
