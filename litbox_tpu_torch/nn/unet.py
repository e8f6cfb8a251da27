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
across by name. BatchNorm always uses its running statistics (eps 1e-5, as
in Flax): the port runs the net for inference only.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

_PAD_MODES = {"reflect": "reflect", "zeros": "constant", "replicate": "replicate"}


class Conv3x3(nn.Module):
    """3x3 convolution after a one-texel pad of `padding_mode`."""

    def __init__(self, in_channels: int, features: int, padding_mode: str = "reflect"):
        super().__init__()
        self.pad_mode = _PAD_MODES[padding_mode]
        self.conv = nn.Conv2d(in_channels, features, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (1, 1, 1, 1), mode=self.pad_mode))


class ResidualBlock(nn.Module):
    """conv-BN-ReLU-conv-BN + shortcut, final ReLU (litbox_model.py:5-25)."""

    def __init__(self, in_channels: int, features: int, padding_mode: str = "reflect"):
        super().__init__()
        self.conv1 = Conv3x3(in_channels, features, padding_mode)
        self.bn1 = nn.BatchNorm2d(features, eps=1e-5)
        self.conv2 = Conv3x3(features, features, padding_mode)
        self.bn2 = nn.BatchNorm2d(features, eps=1e-5)
        self.shortcut = (nn.Conv2d(in_channels, features, 1)
                         if in_channels != features else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self.shortcut(x)
        y = F.relu(_bn_eval(self.bn1, self.conv1(x)))
        y = _bn_eval(self.bn2, self.conv2(y))
        return F.relu(y + shortcut)


def _bn_eval(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm with its running statistics, whatever the module's mode
    (Flax's use_running_average=True)."""
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                        training=False, eps=bn.eps)


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
        self.conv_out = (nn.Conv2d(c, out_channels, 3, padding=1) if global_residual
                         else Conv3x3(c, out_channels, "zeros"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, H, W, out_channels); H and W divisible by
        2^unet_size."""
        x = x.permute(0, 3, 1, 2)
        y = F.relu(self.conv_in(x))
        y = self.res_in(y)
        skips = []
        for i in range(self.unet_size):
            y = getattr(self, f"enc{i}")(y)
            skips.append(y)
            y = F.max_pool2d(y, 2)
        y = self.bott1(self.bott0(y))
        for i in range(self.unet_size):
            y = F.pixel_shuffle(getattr(self, f"dec{i}")(y), 2)
            y = torch.cat([y, skips[self.unet_size - 1 - i]], dim=1)
            y = getattr(self, f"skip{i}b")(getattr(self, f"skip{i}a")(y))
        y = self.conv_out(y)
        if self.global_residual:
            y = y + x
        if self.use_sigmoid:
            y = torch.sigmoid(y)
        return y.permute(0, 2, 3, 1)


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
