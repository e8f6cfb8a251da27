"""KPCN, the kernel-predicting Monte Carlo denoiser (Bako, Vogels,
McWilliams, Meyer, Novak, Harvill, Sen, DeRose, Rousselle: "Kernel-Predicting
Convolutional Networks for Denoising Monte Carlo Renderings", ACM TOG 36(4),
article 97, SIGGRAPH 2017), on litbox's buffers.

The net is the paper's trunk: `layers` convolutions of `kernel` x `kernel`
taps with "same" zero padding, `features` channels and a ReLU after each but
the last, which emits recon^2 logits a pixel. The reconstruction
(`ops.kpn.kernel_apply`) weights the recon x recon window of the colour
around each pixel by the softmax of its logits. Its convolutions are
`StepConv2d`s, so inside a training step on a card they run the port's
convolution kernels (ops/conv.py), as the UNet's do.

Litbox has no G-buffer normals or depth and no diffuse/specular split, so
the input is litbox's own 22 channels (`features`), built on the device
from the pair of independent tracers A and B, the albedo and the
transmissibility, with x = (A + B) / 2:
  0-2    colour, log1p(x) (the paper's specular transform; the kernel is
         applied to it and the loss compares in this domain)
  3      variance, the mean over RGB of ((A - B) / 2)^2 / (1 + x)^2: the
         variance of the pair's mean carried into the log1p domain
  4-6    albedo
  7      transmissibility
  8-14   forward differences along x of channels 0-2, 4-6 and 7, 0 at the
         last column
  15-21  the same along y, 0 at the last row
The JAX package has no KPCN: this module has no counterpart there.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from .unet import StepConv2d

IN_CHANNELS = 22


@dataclasses.dataclass(frozen=True)
class KpcnConfig:
    """The net's sizes, as the paper publishes them."""

    layers: int = 9
    features: int = 100
    kernel: int = 5
    recon: int = 21


def widths(cfg: KpcnConfig) -> list[int]:
    """The channels into each convolution, then out of the last."""
    return [IN_CHANNELS] + [cfg.features] * (cfg.layers - 1) + [cfg.recon * cfg.recon]


class KPCN(nn.Module):
    """The trunk: features (N, 22, H, W) -> logits (N, recon^2, H, W)."""

    def __init__(self, cfg: KpcnConfig = KpcnConfig()):
        super().__init__()
        if cfg.layers < 2 or cfg.kernel % 2 == 0 or cfg.recon % 2 == 0:
            raise ValueError(f"KPCN takes 2 or more layers and odd kernels, got {cfg}")
        self.cfg = cfg
        c = widths(cfg)
        self.convs = nn.ModuleList(StepConv2d(i, o, cfg.kernel, padding=cfg.kernel // 2)
                                   for i, o in zip(c, c[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.convs) - 1
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if i < last:
                x = F.relu(x)
        return x


@torch.no_grad()
def init_weights(net: KPCN, generator: torch.Generator) -> KPCN:
    """Glorot-uniform weights (bound sqrt(6 / (fan_in + fan_out)), each fan
    the channels times the taps) and zero biases, in place, drawn from
    `generator`, which must lie on the weights' device."""
    for conv in net.convs:
        cout, cin, kh, kw = conv.weight.shape
        bound = math.sqrt(6.0 / ((cin + cout) * kh * kw))
        conv.weight.uniform_(-bound, bound, generator=generator)
        conv.bias.zero_()
    return net


def features(a: torch.Tensor, b: torch.Tensor, albedo: torch.Tensor,
             trans: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(features (N, 22, H, W), colour (N, 3, H, W)), contiguous NCHW, from
    the (N, H, W, C) tracers A and B, albedo (C = 3) and transmissibility
    (C = 1); the channels as the module's docstring lists them."""
    a, b, albedo, trans = (t.permute(0, 3, 1, 2) for t in (a, b, albedo, trans))
    x = (a + b) * 0.5
    colour = torch.log1p(x)
    half = (a - b) * 0.5
    variance = (half.square() / (1.0 + x).square()).mean(1, keepdim=True)
    base = torch.cat([colour, albedo, trans], 1)
    dx = F.pad(base[..., 1:] - base[..., :-1], (0, 1))
    dy = F.pad(base[..., 1:, :] - base[..., :-1, :], (0, 0, 0, 1))
    feats = torch.cat([colour, variance, albedo, trans, dx, dy], 1).contiguous()
    return feats, colour.contiguous()


def conv_shapes(batch: int, height: int, width: int, cfg: KpcnConfig = KpcnConfig()) -> list:
    """Each distinct convolution of the trunk on (batch, height, width), as
    nn.unet.conv_shapes lists them: (N, Cin, Cout, H, W, k, padding)."""
    c = widths(cfg)
    shapes = []
    for cin, cout in zip(c, c[1:]):
        shape = (batch, cin, cout, height, width, cfg.kernel, cfg.kernel // 2)
        if shape not in shapes:
            shapes.append(shape)
    return shapes
