"""The denoiser UNet written out in plain PyTorch (litbox_model.py:27-302 as
the port's nn/unet.py describes it): parameters in a dict under the port's
state_dict names, NHWC at the boundary, BatchNorm as Flax computes it.

    conv_in: 3x3 conv -> ReLU -> ResidualBlock
    encoders: unet_size x [ResBlock(C->2C), MaxPool2]
    bottleneck: ResBlock(C->2C), ResBlock(2C->2C)
    decoders: unet_size x [3x3 conv (zero pad) C->4*(C/2), PixelShuffle(2),
              concat skip, 2x ResBlock]
    conv_out: 3x3 conv (zero pad) -> out_channels (+ input under global_residual)
    ResBlock: conv-BN-ReLU-conv-BN + 1x1 shortcut (when widths differ), ReLU

`conv` is a parameter so that the FLOP count (litbench/yardstick.py) runs
the same layers.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

PAD = {"reflect": "reflect", "zeros": "constant", "replicate": "replicate"}
BN_EPS = 1e-5


def layout(unet_size: int = 5, initial_features: int = 32, out_channels: int = 1,
           global_residual: bool = False, **_) -> list[tuple[str, tuple, str]]:
    """(state_dict key, shape, kind) of every tensor, kind in conv_weight,
    conv_bias, bn_weight, bn_bias, bn_mean, bn_var, bn_count."""
    out: list[tuple[str, tuple, str]] = []

    def conv(name, cin, cout, k):
        out.append((f"{name}.weight", (cout, cin, k, k), "conv_weight"))
        out.append((f"{name}.bias", (cout,), "conv_bias"))

    def bn(name, c):
        out.extend([(f"{name}.weight", (c,), "bn_weight"), (f"{name}.bias", (c,), "bn_bias"),
                    (f"{name}.running_mean", (c,), "bn_mean"),
                    (f"{name}.running_var", (c,), "bn_var"),
                    (f"{name}.num_batches_tracked", (), "bn_count")])

    def res(name, cin, cout):
        conv(f"{name}.conv1.conv", cin, cout, 3)
        bn(f"{name}.bn1", cout)
        conv(f"{name}.conv2.conv", cout, cout, 3)
        bn(f"{name}.bn2", cout)
        if cin != cout:
            conv(f"{name}.shortcut", cin, cout, 1)

    f = initial_features
    conv("conv_in.conv", out_channels, f, 3)
    res("res_in", f, f)
    c = f
    for i in range(unet_size):
        res(f"enc{i}", c, 2 * c)
        c *= 2
    res("bott0", c, 2 * c)
    res("bott1", 2 * c, 2 * c)
    c *= 2
    for i in range(unet_size):
        conv(f"dec{i}.conv", c, (c // 2) * 4, 3)
        c //= 2
        res(f"skip{i}a", 2 * c, c)
        res(f"skip{i}b", c, c)
    conv("conv_out" if global_residual else "conv_out.conv", c, out_channels, 3)
    return out


def draw(arch: dict, generator: torch.Generator, device) -> dict:
    """Weights for `arch` drawn from `generator` on `device` in two calls:
    conv kernels normal with variance 1/fan_in (conv_out's scaled by 0.1, so
    that the residual net's output stays near its input, as a trained one
    does), biases and BatchNorm's shift, scale and running statistics
    spread by 0.1 around 0 or 1."""
    items = layout(**arch)
    sizes = [math.prod(s) for _, s, _ in items]
    z = torch.randn(sum(sizes), generator=generator, device=device)
    out, at = {}, 0
    for (key, shape, kind), n in zip(items, sizes):
        v = z[at:at + n].reshape(shape)
        at += n
        if kind == "conv_weight":
            v = v / math.sqrt(math.prod(shape[1:]))
            if key.startswith("conv_out"):
                v = v * 0.1
        elif kind in ("conv_bias", "bn_bias", "bn_mean"):
            v = v * 0.1
        elif kind == "bn_weight":
            v = 1.0 + 0.1 * v
        elif kind == "bn_var":
            v = 1.0 + 0.1 * v.abs()
        elif kind == "bn_count":
            out[key] = torch.zeros((), dtype=torch.long, device=device)
            continue
        out[key] = v.contiguous()
    return out


def conv2d(x, w, b, padding=0):
    return F.conv2d(x, w, b, padding=padding)


class Net:
    """The forward pass over a parameter dict `p`. In training mode BatchNorm
    takes the batch's biased moments, E[x^2] - E[x]^2 clipped at 0, as Flax
    does (the running statistics are not moved: nothing here reads them)."""

    def __init__(self, arch: dict, conv: Callable = conv2d):
        self.size = arch.get("unet_size", 5)
        self.pad = PAD[arch.get("padding_mode", "reflect")]
        self.global_residual = arch.get("global_residual", False)
        self.use_sigmoid = arch.get("use_sigmoid", False)
        self.conv = conv

    def _conv3(self, p, name, x, mode):
        x = F.pad(x, (1, 1, 1, 1), mode=mode)
        return self.conv(x, p[name + ".weight"], p[name + ".bias"])

    def _bn(self, p, name, x, train):
        w, b = p[name + ".weight"], p[name + ".bias"]
        if train:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        else:
            mean, var = p[name + ".running_mean"], p[name + ".running_var"]
        scale = w / torch.sqrt(var + BN_EPS)
        return (x - mean[:, None, None]) * scale[:, None, None] + b[:, None, None]

    def _res(self, p, name, x, train):
        if name + ".shortcut.weight" in p:
            short = self.conv(x, p[name + ".shortcut.weight"], p[name + ".shortcut.bias"])
        else:
            short = x
        y = F.relu(self._bn(p, name + ".bn1", self._conv3(p, name + ".conv1.conv", x, self.pad),
                            train))
        y = self._bn(p, name + ".bn2", self._conv3(p, name + ".conv2.conv", y, self.pad), train)
        return F.relu(y + short)

    def __call__(self, p: dict, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, H, W, C) -> (B, H, W, C); H and W divisible by 2^unet_size."""
        x = x.permute(0, 3, 1, 2)
        y = F.relu(self._conv3(p, "conv_in.conv", x, self.pad))
        y = self._res(p, "res_in", y, train)
        skips = []
        for i in range(self.size):
            y = self._res(p, f"enc{i}", y, train)
            skips.append(y)
            y = F.max_pool2d(y, 2)
        y = self._res(p, "bott1", self._res(p, "bott0", y, train), train)
        for i in range(self.size):
            y = F.pixel_shuffle(self._conv3(p, f"dec{i}.conv", y, "constant"), 2)
            y = torch.cat([y, skips[self.size - 1 - i]], dim=1)
            y = self._res(p, f"skip{i}a", y, train)
            y = self._res(p, f"skip{i}b", y, train)
        if self.global_residual:
            y = self.conv(y, p["conv_out.weight"], p["conv_out.bias"], padding=1) + x
        else:
            y = self._conv3(p, "conv_out.conv", y, "constant")
        if self.use_sigmoid:
            y = torch.sigmoid(y)
        return y.permute(0, 2, 3, 1)

