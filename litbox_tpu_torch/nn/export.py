"""Portable denoiser export (counterpart of the JAX package's nn/export.py).

The functions take the port's state_dict of `nn.unet.LitboxDenoiserNet`
(as `Trainer.model.state_dict()` or `convert.unet_from_flax` give it):

  * export_torch_state / save_torch_checkpoint: the reference's layout
    (litbox_model.py's module tree), the inverse of unet.import_torch_state;
  * build_torch_module / export_torchscript: the reference's module tree in
    torch (the mono architecture), loaded with those weights, and a traced
    TorchScript file of it;
  * export_onnx: the ONNX protobuf written by nn.onnx_writer; no `onnx`
    package is needed, and the file equals the JAX package's byte for byte
    for the same weights.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .unet import LEAVES, reference_names


def export_torch_state(state: dict, unet_size: int = 5,
                       global_residual: bool = False) -> dict:
    """The port's state_dict -> the reference-layout state_dict (float32
    numpy arrays, num_batches_tracked an int64 0, as the JAX package's
    export gives them; pass through torch.save for a .pth)."""
    out: dict = {}
    for ours, ref, kind in reference_names(unet_size, global_residual):
        for leaf in LEAVES[kind]:
            out[f"{ref}.{leaf}"] = state[f"{ours}.{leaf}"].detach().cpu().float().numpy()
        if kind == "bn":
            out[f"{ref}.num_batches_tracked"] = np.asarray(0, np.int64)
    return out


def _torch_mirror(unet_size: int, initial_features: int,
                  padding_mode: str = "reflect", use_sigmoid: bool = False) -> nn.Module:
    """The reference's mono UNet (litbox_model.py's module names) in torch."""

    def conv3(ci, co, pm):
        return nn.Conv2d(ci, co, 3, padding=1, padding_mode=pm)

    class ResBlock(nn.Module):
        def __init__(self, ci, co, pm):
            super().__init__()
            self.primary = nn.Sequential(
                conv3(ci, co, pm), nn.BatchNorm2d(co), nn.ReLU(),
                conv3(co, co, pm), nn.BatchNorm2d(co))
            self.shortcut = nn.Conv2d(ci, co, 1) if ci != co else nn.Identity()

        def forward(self, x):
            return torch.relu(self.primary(x) + self.shortcut(x))

    class Mirror(nn.Module):
        def __init__(self):
            super().__init__()
            f = initial_features
            pm = padding_mode
            self.conv_in = nn.Sequential(conv3(1, f, pm), nn.ReLU(),
                                         ResBlock(f, f, pm))
            encs, c = [], f
            for _ in range(unet_size):
                encs.append(ResBlock(c, c * 2, pm))
                c *= 2
            self.unet_encoders = nn.ModuleList(encs)
            self.bottleneck = nn.Sequential(ResBlock(c, c * 2, pm),
                                            ResBlock(c * 2, c * 2, pm))
            c *= 2
            decs, skips = [], []
            for _ in range(unet_size):
                c //= 2
                decs.append(nn.Sequential(nn.Conv2d(c * 2, c * 4, 3, padding=1),
                                          nn.PixelShuffle(2)))
                skips.append(nn.Sequential(ResBlock(c * 2, c, pm),
                                           ResBlock(c, c, pm)))
            self.unet_decoders = nn.ModuleList(decs)
            self.unet_skipconns = nn.ModuleList(skips)
            self.conv_out = nn.Conv2d(f * 2, 1, 3, padding=1)
            self.pool = nn.MaxPool2d(2)
            self.use_sigmoid = use_sigmoid

        def forward(self, x):
            y = self.conv_in(x)
            skips = []
            for enc in self.unet_encoders:
                y = enc(y)
                skips.append(y)
                y = self.pool(y)
            y = self.bottleneck(y)
            for i, (dec, skip) in enumerate(zip(self.unet_decoders,
                                                self.unet_skipconns)):
                y = dec(y)
                y = torch.cat([y, skips[len(skips) - 1 - i]], dim=1)
                y = skip(y)
            y = self.conv_out(y)
            return torch.sigmoid(y) if self.use_sigmoid else y

    return Mirror()


def _torch_state(state: dict, unet_size: int) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in export_torch_state(state, unet_size).items()}


def build_torch_module(state: dict, unet_size: int = 5, initial_features: int = 32,
                       padding_mode: str = "reflect", use_sigmoid: bool = False) -> nn.Module:
    """The reference's module tree (NCHW, mono) with the port's weights, in
    eval mode on the CPU."""
    net = _torch_mirror(unet_size, initial_features, padding_mode, use_sigmoid)
    net.load_state_dict(_torch_state(state, unet_size))
    net.eval()
    return net


def save_torch_checkpoint(state: dict, path: str, unet_size: int = 5):
    """Reference-compatible .pth (plain state_dict, litbox_model.py layout)."""
    torch.save(_torch_state(state, unet_size), path)


def export_torchscript(state: dict, path: str, unet_size: int = 5,
                       initial_features: int = 32, padding_mode: str = "reflect",
                       example_size: int = 64):
    """Traced TorchScript module of build_torch_module."""
    net = build_torch_module(state, unet_size, initial_features, padding_mode)
    example = torch.zeros(1, 1, example_size, example_size)
    with torch.no_grad():
        traced = torch.jit.trace(net, example)
    traced.save(path)
    return path


def export_onnx(state: dict, path: str, unet_size: int = 5,
                initial_features: int = 32, padding_mode: str = "reflect",
                use_sigmoid: bool = False, global_residual: bool = False):
    """ONNX file of the net (reference: train_litbox_denoiser.py:276-281),
    emitted by nn.onnx_writer at opset 13, NCHW with symbolic batch, height
    and width."""
    del initial_features  # implied by the weight shapes
    from .onnx_writer import write_onnx_unet

    ref = export_torch_state(state, unet_size, global_residual=global_residual)
    in_channels = ref["conv_in.0.weight"].shape[1]
    return write_onnx_unet(ref, path, unet_size=unet_size,
                           padding_mode=padding_mode, use_sigmoid=use_sigmoid,
                           in_channels=in_channels,
                           global_residual=global_residual)
