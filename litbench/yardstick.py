"""The benchmark's yardstick: the card's published peak and the operations
the measured work needs, computed from shapes.

Peak of one NVIDIA H100 SXM (NVIDIA's data sheet, at the 700 W power
limit): 67 TFLOP/s in float32 outside the tensor cores.
"""

from __future__ import annotations

import torch

from litbench.reference import unet

FP32_FLOP_PER_S = 67e12


def unet_flop(arch: dict, batch: int, height: int, width: int) -> int:
    """Convolution FLOPs (2 per multiply-add) of one forward pass of the UNet
    of `arch` on (batch, height, width, channels), counted from the layers'
    output shapes on the meta device (chip_smoke.py's `unet_flop`, on the
    reference's layers)."""
    flop = [0]

    def counting(x, w, b, padding=0):
        y = unet.conv2d(x, w, b, padding)
        flop[0] += 2 * y.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        return y

    params = {k: torch.empty(s, device="meta") for k, s, _ in unet.layout(**arch)}
    c = arch.get("out_channels", 1)
    unet.Net(arch, conv=counting)(params, torch.empty((batch, height, width, c), device="meta"))
    return flop[0]

