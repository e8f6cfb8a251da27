"""The kpcn-21-train cell's yardstick: the operations of KPCN's
convolutions and the bytes of its reconstruction, computed from the
configuration's shapes (configs/kpcn-21.json keys), and the card's
published device-memory rate.

Peak of one NVIDIA H100 SXM (NVIDIA's data sheet, at the 700 W power
limit): 3.35 TB/s of device memory; the float32 peak is yardstick.py's.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12

FLOAT = 4
COLOUR = 3


def _widths(cfg: dict) -> list[int]:
    return ([cfg["in_channels"]] + [cfg["features"]] * (cfg["layers"] - 1)
            + [cfg["recon_kernel"] ** 2])


def conv_flop(cfg: dict, batch: int, height: int, width: int) -> list[int]:
    """FLOPs (2 a multiply-add) of each convolution's forward on (batch,
    height, width) at "same" padding, first layer first."""
    c, taps = _widths(cfg), cfg["kernel_size"] ** 2
    return [2 * batch * height * width * cout * cin * taps for cin, cout in zip(c, c[1:])]


def step_flop(cfg: dict, batch: int, height: int, width: int) -> int:
    """The step's convolution FLOPs as train_mfu counts a step: 3 x the
    forward's (forward, data gradient, weight gradient)."""
    return 3 * sum(conv_flop(cfg, batch, height, width))


def launched_flop(cfg: dict, batch: int, height: int, width: int) -> int:
    """The FLOPs the convolution kernels launch in a step: 3 x the forward's
    less the first layer's data gradient, which the step never asks for
    (its input, the features, is data)."""
    per = conv_flop(cfg, batch, height, width)
    return 3 * sum(per) - per[0]


def kpn_bytes(cfg: dict, batch: int, height: int, width: int) -> int:
    """The reconstruction's bytes in a step, each tensor once a direction:
    the forward reads the logits and the colour and writes the output and
    each pixel's log-sum-exp; the backward reads the logits, the colour,
    the log-sum-exp, the output and its gradient, and writes the logits'
    gradient."""
    pixels = batch * height * width
    logits = pixels * cfg["recon_kernel"] ** 2 * FLOAT
    colour = pixels * COLOUR * FLOAT
    lse = pixels * FLOAT
    forward = logits + colour + colour + lse
    backward = logits + colour + lse + colour + colour + logits
    return forward + backward
