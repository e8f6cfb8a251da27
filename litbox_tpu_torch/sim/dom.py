"""Deterministic multi-bounce cascade for RBT (counterpart of the JAX
package's sim/dom.py; reference bounce loop: SimulationCommon.cginc:387-456).

The Monte-Carlo bounce estimator flies Russian-roulette chains every frame
(sim/rbt.py::_bounce_chain_deposits). This module computes their
expectation directly on the rotated-bin representation instead. In medium
cells (no normal field) scatter_materially samples a uniform new direction
with unit energy, so the expected wave-(w+1) source density does not depend
on the bin:

    S_{w+1}[d', cell] = (1/D) * albedo(cell) * (1 - t(cell)) * F_w(cell)

with F_w the resolved flux of wave w. One wave is thus a scan (kernel K1),
a rotate-back of the interaction map (`rotate_back`, K2 and K3 on
channel-interleaved rows), a forward rotation of the (H, W, 3) world map
into each of the D bin frames (`_forward_rotate`, K2 three times) and a
one-cell shift along the new direction (the MC chain's push-off,
rbt.py's `_bounce_chain_deposits`). Zero variance and no per-photon work.

Scope: scenes whose interacting cells carry no normal or BRDF alignment
(the cloudy-medium class); surface branches depend on the direction and
stay on the MC path.
"""

from __future__ import annotations

import math

import torch

from ..core.types import GBuffer
from ..ops.resample import gather_bilinear
from ..ops.rotate import rotate_bins
from . import rbt
from .rbt import RotatedFields


def _forward_rotate(fields: RotatedFields, world: torch.Tensor,
                    height: int, width: int) -> torch.Tensor:
    """Embed an (H, W, 3) world-frame map into every bin frame (D, S, S, 3).

    The inverse of rotate_back's per-bin sampling: bin-frame cell p' samples
    the world map at p = R_d(p' - s/2) + c, zero outside the scene extent.

    When S is a multiple of 128 and both embedding offsets (S-H)/2, (S-W)/2
    are whole texels, this is `rotate_bins` (the 3-shear, K2) of the
    center-embedded map at angles +(d + phase)*2pi/D on every device, as the
    JAX version takes it on the TPU. Otherwise it is the masked bilinear
    gather of the JAX version's other branch."""
    s = fields.size
    d = fields.n_bins
    oy, ox = (s - height) // 2, (s - width) // 2
    if s % 128 == 0 and (s - height) % 2 == 0 and (s - width) % 2 == 0:
        emb = torch.zeros((s, s, 3), dtype=world.dtype, device=world.device)
        emb[oy:oy + height, ox:ox + width] = world
        angles = ((torch.arange(d, dtype=torch.float32, device=world.device)
                   + fields.phase) * (2.0 * math.pi / d))
        return rotate_bins(emb[None].expand(d, s, s, 3), angles)
    xs = torch.arange(s, dtype=torch.float32, device=world.device) + 0.5 - s / 2.0
    rx = xs[None, None, :]
    ry = xs[None, :, None]
    cos = fields.cos[:, None, None]
    sin = fields.sin[:, None, None]
    px = cos * rx - sin * ry + fields.center[0]
    py = sin * rx + cos * ry + fields.center[1]
    pts = torch.stack([px, py], dim=-1).reshape(-1, 2)
    # The gather fades to zero off the field; mask points outside the
    # extent so vacuum stays vacuum instead of smearing the border row.
    inside = ((pts[:, 0] >= 0) & (pts[:, 0] <= width)
              & (pts[:, 1] >= 0) & (pts[:, 1] <= height))
    vals = gather_bilinear(world, pts) * inside[:, None]
    return vals.reshape(d, s, s, 3)


def dom_bounce_sources(fields: RotatedFields, gbuffer: GBuffer,
                       src_direct: tuple, n_waves: int = 1) -> tuple:
    """Expected bounce sources for waves 1..n_waves given the wave-0 sources.

    Returns a 3-tuple of (D, S, S) sources to add to the direct sources
    before the resolve. Linear in src_direct, so it composes with temporal
    accumulation (dom(sum of frames) == sum of dom(frame))."""
    height, width = gbuffer.transmissibility.shape
    albedo = gbuffer.albedo[..., :3] / fields.n_bins
    trans = fields.trans
    sqrt_t = torch.sqrt(trans)

    src_w = src_direct
    out = tuple(torch.zeros_like(c) for c in src_direct)
    for _ in range(n_waves):
        # Interaction rate per rotated cell, exact per ray: the scan's O[x]
        # is the flux after extinction through x, so the interacting flux is
        # the incoming O[x-1] (a one-cell shift) times (1 - t), plus the
        # birth cell's own half-cell interaction src * (1 - sqrt(t)).
        deposited = rbt.attenuation_scan(fields, src_w)        # (D, S, S, 3)
        incoming = torch.zeros_like(deposited)
        incoming[:, :, 1:] = deposited[:, :, :-1]
        interact_rot = (incoming * (1.0 - trans)[..., None]
                        + torch.stack(src_w, dim=-1) * (1.0 - sqrt_t)[..., None])
        del deposited, incoming
        flux = rbt.rotate_back(fields, interact_rot, height, width, traced_phase=True)
        del interact_rot
        rotated = _forward_rotate(fields, flux * albedo, height, width)
        # One-cell push along the new direction (+x of the new bin frame):
        # the MC chain offsets its continuation by the new direction before
        # depositing, so the source cell is not re-extincted at once.
        src_w = []
        for ch in range(3):
            plane = torch.zeros(rotated.shape[:3], dtype=rotated.dtype,
                                device=rotated.device)
            plane[:, :, 1:] = rotated[:, :, :-1, ch]
            src_w.append(plane)
        del rotated
        src_w = tuple(src_w)
        out = tuple(o + w for o, w in zip(out, src_w))
    return out
