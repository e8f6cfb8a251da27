"""Point-light photon emission (counterpart of the JAX package's
sim/emission.py; reference: ForwardMonteCarlo.compute:218-231 and the
per-light ray split of ForwardMonteCarlo.cs:174-206).

Random numbers come from an explicit `torch.Generator` on the lights' device.
"""

from __future__ import annotations

import torch

from ..core.types import affine_apply, luminance
from ..scene.scene import Lights
from .materials import TWO_PI, unit_from_angle


def take_per_light(table: torch.Tensor, l_idx: torch.Tensor) -> torch.Tensor:
    """table[l_idx] for a per-light table (a direct index; the JAX package
    writes it as a masked broadcast-sum because TPU gathers are slow)."""
    return table[l_idx.long()]


def effective_bounces(bounces: torch.Tensor, override) -> torch.Tensor:
    """Per-light (or per-photon) bounce counts with Simulation.photon_bounces
    folded in: an override >= 0 replaces every count. A Python int override
    is resolved on the host, so no scalar is copied to the device."""
    if isinstance(override, torch.Tensor):
        return torch.where(override >= 0, override.to(bounces.dtype), bounces)
    return bounces if override < 0 else torch.full_like(bounces, override)


def assign_photons_to_lights(lights: Lights, n_photons: int):
    """Deterministic proportional split of the photon batch across lights.

    Returns (light_index (N,) int32, rays_per_light (L,) int64). Proportions
    follow luminance like ForwardMonteCarlo.Integrate (ForwardMonteCarlo.cs:174-186).
    """
    dev = lights.energy.device
    w = luminance(lights.energy) * lights.active.float()
    cum = torch.cumsum(w, 0)
    total = cum[-1]
    rank = torch.arange(n_photons, dtype=torch.int32, device=dev)
    t = (rank.float() + 0.5) / n_photons * total
    l_idx = torch.searchsorted(cum, t, right=True).to(torch.int32)
    l_idx = torch.clamp(l_idx, max=lights.capacity - 1)
    # scatter_add_ into a known size: bincount would read the maximum back
    # to the host and stall the stream.
    rays_per_light = torch.zeros(lights.capacity, dtype=torch.long, device=dev)
    rays_per_light.scatter_add_(0, l_idx.long(), torch.ones_like(l_idx, dtype=torch.long))
    return l_idx, rays_per_light


def emit_point_stratified(lights: Lights, l_of_slot: torch.Tensor,
                          slots_per_light: torch.Tensor, n_bins: int,
                          phase: torch.Tensor, generator: torch.Generator,
                          target_size: tuple[int, int], interval: float,
                          override_bounces) -> tuple[torch.Tensor, ...]:
    """Emit point-light photons in a direction-stratified (D, cap) layout.

    Slot j of every bin d belongs to light l_of_slot[j]; the photon's
    direction is uniform within bin d's angular cone (theta in
    ((d - 1/2 + phase) * 2pi/D, (d + 1/2 + phase) * 2pi/D)), so its
    quantized transport bin is d by construction. Positions are iid disk
    samples.

    Returns (pos (D, cap, 2), direction (D, cap, 2), energy (D, cap, 3),
    bounces (D, cap)). Light l's total ray count is slots_per_light[l] * D.
    """
    cap = l_of_slot.shape[0]
    dev = l_of_slot.device
    height, width = target_size
    aff = take_per_light(lights.affine, l_of_slot)            # (cap, 2, 3)
    e_l = take_per_light(lights.energy, l_of_slot)            # (cap, 3)
    b_l = take_per_light(lights.bounces, l_of_slot)           # (cap,)
    act = take_per_light(lights.active.float(), l_of_slot)
    rays = torch.clamp(take_per_light(slots_per_light, l_of_slot) * n_bins,
                       min=1).float()

    u = torch.rand((n_bins, cap, 3), generator=generator, device=dev)
    disk = unit_from_angle(u[..., 0] * TWO_PI) * torch.sqrt(u[..., 1])[..., None]
    pos = affine_apply(aff[None], disk)                       # (D, cap, 2)

    bin_width = TWO_PI / n_bins
    d_idx = torch.arange(n_bins, dtype=torch.float32, device=dev)[:, None]
    theta = (d_idx + phase + u[..., 2] - 0.5) * bin_width
    direction = unit_from_angle(theta)

    energy = (e_l[None] * (float(width * height) / interval)
              / (rays[:, None] * TWO_PI) * act[:, None])
    energy = energy.expand(n_bins, cap, 3)
    bounces = effective_bounces(b_l, override_bounces).expand(n_bins, cap)
    return pos, direction, energy, bounces
