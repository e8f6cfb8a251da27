"""Photon emission for all light kinds (counterpart of the JAX package's
sim/emission.py; reference: ForwardMonteCarlo.compute:218-304 and the
per-light ray split of ForwardMonteCarlo.cs:174-206).

The whole frame's photons are one batch: each photon picks its light by a
deterministic proportional split, every emitter is evaluated for every
photon and the result is mask-selected. Random numbers come from an
explicit `torch.Generator` on the lights' device.
"""

from __future__ import annotations

import torch

from ..core.sampling import sample_bilinear_uv
from ..core.types import (LIGHT_AMBIENT, LIGHT_DIRECTIONAL, LIGHT_FIELD,
                          LIGHT_LASER, LIGHT_POINT, LIGHT_SPOT, affine_apply,
                          affine_linear, luminance)
from ..scene.scene import Lights
from .materials import TWO_PI, unit_from_angle


def take_per_light(table: torch.Tensor, l_idx: torch.Tensor) -> torch.Tensor:
    """table[l_idx] for a per-light table (a direct index; the JAX package
    writes it as a masked broadcast-sum because TPU gathers are slow)."""
    return table[l_idx.long()]


def effective_bounces(bounces: torch.Tensor, override) -> torch.Tensor:
    """Per-light (or per-photon) bounce counts with Simulation.photon_bounces
    folded in: an override >= 0 replaces every count; None keeps them (the
    JAX package's rbt._effective_bounces). A Python int override is resolved
    on the host, so no scalar is copied to the device."""
    if override is None:
        return bounces
    if isinstance(override, torch.Tensor):
        return torch.where(override >= 0, override.to(bounces.dtype), bounces)
    return bounces if override < 0 else torch.full_like(bounces, override)


def assign_photons_to_lights(lights: Lights, n_photons: int, interleave: int = 1):
    """Deterministic proportional split of the photon batch across lights.

    Returns (light_index (N,) int32, rays_per_light (L,) int64). Proportions
    follow luminance like ForwardMonteCarlo.Integrate (ForwardMonteCarlo.cs:174-186).

    interleave > 1 permutes the batch ranks so that the contiguous prefix of
    n/interleave photons is the every-interleave-th systematic subsample of
    the canonical order (rank arithmetic, as in the JAX package).
    """
    dev = lights.energy.device
    w = luminance(lights.energy) * lights.active.float()
    cum = torch.cumsum(w, 0)
    total = cum[-1]
    rank = torch.arange(n_photons, dtype=torch.int32, device=dev)
    if interleave > 1:
        keep = n_photons // interleave
        body = keep * interleave
        perm = (rank % keep) * interleave + rank // keep
        rank = torch.where(rank < body, perm, rank)
    t = (rank.float() + 0.5) / n_photons * total
    l_idx = torch.searchsorted(cum, t, right=True).to(torch.int32)
    l_idx = torch.clamp(l_idx, max=lights.capacity - 1)
    # scatter_add_ into a known size: bincount would read the maximum back
    # to the host and stall the stream.
    rays_per_light = torch.zeros(lights.capacity, dtype=torch.long, device=dev)
    rays_per_light.scatter_add_(0, l_idx.long(), torch.ones_like(l_idx, dtype=torch.long))
    return l_idx, rays_per_light


def _normalized(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def emit(lights: Lights, field_textures: torch.Tensor, l_idx: torch.Tensor,
         rays_per_light: torch.Tensor, generator: torch.Generator,
         target_size: tuple[int, int], interval: float, override_bounces,
         active_kinds: tuple | None = None) -> tuple[torch.Tensor, ...]:
    """Emit one photon per batch lane.

    Returns (origin (N,2), direction (N,2), energy (N,3), bounces (N,)).
    Energy folds in the reference's normalization chain: per-photon energy
    (W*H)/rays times 1/interval (ForwardMonteCarlo.cs:210,242-245) and the
    emitter's pdf factor. active_kinds restricts which emitters are
    computed; the others are not selected.
    """
    r = torch.rand((l_idx.shape[0], 5), generator=generator, device=l_idx.device)
    return _emit_from_uniforms(lights, field_textures, l_idx, rays_per_light, r,
                               target_size, interval, override_bounces,
                               active_kinds)


def _emit_from_uniforms(lights: Lights, field_textures: torch.Tensor,
                        l_idx: torch.Tensor, rays_per_light: torch.Tensor,
                        r: torch.Tensor, target_size: tuple[int, int],
                        interval: float, override_bounces,
                        active_kinds: tuple | None = None) -> tuple[torch.Tensor, ...]:
    """`emit` with its (N, 5) uniforms `r` given."""
    n = l_idx.shape[0]
    dev = l_idx.device
    height, width = target_size
    size_x, size_y = float(width), float(height)

    def want(k):
        return active_kinds is None or k in active_kinds

    kind = take_per_light(lights.kind, l_idx)
    aff = take_per_light(lights.affine, l_idx)
    zeros = torch.zeros((n,), device=dev)
    down = torch.stack([zeros, -torch.ones((n,), device=dev)], -1)  # local -y

    # --- Point (ForwardMonteCarlo.compute:218-231) ---
    disk = unit_from_angle(r[:, 0] * TWO_PI) * torch.sqrt(r[:, 1])[:, None]
    point_origin = affine_apply(aff, disk)
    point_dir = unit_from_angle(r[:, 2] * TWO_PI)

    # --- Spot (:233-241): box origin, cone within +-45 deg of local -y ---
    spot_origin = affine_apply(aff, torch.stack([r[:, 0] - 0.5, r[:, 1] - 0.5], -1))
    spot_dir = _normalized(affine_linear(aff, torch.stack([2 * r[:, 2] - 1, down[:, 1]], -1)))

    # --- Laser (:243-251): line origin, collimated local -y ---
    laser_origin = affine_apply(aff, torch.stack([r[:, 0] - 0.5, r[:, 1]], -1))
    laser_dir = _normalized(affine_linear(aff, down))

    # --- Ambient (:253-262): frame-wide origins, inward-biased directions ---
    n_origin = r[:, 0:2]
    ambient_origin = torch.stack([n_origin[:, 0] * size_x, n_origin[:, 1] * size_y], -1)
    ambient_dir = _normalized(unit_from_angle(r[:, 2] * TWO_PI) - (n_origin * 2 - 1) / 1.44)

    # --- Field (:264-280): texture-modulated area light ---
    field_uv = r[:, 0:2]
    field_origin = affine_apply(aff, field_uv * 2 - 1)
    field_energy_mod = None
    if want(LIGHT_FIELD):
        # Per-photon texture selection through a vertical atlas: tiles stack
        # along v and each photon's v is offset by its tile index (clamped
        # half a texel inside the tile so tiles do not bleed).
        n_tiles, fh = field_textures.shape[0], field_textures.shape[1]
        atlas = field_textures.reshape((n_tiles * fh,) + tuple(field_textures.shape[2:]))
        half_v = 0.5 / fh
        tile = take_per_light(lights.tex_index, l_idx).float()
        atlas_uv = torch.stack(
            [field_uv[:, 0],
             (tile + torch.clamp(field_uv[:, 1], half_v, 1.0 - half_v)) / n_tiles], -1)
        tex = sample_bilinear_uv(atlas, atlas_uv)
        field_energy_mod = tex[:, :3] * torch.clamp(tex[:, 3:4] - 0.08, min=0.0)

    # --- Directional (:282-294): parallel rays entering the frame ---
    dl = _normalized(affine_linear(aff, down))
    dperp = torch.stack([dl[:, 1], -dl[:, 0]], -1)
    offset = 0.5 - dl + dperp * (r[:, 0] * 1.415 - 0.7075)[:, None]
    dir_origin = torch.stack([offset[:, 0] * size_x, offset[:, 1] * size_y], -1)
    dir_miss = None
    if want(LIGHT_DIRECTIONAL):
        # The raw segment sits a full frame outside the target; advance each
        # origin to its frame-entry point (outside is vacuum, so entering
        # unattenuated at the boundary is exact). Rays that miss the frame
        # carry zero energy.
        safe = torch.where(dl.abs() < 1e-9,
                           torch.where(dl < 0, -1e-9, 1e-9), dl)
        ta = -dir_origin / safe
        size = torch.stack([torch.full_like(zeros, size_x),
                            torch.full_like(zeros, size_y)], -1)
        tb = (size - dir_origin) / safe
        t_enter = torch.minimum(ta, tb).amax(-1)
        t_exit = torch.maximum(ta, tb).amin(-1)
        dir_miss = t_exit <= torch.clamp(t_enter, min=0.0)
        dir_origin = dir_origin + dl * torch.clamp(t_enter + 1e-3, min=0.0)[:, None]

    # --- Default (:296-304) ---
    def_origin = torch.stack([r[:, 0] * size_x, zeros], -1)
    def_dir = torch.stack([zeros, zeros + 1.0], -1)

    def sel(options: dict, default: torch.Tensor) -> torch.Tensor:
        out = default
        for k, v in options.items():
            if want(k):
                out = torch.where((kind == k)[:, None], v, out)
        return out

    origin = sel({LIGHT_POINT: point_origin, LIGHT_SPOT: spot_origin,
                  LIGHT_LASER: laser_origin, LIGHT_AMBIENT: ambient_origin,
                  LIGHT_FIELD: field_origin, LIGHT_DIRECTIONAL: dir_origin}, def_origin)
    direction = sel({LIGHT_POINT: point_dir, LIGHT_SPOT: spot_dir,
                     LIGHT_LASER: laser_dir, LIGHT_AMBIENT: ambient_dir,
                     LIGHT_FIELD: point_dir, LIGHT_DIRECTIONAL: dl}, def_dir)

    rays = torch.clamp(take_per_light(rays_per_light, l_idx).float(), min=1.0)
    energy = (take_per_light(lights.energy, l_idx)
              * (float(width * height) / interval) / rays[:, None])
    energy = energy * torch.where((kind == LIGHT_POINT)[:, None], 1.0 / TWO_PI, 1.0)
    if field_energy_mod is not None:
        energy = energy * torch.where((kind == LIGHT_FIELD)[:, None],
                                      field_energy_mod, 1.0)
    if dir_miss is not None:
        energy = torch.where(((kind == LIGHT_DIRECTIONAL) & dir_miss)[:, None],
                             0.0, energy)

    bounces = effective_bounces(take_per_light(lights.bounces, l_idx), override_bounces)
    return origin, direction, energy, bounces


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
