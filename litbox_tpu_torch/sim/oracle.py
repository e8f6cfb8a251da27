"""Oracle forward tracer: the reference estimator as a masked lock-step march
(counterpart of the JAX package's sim/oracle.py).

The reference's per-thread photon program (`Integrate`,
SimulationCommon.cginc:387-456, with the ForwardMonteCarlo method,
ForwardMonteCarlo.compute:107-216). Each bounce is two traversals over the
transmissibility field:
  SEARCH  - march texel steps to the frame edge, multiplying cumulative
            transmissibility and recording stratified in-scatter samples
            (weight E * interval^2 * T_cum) every `interval` texels.
  RESOLVE - sample a transmit potential tp ~ U[T_total, 1]
            (ForwardMonteCarlo.compute:209-214), re-march to the first texel
            where T_cum * T_next < tp, solve the fractional crossing, and
            scatter materially there.

GPU thread divergence becomes masked fixed-trip steps: the JAX version's
`lax.scan` over `max_steps` is a Python loop here, each step a few
elementwise launches over the photon batch. The recorded deposit stream is
splatted once per wave (ops/scatter.py). This tracer is the semantic ground
truth that RBT is validated against; it is plain PyTorch (no Pallas kernel
lies under the JAX version either). Random numbers come from an explicit
`torch.Generator` on the GBuffer's device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.sampling import sample_bilinear_uv, sample_nearest_uv
from ..core.types import GBuffer
from ..ops.scatter import scatter_add_bilinear_mxu, scatter_add_nearest_mxu
from .emission import assign_photons_to_lights, emit
from .materials import scatter_materially


class PhotonState(NamedTuple):
    origin: torch.Tensor     # (N, 2) texel coords
    direction: torch.Tensor  # (N, 2) unit
    energy: torch.Tensor     # (N, 3)
    bounces: torch.Tensor    # (N,) per-photon budget
    dead: torch.Tensor       # (N,) bool


def _escape_distance(origin_uv: torch.Tensor, dir_uv: torch.Tensor,
                     pixel: torch.Tensor) -> torch.Tensor:
    """Slab test against the frame box padded by one texel
    (SimulationCommon.cginc:400-404); result in texel units."""
    lo = (-pixel - origin_uv) / dir_uv
    hi = (1.0 + pixel - origin_uv) / dir_uv
    far = torch.maximum(lo, hi)
    return torch.minimum(far[..., 0], far[..., 1])


def _nonzero_dir(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d == 0.0, 1e-8, d)


def _search_march(trans_field, state, wave_alive, uesc, origin_uv, dir_uv,
                  interval: float, generator: torch.Generator, max_steps: int):
    """SEARCH phase: total transmittance + compacted stratified deposits.

    Deposits go into per-photon ordinal buffers (N, MAXD): the deposit
    ordinal IS the stratified sample index, so the buffers are exact and
    bounded by MAXD = ceil(steps/interval) + 2. A firing photon adds its
    sample at column sample_idx (the JAX version's one-hot mask, written as
    a scatter_add_ of the masked values: the other columns gain 0).
    """
    n = state.origin.shape[0]
    dev = origin_uv.device
    maxd = int((max_steps + 1) / interval) + 2
    trans = torch.ones((n,), device=dev)
    u_target = torch.rand((n,), generator=generator, device=dev) * interval
    sample_idx = torch.zeros((n,), device=dev)
    dep_u = torch.zeros((n, maxd), device=dev)
    dep_w = torch.zeros((n, maxd), device=dev)
    for k in range(max_steps):
        u_next = float(k + 1)
        t = sample_bilinear_uv(trans_field, origin_uv + dir_uv * float(k))
        active = (u_next <= uesc) & wave_alive
        trans = torch.where(active, trans * t, trans)
        # Up to two stratified deposits fit in a unit step when interval >= 1
        # (consecutive stratified gaps sum to >= interval).
        xis = torch.rand((2, n), generator=generator, device=dev)
        for xi in xis:
            fire = active & (u_next > u_target)
            keep = fire & (sample_idx < maxd)
            col = sample_idx.long().clamp(max=maxd - 1)[:, None]
            dep_u.scatter_add_(1, col, torch.where(keep, u_target, 0.0)[:, None])
            dep_w.scatter_add_(1, col, torch.where(
                keep, interval * interval * trans, 0.0)[:, None])
            sample_idx = torch.where(fire, sample_idx + 1.0, sample_idx)
            u_target = torch.where(fire, (sample_idx + xi) * interval, u_target)
    return trans, dep_u, dep_w, sample_idx


def _resolve_march(trans_field, wave_alive, uesc, origin_uv, dir_uv, tp,
                   max_steps: int):
    """RESOLVE phase: locate the sampled interaction point."""
    n = origin_uv.shape[0]
    dev = origin_uv.device
    trans = torch.ones((n,), device=dev)
    found = torch.zeros((n,), dtype=torch.bool, device=dev)
    escaped = torch.zeros((n,), dtype=torch.bool, device=dev)
    u_hit = torch.zeros((n,), device=dev)
    test_uv = origin_uv
    for k in range(max_steps):
        u_next = float(k + 1)
        uv = origin_uv + dir_uv * float(k)
        t = sample_bilinear_uv(trans_field, uv)
        live = wave_alive & ~found & ~escaped
        esc_now = live & (u_next > uesc)
        cross = live & ~esc_now & (t * trans < tp)
        # Fractional crossing within the tested texel
        # (ForwardMonteCarlo.compute:184-192).
        frac = torch.log2(torch.clamp(tp / torch.clamp(trans, min=1e-30), min=1e-30)) / (
            torch.log2(torch.clamp(t, min=1e-30)) - 1e-5)
        u_hit = torch.where(cross, u_next + frac, u_hit)
        test_uv = torch.where(cross[:, None], uv, test_uv)
        found = found | cross
        escaped = escaped | esc_now
        trans = torch.where(live & ~cross & ~esc_now, trans * t, trans)
    return found, escaped, u_hit, test_uv


def trace_frame(gbuffer: GBuffer, lights, field_textures, brdf_lut,
                generator: torch.Generator, n_photons: int, interval: float,
                override_bounces, max_bounces: int = 4, max_steps: int = 0,
                bilinear: bool = True):
    """Trace one frame's photon batch; returns (raw (H, W, 3), write_count).

    `raw` is the frame's energy deposit map before HDR conversion, already
    incorporating the (W*H)/(rays*interval) emission scaling so that
    `hdr = accumulate(raw)/iterations * albedo * outscatter` matches
    ConvertToHDR (ForwardMonteCarlo.compute:358-382). write_count is the
    number of deposits, an int64 tensor on the device (not read back).
    """
    height, width = gbuffer.transmissibility.shape
    dev = gbuffer.transmissibility.device
    if max_steps <= 0:
        max_steps = int((height**2 + width**2) ** 0.5) + 4
    interval = float(max(interval, 1e-2))
    size = torch.stack([torch.full((), float(width), device=dev),
                        torch.full((), float(height), device=dev)])
    pixel = 1.0 / size

    l_idx, rays_per_light = assign_photons_to_lights(lights, n_photons)
    origin, direction, energy, bounces = emit(
        lights, field_textures, l_idx, rays_per_light, generator,
        (height, width), interval, override_bounces)

    state = PhotonState(origin, direction, energy, bounces,
                        dead=torch.zeros(n_photons, dtype=torch.bool, device=dev))
    accum = torch.zeros((height, width, 3), device=dev)
    write_count = torch.zeros((), dtype=torch.int64, device=dev)
    scatter = scatter_add_bilinear_mxu if bilinear else scatter_add_nearest_mxu

    for wave in range(max_bounces):
        wave_alive = (~state.dead) & (wave < state.bounces)
        d = _nonzero_dir(state.direction)
        origin_uv = state.origin / size
        dir_uv = d / size
        uesc = _escape_distance(origin_uv, dir_uv, pixel)

        t_total, dep_u, dep_w, n_deposits = _search_march(
            gbuffer.transmissibility, state, wave_alive, uesc, origin_uv, dir_uv,
            interval, generator, max_steps)

        # Splat this wave's deposit stream; out-of-frame taps are dropped,
        # like the GPU's silently-dropped out-of-bounds writes.
        pos = (state.origin[:, None, :]
               + state.direction[:, None, :] * dep_u[..., None]).reshape(-1, 2)
        values = (state.energy[:, None, :] * dep_w[..., None]).reshape(-1, 3)
        accum = scatter(accum, pos, values)
        write_count = write_count + n_deposits.sum().long()

        # Transmit potential + quantum scale (ForwardMonteCarlo.compute:209-214).
        tp = t_total + torch.rand((n_photons,), generator=generator,
                                  device=dev) * (1.0 - t_total)
        quantum_scale = 1.0 - t_total

        found, _, u_hit, test_uv = _resolve_march(
            gbuffer.transmissibility, wave_alive, uesc, origin_uv, dir_uv, tp,
            max_steps)

        pos_hit = state.origin + state.direction * u_hit[:, None]
        normal4 = sample_bilinear_uv(gbuffer.normal, test_uv)
        albedo = sample_nearest_uv(gbuffer.albedo, test_uv)[..., :3]

        rand3 = torch.rand((n_photons, 3), generator=generator, device=dev)
        new_dir, mat_scale, pushback = scatter_materially(
            brdf_lut, normal4, state.direction, rand3)

        bounced = (wave_alive & found)[:, None]
        energy = torch.where(
            bounced, state.energy * albedo * (quantum_scale * mat_scale)[:, None],
            state.energy)
        origin = torch.where(bounced, pos_hit + pushback + new_dir, state.origin)
        direction = torch.where(bounced, new_dir, state.direction)
        dead = state.dead | (wave_alive & ~found)
        state = PhotonState(origin, direction, energy, state.bounces, dead)

    return accum, write_count


def to_hdr(accum: torch.Tensor, iterations, gbuffer: GBuffer,
           finalize_outscatter: bool = True) -> torch.Tensor:
    """ConvertToHDR (ForwardMonteCarlo.compute:358-382) in float arithmetic."""
    if isinstance(iterations, torch.Tensor):
        out = accum / torch.clamp(iterations, min=1.0)
    else:
        out = accum / max(float(iterations), 1.0)
    out = out * gbuffer.albedo[..., :3]
    if finalize_outscatter:
        out = out * (1.0 - gbuffer.transmissibility)[..., None]
    return out
