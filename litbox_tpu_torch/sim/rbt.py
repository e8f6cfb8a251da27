"""Rotated-bin transport (RBT): the production photon engine (counterpart of
the JAX package's sim/rbt.py).

Photon directions are quantized to D angular bins. For each bin the
log-transmissibility field is resampled into a frame where the bin
direction is the +x axis, so a photon's free flight is work on ONE row of a
(D, S, S) field. Photons inject their energy at their rotated cells
(`_inject_flat`); `resolve_raw` later runs the per-row attenuation scan
    O[x] = t[x] * O[x-1] + src[x] * sqrt(t[x])
and rotates every bin back into the target frame and sums.

The trace runs every light kind with the JAX package's default options
(analytic direct light for point lights, Monte-Carlo direct light for the
rest, bounce chains emitted by `emit`, BRDF materials) and bench.py's
stamp-histogram options, with one tracer or several (`n_tracers`, the
dual-tracer pair of the shipped realtime frame). Collimated lights (lasers,
directional lights) may take the exact wave-0 field of
`collimated_direct_raw` instead of Monte-Carlo direct photons
(`exact_collimated`): a one-bin rotated field at the light's own angle,
scanned by K1 and rotated back by K2 and K3. Random numbers come from an
explicit `torch.Generator` on the fields' device, so the draws differ from
the JAX package's threefry stream and the two agree in distribution, not
bit for bit.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.types import (LIGHT_DIRECTIONAL, LIGHT_LASER, LIGHT_POINT, GBuffer,
                          affine_linear)
from ..ops.attnscan import attenuation_scan_rows
from ..ops.resample import gather_bilinear
from ..ops.rotate import rotate_bins, rotate_bins_uniform, rotate_planar_sum
from .emission import (assign_photons_to_lights, effective_bounces, emit,
                       emit_point_stratified, take_per_light)
from .materials import TWO_PI, scatter_materially, unit_from_angle

LOGT_CLAMP = -20.0  # per-texel transmissibility floor e^-20 ~ 2e-9 (opaque)
COARSE = 16         # free-flight search: coarse subsample stride of C rows
ANALYTIC_STAMP = 16  # point-light stamp width of the direct histogram
FLIGHT_CHUNK_ELEMS = 1 << 27  # photons x S cum-log elements gathered at once (512 MB)


@dataclasses.dataclass(frozen=True)
class RotatedFields:
    """Per-bin rotated transport fields (frame-constant per scene)."""

    cos: torch.Tensor         # (D,)
    sin: torch.Tensor         # (D,)
    trans: torch.Tensor       # (D, S, S) per-cell transmissibility along rows
    cum_log: torch.Tensor     # (D, S, S) cumulative log-transmissibility C
    cum_coarse: torch.Tensor  # (D, S, S/COARSE) C[..., COARSE-1::COARSE] subsample
    center: torch.Tensor      # (2,) target-frame center
    phase: torch.Tensor       # () bin-fan phase offset in bin units, [0, 1)

    @property
    def n_bins(self) -> int:
        return self.cos.shape[0]

    @property
    def size(self) -> int:
        return self.trans.shape[-1]


def precompute_rotated_fields(gbuffer: GBuffer, n_bins: int = 128,
                              rot_size: int = 0,
                              phase: torch.Tensor | float = 0.0) -> RotatedFields:
    """Resample log-transmissibility into the D bin frames.

    phase (bin units in [0, 1)) rotates the whole bin fan by
    phase*2pi/n_bins. S is rounded up to a multiple of 128, as in the JAX
    package, so that shapes match it. The resample is `gather_bilinear` in
    float32 (the JAX package's default is bf16 weights).
    """
    height, width = gbuffer.transmissibility.shape
    dev = gbuffer.transmissibility.device
    s = rot_size or int(-(-int(np.ceil((height**2 + width**2) ** 0.5)) // 128) * 128)
    d = n_bins

    # Scalars are filled on the device: a tensor built from host numbers
    # would be a copy that waits for the stream.
    if not isinstance(phase, torch.Tensor):
        phase = torch.full((), float(phase), device=dev)
    phase = phase.to(dev, torch.float32)
    angles = (torch.arange(d, dtype=torch.float32, device=dev) + phase) * (2 * math.pi / d)
    cos = torch.cos(angles)
    sin = torch.sin(angles)
    center = torch.stack([torch.full((), width / 2.0, device=dev),
                          torch.full((), height / 2.0, device=dev)])

    logt = torch.log(torch.clamp(gbuffer.transmissibility, float(np.exp(LOGT_CLAMP)), 1.0))

    # Rotated-grid sample points: p = R_d^T (p' - c') + c. R_d maps the bin
    # direction to +x, so rows of the rotated field are rays of bin d.
    xs = torch.arange(s, dtype=torch.float32, device=dev) + 0.5 - s / 2.0
    rx = xs[None, None, :]
    ry = xs[None, :, None]
    px = cos[:, None, None] * rx - sin[:, None, None] * ry + center[0]
    py = sin[:, None, None] * rx + cos[:, None, None] * ry + center[1]
    points = torch.stack([px, py], dim=-1).reshape(-1, 2)
    del px, py

    logt_rot = gather_bilinear(logt, points).reshape(d, s, s)
    cum_log = torch.cumsum(logt_rot, dim=-1)
    return RotatedFields(cos=cos, sin=sin, trans=torch.exp(logt_rot),
                         cum_log=cum_log,
                         cum_coarse=cum_log[..., COARSE - 1::COARSE].contiguous(),
                         center=center, phase=phase)


def _inject_flat(src_accum: tuple, flat_idx: torch.Tensor, energy: torch.Tensor) -> tuple:
    """Scatter-add photon energies at flat cell indices into the per-channel
    source buffers (3 x (T*D, S, S)), IN PLACE: each channel's flat view
    takes one `index_add_`. Returns the same tuple (the JAX version returns
    updated copies). The index adds replace the reference's InterlockedAdd
    writes (ForwardMonteCarlo.compute:68-105); on the GPU they are atomic
    adds, so the sum order varies from run to run."""
    idx = flat_idx.long()
    for c, ch in enumerate(src_accum):
        ch.view(-1).index_add_(0, idx, energy[:, c].contiguous())
    return src_accum


def zero_sources(fields: RotatedFields, n_tracers: int = 1) -> tuple:
    """Fresh per-channel source buffers (3 x (T*D, S, S), tracer-major)."""
    d, s = fields.n_bins, fields.size
    return tuple(torch.zeros((n_tracers * d, s, s), device=fields.trans.device)
                 for _ in range(3))


def collimated_light_mask(lights, override_bounces=None) -> torch.Tensor:
    """(L,) True for lights whose wave-0 deposits are computed exactly along
    their true direction: lasers and directional lights, which emit parallel
    rays (ForwardMonteCarlo.compute:243-251, 282-294), so their expected
    direct field is one attenuation recurrence with no D-bin quantization."""
    return (((lights.kind == LIGHT_LASER) | (lights.kind == LIGHT_DIRECTIONAL))
            & lights.active
            & (effective_bounces(lights.bounces, override_bounces) != 0))


def _laser_direct_raw(gbuffer: GBuffer, affine: torch.Tensor, energy: torch.Tensor,
                      height: int, width: int, rot_size: int = 0) -> torch.Tensor:
    """Exact wave-0 deposit field (H, W, 3) of ONE collimated light.

    Its rays are parallel, so its expected direct field obeys a 1D
    attenuation recurrence along the exact beam direction: a one-bin rotated
    field at the light's own angle (fields.phase carries it), the emitting
    rect's coverage rasterized analytically on the rotated grid, the scan
    (K1) and the rotate-back (K2, K3). Total injected energy is
    energy * W * H, the emit() convention at interval=1.

    The emitting rect is the affine's local x in [-1/2, 1/2], y in [0, 1]
    (laser_origin, emission.py) with flight direction -affine[:, 1]; a
    directional light passes the affine of its entry segment
    (_directional_affine) and a rot_size that holds it. Texels outside the
    frame are vacuum: gather_bilinear fades to 0 there, so their
    log-transmissibility is 0. `affine` and `energy` are tensors on the
    GBuffer's device and are not read on the host.
    """
    d = -affine[:, 1]
    d = d / torch.clamp(torch.linalg.norm(d), min=1e-12)
    theta = torch.atan2(d[1], d[0])
    fields = precompute_rotated_fields(gbuffer, n_bins=1, rot_size=rot_size,
                                       phase=theta / (2.0 * math.pi))
    s = fields.size
    dev = fields.trans.device

    # Rotated-grid points in target-frame coordinates (as in precompute).
    xs = torch.arange(s, dtype=torch.float32, device=dev) + 0.5 - s / 2.0
    cb, sb = fields.cos[0], fields.sin[0]
    px = cb * xs[None, :] - sb * xs[:, None] + fields.center[0]
    py = sb * xs[None, :] + cb * xs[:, None] + fields.center[1]

    # Analytic antialiased coverage of the emitting rect in its local frame.
    lin = affine[:, :2]
    det = lin[0, 0] * lin[1, 1] - lin[0, 1] * lin[1, 0]
    det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    inv = torch.stack([torch.stack([lin[1, 1], -lin[0, 1]]),
                       torch.stack([-lin[1, 0], lin[0, 0]])]) / det
    rx = px - affine[0, 2]
    ry = py - affine[1, 2]
    lx = inv[0, 0] * rx + inv[0, 1] * ry
    ly = inv[1, 0] * rx + inv[1, 1] * ry
    g0 = torch.clamp(torch.linalg.norm(inv[0]), min=1e-12)   # |grad lx| per texel
    g1 = torch.clamp(torch.linalg.norm(inv[1]), min=1e-12)
    cov = (torch.clamp((0.5 - torch.abs(lx)) / g0 + 0.5, 0.0, 1.0)
           * torch.clamp((0.5 - torch.abs(ly - 0.5)) / g1 + 0.5, 0.0, 1.0))

    total = energy * float(width * height)
    src = cov[None] / torch.clamp(cov.sum(), min=1e-12)
    deposited = attenuation_scan(fields, tuple(src * total[c] for c in range(3)))
    # traced_phase: the field's angle lives in fields.phase.
    return rotate_back(fields, deposited, height, width, traced_phase=True)


def _directional_affine(affine: np.ndarray, height: int,
                        width: int) -> tuple[np.ndarray, int]:
    """The emitting-rect affine (and the rotated-field size that holds it)
    of a directional light's entry segment.

    EmitDirectionalLight (ForwardMonteCarlo.compute:282-294, emission.py)
    emits origins on the pixel-space segment
        p(t) = (0.5 - dl + t * dperp) * size,  t in [-0.7075, 0.7075]
    flying along dl. In _laser_direct_raw's local frame that segment is the
    columns [1.415 * dperp * size, -dl, p(0)]: a 1-texel-deep rect whose
    normalized coverage is the emission density. rot_size is a multiple of
    256 that holds the frame and the segment."""
    size = np.array([width, height], np.float64)
    dl = -affine[:, 1]
    dl = dl / max(np.linalg.norm(dl), 1e-12)
    dperp = np.array([dl[1], -dl[0]])
    col0 = 1.415 * dperp * size
    center = (0.5 - dl) * size
    synth = np.stack([col0, -dl, center], axis=1).astype(np.float32)
    half_span = max(
        float(np.linalg.norm(center - 0.5 * size) + 0.5 * np.linalg.norm(col0)),
        0.5 * float(np.hypot(height, width))) + 2.0
    rot_size = int(-(-int(np.ceil(2.0 * half_span)) // 256) * 256)
    return synth, rot_size


def collimated_direct_raw(gbuffer: GBuffer, lights, height: int,
                          width: int, override_bounces=None) -> torch.Tensor | None:
    """Sum of the exact wave-0 fields of all collimated lights: a per-scene
    precompute, None when the scene has none. It reads the light mask and
    kinds on the host (and a directional light's affine), once per call."""
    mask = collimated_light_mask(lights, override_bounces).cpu().numpy()
    if not mask.any():
        return None
    kinds = lights.kind.cpu().numpy()
    dev = gbuffer.transmissibility.device
    total = torch.zeros((height, width, 3), device=dev)
    for li in np.nonzero(mask)[0]:
        affine, rot_size = lights.affine[li], 0
        if kinds[li] == LIGHT_DIRECTIONAL:
            synth, rot_size = _directional_affine(affine.cpu().numpy(), height, width)
            affine = torch.from_numpy(synth).to(dev)
        total = total + _laser_direct_raw(gbuffer, affine, lights.energy[li],
                                          height, width, rot_size=rot_size)
    return total


def _light_radius(affine: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.abs(affine[..., 0, 0] * affine[..., 1, 1]
                                - affine[..., 0, 1] * affine[..., 1, 0]))


def analytic_light_mask(lights, override_bounces=None) -> torch.Tensor:
    """(L,) True for lights whose wave-0 deposits are injected analytically."""
    return ((lights.kind == LIGHT_POINT) & lights.active
            & (_light_radius(lights.affine) < ANALYTIC_STAMP / 2 - 1)
            & (effective_bounces(lights.bounces, override_bounces) != 0))


def _analytic_point_deposits(lights, light_mask: torch.Tensor,
                             fields: RotatedFields, pixel_count: float,
                             n_tracers: int = 1):
    """Noise-free direct-light deposit stream for point lights.

    A point light emits uniformly over a disk with isotropic directions, so
    its expected per-bin wave-0 source field is deterministic:
    total_energy/(2 pi D) times the disk's coverage density at the light's
    rotated center, laid on a STAMP x STAMP box of cells. Returns
    (flat_idx, values), light-major then bin, row and column, the JAX
    version's order. All lights are computed at once (the JAX version loops
    over the light capacity); a disabled light's values are 0.

    n_tracers > 1: the expectation is deterministic, so every tracer block
    gets the same stream at its own bin block (values tiled, indices offset
    by tr*D*S*S), tracer-major as in the JAX version.
    """
    d_bins, s = fields.n_bins, fields.size
    dev = fields.trans.device
    stamp = ANALYTIC_STAMP

    offs = torch.arange(stamp, dtype=torch.float32, device=dev) - stamp / 2 + 0.5
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    rr = torch.sqrt(ox**2 + oy**2)
    ang = (torch.arange(d_bins, dtype=torch.float32, device=dev)
           + fields.phase) * (TWO_PI / d_bins)
    cb, sb = torch.cos(ang), torch.sin(ang)

    radius = _light_radius(lights.affine)                     # (L,)
    cover = torch.clamp(radius[:, None, None] + 0.5 - rr, 0.0, 1.0)
    cover = cover / torch.clamp(cover.sum((1, 2)), min=1e-12)[:, None, None]
    # Total emitted energy matches emit() with interval=1:
    # per-photon E = energy*(W*H)/(rays*2pi), times rays, over D bins.
    per_bin = lights.energy * (pixel_count / (TWO_PI * d_bins))  # (L, 3)

    rel = lights.affine[:, :, 2] - fields.center              # (L, 2)
    cx = cb[None] * rel[:, 0:1] + sb[None] * rel[:, 1:2] + s / 2.0   # (L, D)
    cy = -sb[None] * rel[:, 0:1] + cb[None] * rel[:, 1:2] + s / 2.0
    iy = (cy[:, :, None, None] + oy).long().clamp(0, s - 1)    # (L, D, st, st)
    ix = (cx[:, :, None, None] + ox).long().clamp(0, s - 1)
    bins = torch.arange(d_bins, device=dev)[None, :, None, None]
    flat = (bins * s + iy) * s + ix

    enabled = torch.where(light_mask, 1.0, 0.0)[:, None, None, None, None]
    vals = (enabled * cover[:, None, :, :, None]
            * per_bin[:, None, None, None, :]).expand(-1, d_bins, -1, -1, -1)
    offs = torch.arange(n_tracers, device=dev) * (d_bins * s * s)
    flat = (flat.reshape(1, -1) + offs[:, None]).reshape(-1)
    return flat, vals.reshape(-1, 3).repeat(n_tracers, 1)


def _rotated_coords(fields: RotatedFields, pos: torch.Tensor,
                    cb: torch.Tensor, sb: torch.Tensor):
    """Target-frame position -> (xr, yr) in the bin frame of angle (cb, sb)."""
    s = fields.size
    rel = pos - fields.center
    xr = cb * rel[..., 0] + sb * rel[..., 1] + s / 2.0
    yr = -sb * rel[..., 0] + cb * rel[..., 1] + s / 2.0
    return xr, yr


def _row_flight_math(rows: torch.Tensor, xr: torch.Tensor, u_tp: torch.Tensor,
                     live: torch.Tensor, s: int):
    """Distance-sampled free flight on extracted cum-log rows (..., S).

    The reference's free-flight sampling tp ~ U[T_esc, 1]
    (ForwardMonteCarlo.compute:209-214) inverts to the first column where
    C drops below C[x0] + ln(tp): a compare-count over the row (C is
    non-increasing, so the count IS the searchsorted index).
    C[x0] is the linear interpolation at xr - 0.5 with zero outside the row
    (the JAX version's tent weights, taken as two taps).
    Returns (hit_x, t_esc, found).
    """
    x = xr - 0.5
    x0 = torch.floor(x)
    fx = x - x0
    i0 = x0.long()
    c0 = torch.zeros_like(xr)
    for di, w in ((0, 1.0 - fx), (1, fx)):
        i = i0 + di
        tap = rows.gather(-1, i.clamp(0, s - 1)[..., None])[..., 0]
        c0 = c0 + torch.where((i >= 0) & (i < s), tap * w, 0.0)
    c_end = rows[..., -1]
    t_esc = torch.exp(torch.clamp(c_end - c0, -60.0, 0.0))

    tp = t_esc + u_tp * (1.0 - t_esc)
    thr = c0 + torch.log(torch.clamp(tp, min=1e-30))
    x_star = (rows >= thr[..., None]).sum(-1)
    found = live & (x_star < s) & (x_star > 0)
    x_star = x_star.clamp(1, s - 1)

    c_at = rows.gather(-1, x_star[..., None])[..., 0]
    c_prev = rows.gather(-1, (x_star - 1)[..., None])[..., 0]
    frac = torch.clamp((c_prev - thr) / (c_prev - c_at - 1e-12), 0.0, 1.0)
    hit_x = x_star.float() - 0.5 + frac
    return hit_x, t_esc, found


def _flight_gathered(table: torch.Tensor, row_idx: torch.Tensor,
                     xr: torch.Tensor, u_tp: torch.Tensor, live: torch.Tensor):
    """`_row_flight_math` for flat photon arrays whose cum-log rows are
    `table[row_idx]` (table: the (bins*S, S) rows of a cum-log field),
    gathered a chunk of photons at a time so that the (photons, S) rows
    never exist in full."""
    s = table.shape[-1]
    chunk = max(1, FLIGHT_CHUNK_ELEMS // s)
    parts = [_row_flight_math(table[row_idx[a:a + chunk]], xr[a:a + chunk],
                              u_tp[a:a + chunk], live[a:a + chunk], s)
             for a in range(0, row_idx.shape[0], chunk)]
    return tuple(torch.cat(p) for p in zip(*parts))


def _flight_rows(fields: RotatedFields, pos: torch.Tensor, direction: torch.Tensor,
                 live: torch.Tensor, u_tp: torch.Tensor):
    """Free flight for a flat photon batch with arbitrary directions: each
    photon's bin comes from its direction, its row from its rotated y."""
    s = fields.size
    b, cb, sb = _direction_bins(fields, direction)
    xr, yr = _rotated_coords(fields, pos, cb, sb)
    iy = torch.floor(yr).long().clamp(0, s - 1)
    hit_x, t_esc, found = _flight_gathered(fields.cum_log.view(-1, s), b * s + iy,
                                            xr, u_tp, live)

    hx = hit_x - s / 2.0
    hy = yr - s / 2.0
    p_hit = torch.stack([cb * hx - sb * hy, sb * hx + cb * hy], -1) + fields.center
    return p_hit, t_esc, found


def _flight_stratified(fields: RotatedFields, pos: torch.Tensor, live: torch.Tensor,
                       u_tp: torch.Tensor):
    """Free flight for a direction-stratified (D, cap) photon layout.

    Photons of row d are in bin d by construction (emit_point_stratified),
    so each photon's cum-log row is the row gather cum_log[d, iy]: exactly
    the row the JAX version selects with a one-hot matmul per bin.
    """
    d_bins, s = fields.n_bins, fields.size
    cb, sb = fields.cos[:, None], fields.sin[:, None]
    xr, yr = _rotated_coords(fields, pos, cb, sb)              # (D, cap)
    iy = torch.floor(yr).long().clamp(0, s - 1)
    bins = torch.arange(d_bins, device=pos.device)[:, None]
    hit_x, t_esc, found = _flight_gathered(
        fields.cum_log.view(-1, s), (bins * s + iy).reshape(-1), xr.reshape(-1),
        u_tp.reshape(-1), live.reshape(-1))
    hit_x, t_esc, found = (a.reshape(xr.shape) for a in (hit_x, t_esc, found))
    hx = hit_x - s / 2.0
    hy = yr - s / 2.0
    p_hit = torch.stack([cb * hx - sb * hy, sb * hx + cb * hy], -1) + fields.center
    return p_hit, t_esc, found


def _mc_point_hist_deposits(lights, fields: RotatedFields, n_photons: int,
                            generator: torch.Generator, override_bounces,
                            pixel_count: float, n_tracers: int = 1):
    """Monte-Carlo direct deposit stream for all-point-light scenes,
    aggregated as a per-(bin, light) stamp histogram. Returns
    (flat_idx, values, n_emitted).

    Each photon samples its disk position and direction bin (bin-stratified,
    see emit_point_stratified); a point light's wave-0 cells all land in a
    STAMP-wide box around its rotated center, so the per-photon deposits
    reduce to a histogram of local cells, counted with an integer
    `scatter_add_` (the JAX version sums a one-hot, which XLA keeps virtual; built in
    eager PyTorch it would be 4-8 GB at 2M photons), plus a
    D*L*STAMP^2-cell deposit stream of the aggregate.

    Every photon of light l carries energy_l * (W*H) / (2pi * rays_l); the
    histogram multiplies counts by that constant. Requires every active
    light to be a point light of radius < STAMP/2 - 1 so the stamp never
    clips.

    n_tracers > 1 splits the n photons into T independent tracer batches in
    the same histogram, the JAX version's partition: cap = ceil(n / (D*T)),
    the slot axis widens to T*cap (slot j belongs to tracer j // cap and
    light l_of_slot[j % cap]), the tracer is folded into the count index,
    and tracer t's aggregate lands at bin block t*D. Each tracer's energy is
    normalized by its own ray count cap*D.
    """
    d_bins, s = fields.n_bins, fields.size
    dev = fields.trans.device
    capacity = lights.capacity
    stamp = ANALYTIC_STAMP
    cap = -(-n_photons // (d_bins * n_tracers))
    n_emitted = cap * d_bins * n_tracers

    l_of_slot, slots = assign_photons_to_lights(lights, cap)
    l_of_slot = l_of_slot.repeat(n_tracers)                    # (T*cap,)
    l_slot = l_of_slot.long()
    aff = take_per_light(lights.affine, l_of_slot)             # (T*cap, 2, 3)
    rel_slot = aff[:, :, 2] - fields.center                    # (T*cap, 2)

    # Disk offsets in the target frame (light affine scales/rotates).
    u = torch.rand((d_bins, cap * n_tracers, 2), generator=generator, device=dev)
    disk = unit_from_angle(u[..., 0] * TWO_PI) * torch.sqrt(u[..., 1])[..., None]
    off = affine_linear(aff[None], disk)                       # (D, T*cap, 2)

    # Per-(bin, light) stamp anchors from the exact light centers.
    relc = lights.affine[:, :, 2] - fields.center              # (L, 2)
    cb, sb = fields.cos[:, None], fields.sin[:, None]          # (D, 1)
    cxl = cb * relc[None, :, 0] + sb * relc[None, :, 1] + s / 2.0   # (D, L)
    cyl = -sb * relc[None, :, 0] + cb * relc[None, :, 1] + s / 2.0
    axl = (torch.floor(cxl).long() - stamp // 2).clamp(0, s - stamp)
    ayl = (torch.floor(cyl).long() - stamp // 2).clamp(0, s - stamp)

    # Photon cells in each bin frame.
    xr = (cb * rel_slot[None, :, 0] + sb * rel_slot[None, :, 1] + s / 2.0
          + cb * off[..., 0] + sb * off[..., 1])
    yr = (-sb * rel_slot[None, :, 0] + cb * rel_slot[None, :, 1] + s / 2.0
          - sb * off[..., 0] + cb * off[..., 1])
    lx = (torch.floor(xr).long() - axl[:, l_slot]).clamp(0, stamp - 1)
    ly = (torch.floor(yr).long() - ayl[:, l_slot]).clamp(0, stamp - 1)
    n_cells = capacity * stamp * stamp
    tracer = torch.arange(cap * n_tracers, device=dev) // cap   # (T*cap,)
    col = (torch.arange(d_bins, device=dev)[:, None] * (n_tracers * n_cells)
           + (tracer * n_cells + l_slot * (stamp * stamp))[None]
           + ly * stamp + lx)                                  # (D, T*cap)
    # Integer scatter_add_ into a known size: exact counts, and unlike
    # bincount no read-back of the maximum to the host.
    counts = torch.zeros(d_bins * n_tracers * n_cells, dtype=torch.long, device=dev)
    counts.scatter_add_(0, col.reshape(-1), torch.ones_like(col).reshape(-1))
    counts = counts.float().reshape(d_bins, n_tracers, capacity, stamp * stamp)

    # Per-light photon energy constant (same for every slot of a light).
    bounces_l = effective_bounces(lights.bounces, override_bounces)
    rays_l = torch.clamp(slots * d_bins, min=1).float()
    e_l = (lights.energy * (pixel_count / TWO_PI) / rays_l[:, None]
           * lights.active.float()[:, None]
           * (bounces_l > 0).float()[:, None])                 # (L, 3)
    vals = (counts[..., None] * e_l[None, None, :, None, :]    # (D, T, L, c, 3)
            ).transpose(0, 1)                                  # (T, D, L, c, 3)

    # Aggregate deposit stream: T*D*L*stamp^2 cells, tracer-major.
    o = torch.arange(stamp, device=dev)
    gy = ayl[:, :, None, None] + o[None, None, :, None]        # (D, L, st, st)
    gx = axl[:, :, None, None] + o[None, None, None, :]
    flat = ((torch.arange(d_bins, device=dev)[:, None, None, None] * s + gy) * s + gx)
    offs = torch.arange(n_tracers, device=dev) * (d_bins * s * s)
    flat = flat[None] + offs[:, None, None, None, None]        # (T, D, L, st, st)
    return flat.reshape(-1), vals.reshape(-1, 3), n_emitted


def _direction_bins(fields: RotatedFields, direction: torch.Tensor):
    """Each photon's direction bin b and the bin's (cos, sin)."""
    d_bins = fields.n_bins
    bin_width = TWO_PI / d_bins
    theta = torch.atan2(direction[:, 1], direction[:, 0])
    b = torch.round(theta / bin_width - fields.phase).long() % d_bins
    ang = (b.float() + fields.phase) * bin_width
    return b, torch.cos(ang), torch.sin(ang)


def _deposit_cells(fields: RotatedFields, pos: torch.Tensor,
                   direction: torch.Tensor) -> torch.Tensor:
    """Flat (bin, row, column) source cell of each photon at `pos`, in the
    frame of its direction's bin."""
    s = fields.size
    b, cb, sb = _direction_bins(fields, direction)
    xr, yr = _rotated_coords(fields, pos, cb, sb)
    ix = torch.floor(xr).long().clamp(0, s - 1)
    iy = torch.floor(yr).long().clamp(0, s - 1)
    return (b * s + iy) * s + ix


def _mc_scatter_deposits(lights, field_textures, fields: RotatedFields,
                         gbuffer: GBuffer, n_photons: int,
                         generator: torch.Generator, override_bounces,
                         light_kinds, exclude_analytic: bool,
                         exclude_collimated: bool = False,
                         n_tracers: int = 1):
    """Generic Monte-Carlo direct deposit stream: emit n photons across all
    lights; their energy lands at their rotated emission cells (the
    counterpart of WritePhoton's InterlockedAdd,
    ForwardMonteCarlo.compute:68-86). Returns (flat_idx, values).

    exclude_analytic zeroes the photons of lights that the analytic phase
    covers, and exclude_collimated those of the lights whose exact field
    (collimated_direct_raw) is added at readout, so their direct light is
    not counted twice.

    n_tracers > 1: one emission of T * (n // T) photons partitioned into T
    blocks (photon j belongs to tracer j // (n // T)); each is normalized by
    its own ray count and deposits into its own bin block."""
    height, width = gbuffer.transmissibility.shape
    d_bins, s = fields.n_bins, fields.size
    n_per = n_photons // n_tracers
    l_idx, rays_per_light = assign_photons_to_lights(lights, n_per)
    l_idx = l_idx.repeat(n_tracers)
    pos, direction, energy, bounces = emit(
        lights, field_textures, l_idx, rays_per_light, generator,
        (height, width), 1.0, override_bounces, active_kinds=light_kinds)

    inject = bounces > 0
    if exclude_analytic:
        inject &= ~take_per_light(analytic_light_mask(lights, override_bounces), l_idx)
    if exclude_collimated:
        inject &= ~take_per_light(collimated_light_mask(lights, override_bounces), l_idx)
    tracer = torch.arange(n_per * n_tracers, device=pos.device) // n_per
    flat = _deposit_cells(fields, pos, direction) + tracer * (d_bins * s * s)
    return flat, torch.where(inject[:, None], energy, 0.0)


def _bounce_chain_deposits(fields: RotatedFields, gbuffer: GBuffer,
                           lights, field_textures, brdf_lut,
                           generator: torch.Generator, k_photons: int,
                           override_bounces, max_bounces: int, enable_brdf: bool,
                           light_kinds, stratified: bool, n_tracers: int = 1):
    """Trace k bounce chains; return their wave >= 1 deposit stream
    (flat_idx, values), all waves concatenated.

    The chains are the Russian-roulette continuation of the frame's photon
    batch: a fresh emission of k photons is identical in distribution to a
    uniform k-subset of the n direct photons, and the emission normalizes
    per-photon energy by k, which IS the n/k roulette rescale. With
    `stratified`, wave 0 is emitted bin-stratified (emit_point_stratified,
    point lights only) and flown per bin; otherwise `emit` emits every light
    kind and every wave flies with arbitrary directions. The material lookup
    is a direct index (the JAX version's non-TPU branch).

    n_tracers > 1: the k chains split into T blocks flown in the same batch
    (cap = ceil(k / (D*T)) slots per tracer and bin when stratified, else
    k // T photons per tracer); flight and scatter are tracer-blind, and the
    tracer only offsets each deposit by tr*D*S*S. Each block is normalized by
    its own emission count.
    """
    height, width = gbuffer.transmissibility.shape
    d_bins, s = fields.n_bins, fields.size
    dev = fields.trans.device

    material = torch.cat([gbuffer.normal, gbuffer.albedo[..., :3]], -1)

    wave0 = None
    if stratified:
        cap = -(-k_photons // (d_bins * n_tracers))
        l_of_slot, slots = assign_photons_to_lights(lights, cap)
        l_of_slot = l_of_slot.repeat(n_tracers)
        pos, direction, energy, bounces = emit_point_stratified(
            lights, l_of_slot, slots, d_bins, fields.phase, generator,
            (height, width), 1.0, override_bounces)
        u_tp = torch.rand(bounces.shape, generator=generator, device=dev)
        wave0 = _flight_stratified(fields, pos, bounces > 0, u_tp)
        m = d_bins * cap * n_tracers
        pos, direction, energy, bounces = (
            a.reshape((m,) + a.shape[2:]) for a in (pos, direction, energy, bounces))
        wave0 = tuple(a.reshape((m,) + a.shape[2:]) for a in wave0)
        tracer = (torch.arange(cap * n_tracers, device=dev) // cap).repeat(d_bins)
    else:
        k_per = k_photons // n_tracers
        l_idx, rays_per_light = assign_photons_to_lights(lights, k_per)
        pos, direction, energy, bounces = emit(
            lights, field_textures, l_idx.repeat(n_tracers), rays_per_light,
            generator, (height, width), 1.0, override_bounces,
            active_kinds=light_kinds)
        tracer = torch.arange(k_per * n_tracers, device=dev) // k_per
    m = pos.shape[0]
    tracer_offset = tracer * (d_bins * s * s)

    dead = torch.zeros(m, dtype=torch.bool, device=dev)
    all_flat, all_vals = [], []
    for wave in range(max_bounces - 1):
        live = (~dead) & (wave < bounces)
        if wave == 0 and wave0 is not None:
            p_hit, t_esc, found = wave0
        else:
            u_tp = torch.rand((m,), generator=generator, device=dev)
            p_hit, t_esc, found = _flight_rows(fields, pos, direction, live, u_tp)
        dead = dead | (live & ~found)

        # --- material lookup + scatter at the interaction point ---
        gx = torch.floor(p_hit[:, 0]).long().clamp(0, width - 1)
        gy = torch.floor(p_hit[:, 1]).long().clamp(0, height - 1)
        mat = material[gy, gx]
        normal4 = mat[:, :4]
        albedo = mat[:, 4:7]

        rand3 = torch.rand((m, 3), generator=generator, device=dev)
        new_dir, mat_scale, pushback = scatter_materially(
            brdf_lut, normal4, direction, rand3, fast=True,
            enable_brdf=enable_brdf)

        bounced = found[:, None]
        energy = torch.where(bounced, energy * albedo * ((1.0 - t_esc) * mat_scale)[:, None],
                             energy)
        pos = torch.where(bounced, p_hit + pushback + new_dir, pos)
        direction = torch.where(bounced, new_dir, direction)

        # --- record the bounce deposit at the new position ---
        live_next = (~dead) & (wave + 1 < bounces)
        all_flat.append(_deposit_cells(fields, pos, direction) + tracer_offset)
        all_vals.append(torch.where(live_next[:, None], energy, 0.0))
    if not all_flat:
        return (torch.zeros(0, dtype=torch.long, device=dev),
                torch.zeros((0, 3), device=dev))
    return torch.cat(all_flat), torch.cat(all_vals)


def rbt_trace_frame(fields: RotatedFields, src_accum: tuple, gbuffer: GBuffer,
                    lights, field_textures, brdf_lut, generator: torch.Generator,
                    n_photons: int, override_bounces, max_bounces: int = 4,
                    analytic_direct: bool = True, bounce_photons: int = 0,
                    mc_direct: bool = True, enable_brdf: bool = True,
                    light_kinds: tuple | None = None,
                    hist_direct: bool = False,
                    exact_collimated: bool = False,
                    n_tracers: int = 1):
    """Trace one frame's photons; accumulate sources into src_accum IN PLACE
    (the counterpart of the JAX version's donated buffer).

    Returns (src_accum, photons_emitted); src_accum is the per-channel
    source buffer tuple (3 x (n_tracers*D, S, S)). The lightmap itself is
    produced by resolve_raw.

    n_tracers > 1 is the native dual-tracer axis: n_photons and
    bounce_photons are totals split into T independent tracer blocks traced
    in one batch; a tracer only offsets a photon's deposit bin by tr*D in
    the tracer-major source buffer, and each block is normalized by its own
    ray count, so resolve_raw(tracer=t) is distributed like a separate
    tracer with 1/T of the budget. The frame is two decoupled estimator
    phases:

      1. DIRECT: all n photons' wave-0 deposits. analytic_direct injects
         the exact expectation of point lights that analytic_light_mask
         admits; mc_direct samples per-photon deposits, through the stamp
         histogram (hist_direct, all-point scenes) or the generic scatter
         (_mc_scatter_deposits, which skips the analytic lights).
      2. BOUNCE: k = bounce_photons chains (Russian roulette, energy
         renormalized by emission; all n when 0) fly, scatter materially
         and inject wave >= 1 deposits.
    """
    flat, vals, n_emitted = rbt_frame_deposits(
        fields, gbuffer, lights, field_textures, brdf_lut, generator, n_photons,
        override_bounces, max_bounces=max_bounces,
        analytic_direct=analytic_direct, bounce_photons=bounce_photons,
        mc_direct=mc_direct, enable_brdf=enable_brdf,
        light_kinds=light_kinds, hist_direct=hist_direct,
        exact_collimated=exact_collimated, n_tracers=n_tracers)
    if flat is not None:
        src_accum = _inject_flat(src_accum, flat, vals)
    return src_accum, n_emitted


def rbt_frame_deposits(fields: RotatedFields, gbuffer: GBuffer,
                       lights, field_textures, brdf_lut,
                       generator: torch.Generator,
                       n_photons: int, override_bounces, max_bounces: int = 4,
                       analytic_direct: bool = True, bounce_photons: int = 0,
                       mc_direct: bool = True, enable_brdf: bool = True,
                       light_kinds: tuple | None = None,
                       hist_direct: bool = False,
                       exact_collimated: bool = False,
                       n_tracers: int = 1):
    """One frame's photon work WITHOUT the scatter: returns the deposit
    stream (flat_idx, values, photons_emitted), flat_idx indexing the
    flattened (n_tracers*D*S*S) source planes; (None, None, n) when no
    phase deposits. exact_collimated drops the collimated lights' photons
    from the generic Monte-Carlo direct phase: their exact field is added at
    readout (tracers.RBTForwardIntegrator)."""
    height, width = gbuffer.transmissibility.shape
    pixel_count = float(width * height)
    n_emitted = n_photons
    all_flat, all_vals = [], []
    if analytic_direct:
        f, v = _analytic_point_deposits(
            lights, analytic_light_mask(lights, override_bounces), fields,
            pixel_count, n_tracers=n_tracers)
        all_flat.append(f)
        all_vals.append(v)
    if mc_direct:
        if hist_direct:
            f, v, n_emitted = _mc_point_hist_deposits(
                lights, fields, n_photons, generator, override_bounces,
                pixel_count, n_tracers=n_tracers)
        else:
            f, v = _mc_scatter_deposits(
                lights, field_textures, fields, gbuffer, n_photons, generator,
                override_bounces, light_kinds, exclude_analytic=analytic_direct,
                exclude_collimated=exact_collimated, n_tracers=n_tracers)
        all_flat.append(f)
        all_vals.append(v)
    if max_bounces >= 2:
        k = bounce_photons if 0 < bounce_photons < n_photons else n_photons
        stratified = hist_direct or light_kinds == (LIGHT_POINT,)
        f, v = _bounce_chain_deposits(
            fields, gbuffer, lights, field_textures, brdf_lut, generator, k,
            override_bounces, max_bounces, enable_brdf, light_kinds,
            stratified, n_tracers=n_tracers)
        all_flat.append(f)
        all_vals.append(v)
    if not all_flat:
        return None, None, n_emitted
    return torch.cat(all_flat), torch.cat(all_vals), n_emitted


def attenuation_scan(fields: RotatedFields, src_accum: tuple) -> torch.Tensor:
    """Per-row recurrence O[x] = t[x]*O[x-1] + src[x]*sqrt(t[x]) over all
    bins (kernel K1), stacked channel-last: (D, S, S, 3). The JAX version
    takes its Pallas scan on the TPU and an associative scan elsewhere; the
    port takes K1 on every device."""
    return torch.stack(attenuation_scan_rows(fields.trans, *src_accum), dim=-1)


def resolve_raw(fields: RotatedFields, src_accum: tuple, height: int, width: int,
                traced_phase: bool = False, group: int = 0, n_groups: int = 1,
                tracer: int = 0) -> torch.Tensor:
    """Scan + rotate-back -> raw (H, W, 3) deposit map (feed to oracle.to_hdr).

    The attenuation scan (kernel K1) feeds the planar rotate-and-sum
    (kernels K2, K3): channel-planar end to end. This is the port's only
    path, on the card and on the CPU alike; on the CPU the kernels' plain
    versions run. (The JAX package takes it on the TPU and uses a dense
    bilinear rotate elsewhere; `rotate_back_dense` below is that dense path,
    kept as a reference for the tests.)

    group/n_groups resolve only the bins d == group (mod n_groups); the sum
    over all groups equals the full resolve. tracer selects one tracer block
    of a tracer-major (T*D, S, S) source buffer, read in place by the scan.
    traced_phase folds fields.phase into the rotation; without it the bin
    angles are taken at phase 0.
    """
    s, d = fields.size, fields.n_bins
    bins = range(group, d, n_groups)
    dep = attenuation_scan_rows(fields.trans, *src_accum, group=group,
                                n_groups=n_groups, src_offset=tracer * d)
    oy = (s - height) // 2
    ox = (s - width) // 2
    base = tuple(-i * 2.0 * np.pi / d for i in bins)
    max_delta = 2.0 * np.pi / d
    delta = (-fields.phase * max_delta) if traced_phase else 0.0
    lo = (oy // 64) * 64
    hi = min(-(-(oy + height) // 64) * 64, s)
    out = rotate_planar_sum(dep, base, delta, max_delta, lo, hi)
    out = out[:, oy - lo:oy - lo + height, ox:ox + width]
    return out.movedim(0, -1).contiguous()


def rotate_back(fields: RotatedFields, deposited: torch.Tensor,
                height: int, width: int,
                traced_phase: bool = False) -> torch.Tensor:
    """Sum the per-bin rotated deposit maps (D, S, S, C) into the target
    frame (H, W, C): the JAX version's TPU branch on every device, the
    channel-interleaved 3-shear of `rotate_bins` (K2, K3) with the final
    shear fused with the sum over bins and kept to the central 64-aligned
    rows.

    traced_phase takes the bin angles from fields.phase on the device
    (`rotate_bins`, for a per-frame jitter phase or a collimated light's own
    angle); without it they are the phase-0 angles, static
    (`rotate_bins_uniform`). The 3-shear samples with R(+a), so a bin of
    angle theta_d rotates back by a = -theta_d."""
    s, d = fields.size, fields.n_bins
    oy = (s - height) // 2
    ox = (s - width) // 2
    lo = (oy // 64) * 64
    hi = min(-(-(oy + height) // 64) * 64, s)
    if traced_phase:
        angles = -(torch.arange(d, dtype=torch.float32, device=deposited.device)
                   + fields.phase) * (2.0 * np.pi / d)
        rotated = rotate_bins(deposited, angles, reduce_rows=(lo, hi))
    else:
        rotated = rotate_bins_uniform(
            deposited, tuple(-i * 2.0 * np.pi / d for i in range(d)), reduce_rows=(lo, hi))
    return rotated[oy - lo:oy - lo + height, ox:ox + width].contiguous()


def rotate_back_dense(fields: RotatedFields, deposited: torch.Tensor,
                      height: int, width: int,
                      traced_phase: bool = False) -> torch.Tensor:
    """Dense rotate-back: sample every bin's (S, S, C) deposit map at the
    target pixels with a bilinear gather and sum over bins. Plain PyTorch:
    a second reference for resolve_raw in the tests, and the dense branch
    of parallel/'s bin-slice resolve (S not a multiple of 128, or fewer
    than 8 bins a rank).

    traced_phase has the JAX package's dense-path meaning, which is none:
    fields.cos/sin already fold the phase in, so the result is the same
    either way."""
    s = fields.size
    dev = deposited.device
    ys, xs = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    p = torch.stack([xs + 0.5, ys + 0.5], -1).reshape(-1, 2).float()
    rel = p - fields.center
    total = torch.zeros((height * width, deposited.shape[-1]), device=dev)
    for dep_d, cb, sb in zip(deposited, fields.cos, fields.sin):
        xr = cb * rel[:, 0] + sb * rel[:, 1] + s / 2.0
        yr = -sb * rel[:, 0] + cb * rel[:, 1] + s / 2.0
        total += gather_bilinear(dep_d, torch.stack([xr, yr], -1))
    return total.reshape(height, width, -1)
