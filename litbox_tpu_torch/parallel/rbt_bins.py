"""The RBT with fields, sources and resolve sharded over the bin axis
(counterpart of the JAX package's parallel/rbt_bins.py).

`rbt_sharded.py` scales throughput: every rank holds the full fields and
sources. This module scales resolution: rank i of the mesh's 'shard'
dimension owns the bins [i*D/n, (i+1)*D/n), so its field and source memory
is D/n of the whole.

  * every large (D, ...) tensor (trans, cum_log, cum_coarse, the sources)
    holds the rank's D/n bins; cos, sin, center and phase are replicated
  * DIRECT (the stratified point-light histogram): photons are assigned to
    bins by construction, so each rank emits and deposits only its own bins
  * BOUNCE waves: a scattered photon's bin is arbitrary, so its free flight
    needs cum_log rows another rank may own. Records are bucketed by owner
    and exchanged with one all-to-all (`_a2a_flight`), flown by the owner
    and sent home with a second; the forward-scattered majority that stays
    in the rank's own bins flies at home. Deposits are exchanged the same
    way (`_a2a_scatter`). The ring versions (`_ring_flight`,
    `_ring_scatter`: n hops of send to the next rank, receive from the
    previous) are kept as the exact ablation (use_ring=True).
  * RESOLVE: each rank resolves its bins (K1, then K2 and K3), and one
    (H, W, 3) all-reduce sums them.

Random numbers follow the port's unsharded frame exactly: every rank of an
ensemble row draws the full-shape uniforms from the row's generator, in the
order sim/rbt.py's rbt_frame_deposits draws them, and keeps its own rows. So
row e equals the unsharded rbt_trace_frame(hist_direct=True) + resolve_raw
on derive_generator(generator, e, E), to the float rounding of the
scatter-add order.

The all-to-all buckets have a static capacity W (`_a2a_capacity`): records
past it are dropped and counted (the returned overflow, 0 in any sane
configuration).

Scope: point-light scenes with the histogram direct pass and stratified
bounce chains (the production realtime scene class).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..core.types import GBuffer, affine_linear
from ..sim.emission import (assign_photons_to_lights, effective_bounces,
                            emit_point_stratified, take_per_light)
from ..sim.materials import TWO_PI, scatter_materially, unit_from_angle
from ..sim.rbt import (ANALYTIC_STAMP, RotatedFields, _deposit_cells,
                       _direction_bins, _flight_gathered, _rotated_coords)
from . import world
from .rbt_sharded import resolve_bin_slice


def make_bins_mesh(n_devices: int | None = None, ensemble: int = 1):
    """Mesh ('ensemble', 'shard') over the first n ranks: dual-tracer rows
    by bin-slice columns. Every rank of the world calls it."""
    n = n_devices or dist.get_world_size()
    if n % ensemble:
        raise ValueError(f"{n} devices not divisible by ensemble={ensemble}")
    return world.build_mesh(n, (ensemble, n // ensemble), ("ensemble", "shard"))


@dataclasses.dataclass(frozen=True)
class BinShardedFields:
    """RotatedFields with the large arrays holding this rank's D/n bins.

    cos/sin/center/phase are full, so any rank can do the angle math of any
    global bin."""

    cos: torch.Tensor         # (D,) replicated
    sin: torch.Tensor         # (D,) replicated
    trans: torch.Tensor       # (D/n, S, S) this rank's bins
    cum_log: torch.Tensor     # (D/n, S, S)
    cum_coarse: torch.Tensor  # (D/n, S, S/COARSE)
    center: torch.Tensor      # (2,)
    phase: torch.Tensor       # ()

    @property
    def n_bins(self) -> int:
        return self.cos.shape[0]

    @property
    def size(self) -> int:
        return self.trans.shape[-1]


def shard_fields_bins(mesh, fields: RotatedFields) -> BinShardedFields:
    """This rank's bins of a full RotatedFields (copies, so the full fields
    can be dropped after): (D/n) * S * S * (2 + 1/COARSE) floats a rank."""
    _, n, i = world.axis(mesh, "shard")
    d = fields.n_bins
    if d % n:
        raise ValueError(f"{d} bins do not divide over {n} ranks")
    dl = d // n
    mine = lambda a: a[i * dl:(i + 1) * dl].clone()  # noqa: E731
    return BinShardedFields(
        cos=fields.cos, sin=fields.sin, trans=mine(fields.trans),
        cum_log=mine(fields.cum_log), cum_coarse=mine(fields.cum_coarse),
        center=fields.center, phase=fields.phase)


def zero_sources_bins(mesh, fields: BinShardedFields) -> tuple:
    """This rank's source buffers: 3 x (D/n, S, S) zeros."""
    return tuple(torch.zeros_like(fields.trans) for _ in range(3))


def _hist_direct_local(lights, fields: BinShardedFields, bin_lo: int,
                       d_local: int, n_photons: int,
                       generator: torch.Generator, override_bounces,
                       pixel_count: float):
    """The local-bin slice of sim.rbt._mc_point_hist_deposits (one tracer).

    Draws the full (D, cap, 2) uniforms from `generator`, as the unsharded
    function does, and keeps the rows [bin_lo, bin_lo + d_local); energy
    divides by the GLOBAL ray count cap * D, so the streams of all ranks,
    concatenated in rank order, are the unsharded stream with its cells
    re-indexed to local bins. Counts are an integer scatter_add_ histogram.
    Returns (flat_local, values, n_emitted)."""
    d_bins, s = fields.n_bins, fields.size
    dev = fields.trans.device
    capacity = lights.capacity
    stamp = ANALYTIC_STAMP
    cap = -(-n_photons // d_bins)
    n_emitted = cap * d_bins

    l_of_slot, slots = assign_photons_to_lights(lights, cap)
    l_slot = l_of_slot.long()
    aff = take_per_light(lights.affine, l_of_slot)             # (cap, 2, 3)
    rel_slot = aff[:, :, 2] - fields.center

    u = torch.rand((d_bins, cap, 2), generator=generator, device=dev)
    u = u[bin_lo:bin_lo + d_local]
    disk = unit_from_angle(u[..., 0] * TWO_PI) * torch.sqrt(u[..., 1])[..., None]
    off = affine_linear(aff[None], disk)                       # (Dl, cap, 2)

    relc = lights.affine[:, :, 2] - fields.center              # (L, 2)
    cb = fields.cos[bin_lo:bin_lo + d_local, None]             # (Dl, 1)
    sb = fields.sin[bin_lo:bin_lo + d_local, None]
    cxl = cb * relc[None, :, 0] + sb * relc[None, :, 1] + s / 2.0
    cyl = -sb * relc[None, :, 0] + cb * relc[None, :, 1] + s / 2.0
    axl = (torch.floor(cxl).long() - stamp // 2).clamp(0, s - stamp)
    ayl = (torch.floor(cyl).long() - stamp // 2).clamp(0, s - stamp)

    xr = (cb * rel_slot[None, :, 0] + sb * rel_slot[None, :, 1] + s / 2.0
          + cb * off[..., 0] + sb * off[..., 1])
    yr = (-sb * rel_slot[None, :, 0] + cb * rel_slot[None, :, 1] + s / 2.0
          - sb * off[..., 0] + cb * off[..., 1])
    lx = (torch.floor(xr).long() - axl[:, l_slot]).clamp(0, stamp - 1)
    ly = (torch.floor(yr).long() - ayl[:, l_slot]).clamp(0, stamp - 1)
    n_cells = capacity * stamp * stamp
    col = (torch.arange(d_local, device=dev)[:, None] * n_cells
           + (l_slot * (stamp * stamp))[None] + ly * stamp + lx)
    counts = torch.zeros(d_local * n_cells, dtype=torch.long, device=dev)
    counts.scatter_add_(0, col.reshape(-1), torch.ones_like(col).reshape(-1))
    counts = counts.float().reshape(d_local, capacity, stamp * stamp)

    bounces_l = effective_bounces(lights.bounces, override_bounces)
    rays_l = torch.clamp(slots * d_bins, min=1).float()       # GLOBAL
    e_l = (lights.energy * (pixel_count / TWO_PI) / rays_l[:, None]
           * lights.active.float()[:, None]
           * (bounces_l > 0).float()[:, None])                 # (L, 3)
    vals = counts[..., None] * e_l[None, :, None, :]           # (Dl, L, c, 3)

    o = torch.arange(stamp, device=dev)
    gy = ayl[:, :, None, None] + o[None, None, :, None]
    gx = axl[:, :, None, None] + o[None, None, None, :]
    flat = ((torch.arange(d_local, device=dev)[:, None, None, None] * s + gy) * s
            + gx)                                              # LOCAL bins
    return flat.reshape(-1), vals.reshape(-1, 3), n_emitted


def _flight_stratified_local(fields: BinShardedFields, cum_local: torch.Tensor,
                             bin_lo: int, pos: torch.Tensor, live: torch.Tensor,
                             u_tp: torch.Tensor):
    """Wave-0 flight of a stratified (D/n, cap) block over the local bins:
    sim.rbt._flight_stratified with the block's cos/sin sliced from the
    replicated vectors and its rows gathered from the local cum_log."""
    s = fields.size
    d_local = cum_local.shape[0]
    cb = fields.cos[bin_lo:bin_lo + d_local, None]
    sb = fields.sin[bin_lo:bin_lo + d_local, None]
    xr, yr = _rotated_coords(fields, pos, cb, sb)              # (Dl, cap)
    iy = torch.floor(yr).long().clamp(0, s - 1)
    bins = torch.arange(d_local, device=pos.device)[:, None]
    hit_x, t_esc, found = _flight_gathered(
        cum_local.view(-1, s), (bins * s + iy).reshape(-1), xr.reshape(-1),
        u_tp.reshape(-1), live.reshape(-1))
    hit_x, t_esc, found = (a.reshape(xr.shape) for a in (hit_x, t_esc, found))
    return _hit_point(fields, hit_x, yr, cb, sb), t_esc, found


def _hit_point(fields, hit_x, yr, cb, sb) -> torch.Tensor:
    """Bin-frame hit column (and row yr) -> target-frame position."""
    s = fields.size
    hx = hit_x - s / 2.0
    hy = yr - s / 2.0
    return torch.stack([cb * hx - sb * hy, sb * hx + cb * hy], -1) + fields.center


def _ring_shift(tensors: tuple, shard: tuple) -> tuple:
    """Send each tensor to the next rank of the shard ring, receive the
    previous rank's (the counterpart of ppermute i -> i + 1)."""
    group, n, i = shard
    peers = dist.get_process_group_ranks(group)
    sent = [t.contiguous() for t in tensors]
    got = [torch.empty_like(t) for t in sent]
    ops = []
    for t, o in zip(sent, got):
        ops.append(dist.P2POp(dist.isend, t, peers[(i + 1) % n], group))
        ops.append(dist.P2POp(dist.irecv, o, peers[(i - 1) % n], group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return tuple(got)


def _ring_flight(fields: BinShardedFields, cum_local: torch.Tensor,
                 pos: torch.Tensor, direction: torch.Tensor, live: torch.Tensor,
                 u_tp: torch.Tensor, shard: tuple):
    """Free flight with arbitrary directions over bin-sharded cum_log: the
    angle math is done at home, then the (row query, accumulator) records
    ride the ring; each hop flies the arriving records whose bin is local.
    After n hops every record has flown once and is home."""
    _, n, i = shard
    s = fields.size
    d_local = cum_local.shape[0]
    bin_lo = i * d_local
    table = cum_local.view(-1, s)
    b, cb, sb = _direction_bins(fields, direction)
    xr, yr = _rotated_coords(fields, pos, cb, sb)
    iy = torch.floor(yr).long().clamp(0, s - 1)

    zeros = torch.zeros_like(xr)
    ints = torch.stack([b, iy], -1)
    # xr, u, live, hit_x, t_esc, found: the bools ride as exact 0/1 floats.
    flts = torch.stack([xr, u_tp, live.float(), zeros, zeros, zeros], -1)
    for _ in range(n):
        b_c, iy_c = ints.unbind(-1)
        xr_c, u_c, live_c, hx_c, te_c, fd_c = flts.unbind(-1)
        local = (live_c > 0.5) & (b_c >= bin_lo) & (b_c < bin_lo + d_local)
        lb = (b_c - bin_lo).clamp(0, d_local - 1)
        hx_s, te_s, fd_s = _flight_gathered(table, lb * s + iy_c, xr_c, u_c, local)
        hx_c = torch.where(local, hx_s, hx_c)
        te_c = torch.where(local, te_s, te_c)
        fd_c = ((fd_c > 0.5) | fd_s).float()
        flts = torch.stack([xr_c, u_c, live_c, hx_c, te_c, fd_c], -1)
        ints, flts = _ring_shift((ints, flts), shard)
    return _hit_point(fields, flts[:, 3], yr, cb, sb), flts[:, 4], flts[:, 5] > 0.5


def _a2a_capacity(m: int, n: int, slack: float = 4.0) -> int:
    """Static per-destination bucket capacity W for m records over n ranks:
    slack * m / n rounded up to a multiple of 8 and capped at m rounded up
    (one sender cannot send more than its m records, so W >= m is always
    exact). A rank exchanges and flies n * W ~= slack * m lanes, with m
    itself proportional to D/n.

    With near-uniform scattered directions bucket counts are about
    Binomial(m, 1/n), and slack=4 makes overflow astronomically unlikely;
    mirror-dominated scenes correlate the directions (a rank's whole block
    can reflect into one bucket): raise slack toward n when the overflow
    count says so."""
    return max(8, min(int(-(-slack * m // (8 * n)) * 8),
                      int(-(-m // 8) * 8)))


def _bucket_by_owner(owner: torch.Tensor, n: int, w: int, active: torch.Tensor):
    """Stable bucketing of the ACTIVE records by destination rank.

    Record j goes to payload slot owner[j] * w + (its rank within its
    bucket) when kept (active and rank < w), else to the sentinel slot n*w
    (payloads are built n*w + 1 long and cut back to n*w). Inactive records
    are excluded from the ranking, so they never take bucket capacity. A
    stable argsort, a searchsorted of the bucket starts and each record's
    offset from its start. Returns (slot, keep)."""
    m = owner.shape[0]
    dev = owner.device
    key = torch.where(active, owner, n)
    order = torch.argsort(key, stable=True)
    sorted_key = key[order]
    starts = torch.searchsorted(sorted_key, torch.arange(n + 1, device=dev,
                                                         dtype=sorted_key.dtype))
    rank = torch.empty_like(sorted_key)
    rank[order] = torch.arange(m, device=dev) - starts[sorted_key]
    keep = active & (rank < w)
    slot = torch.where(keep, owner * w + rank, n * w)
    return slot, keep


def _pack(x: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
          size: int) -> torch.Tensor:
    """Payload of `size` rows: kept record j at row slot[j], zeros elsewhere.
    Dropped records all write the sentinel row `size`, which is cut off, so
    their duplicate writes do not matter."""
    buf = torch.zeros((size + 1,) + x.shape[1:], dtype=x.dtype, device=x.device)
    mask = keep.view((-1,) + (1,) * (x.ndim - 1))
    buf.index_put_((slot,), torch.where(mask, x, torch.zeros_like(x)))
    return buf[:size]


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    """all_to_all_single with equal splits: block j of x (rows j*W..) goes to
    rank j of the group; block j of the result came from rank j."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _count_overflow(lost: torch.Tensor, group) -> torch.Tensor:
    n_lost = lost.sum().reshape(1)
    dist.all_reduce(n_lost, dist.ReduceOp.SUM, group=group)
    return n_lost[0]


def _a2a_flight(fields: BinShardedFields, cum_local: torch.Tensor,
                pos: torch.Tensor, direction: torch.Tensor, live: torch.Tensor,
                u_tp: torch.Tensor, shard: tuple, slack: float = 4.0):
    """Free flight with arbitrary directions through one all-to-all each
    way: records whose bin another rank owns are bucketed by owner, sent as
    (owner-local row, column, distance draw, live), flown there, and their
    (hit column, escape transmittance, found) sent home. Records of the
    rank's own bins (the forward-scattered majority) fly at home, outside
    the exchange. Returns (p_hit, t_esc, found, overflow): overflowed
    records do not fly this wave and are counted over the shard group."""
    group, n, i = shard
    s = fields.size
    d_local = cum_local.shape[0]
    table = cum_local.view(-1, s)
    b, cb, sb = _direction_bins(fields, direction)
    xr, yr = _rotated_coords(fields, pos, cb, sb)
    iy = torch.floor(yr).long().clamp(0, s - 1)

    m = pos.shape[0]
    w = _a2a_capacity(m, n, slack)
    owner = b // d_local
    row = (b - owner * d_local) * s + iy                       # in the owner's table
    home = live & (owner == i)
    hx_home, te_home, fd_home = _flight_gathered(table, row, xr, u_tp, home)

    foreign = live & (owner != i)
    slot, keep = _bucket_by_owner(owner, n, w, foreign)
    overflow = _count_overflow(foreign & ~keep, group)
    r_row = _exchange(_pack(row, slot, keep, n * w), group)
    r_f = _exchange(_pack(torch.stack([xr, u_tp, keep.float()], -1), slot, keep, n * w),
                    group)
    hit_x, t_esc, found = _flight_gathered(table, r_row, r_f[:, 0], r_f[:, 1],
                                           r_f[:, 2] > 0.5)
    back = _exchange(torch.stack([hit_x, t_esc, found.float()], -1), group)
    got = back[slot.clamp(max=n * w - 1)]
    hit_x = torch.where(home, hx_home, torch.where(keep, got[:, 0], 0.0))
    t_esc = torch.where(home, te_home, torch.where(keep, got[:, 1], 0.0))
    found = torch.where(home, fd_home, keep & (got[:, 2] > 0.5))
    return _hit_point(fields, hit_x, yr, cb, sb), t_esc, found, overflow


def _a2a_scatter(src_local: tuple, flat_global: torch.Tensor, vals: torch.Tensor,
                 d_local: int, s: int, shard: tuple, slack: float = 4.0):
    """Deposit global-bin records through one all-to-all: records go to the
    rank owning their cell, which adds them with one local index_add_ a
    channel; the rank's own records skip the exchange. Adds IN PLACE.
    Returns (src_local, overflow)."""
    group, n, i = shard
    span = d_local * s * s
    w = _a2a_capacity(flat_global.shape[0], n, slack)
    owner = (flat_global // span).clamp(0, n - 1)
    live = (vals != 0.0).any(-1)
    home = live & (owner == i)
    idx_home = torch.where(home, flat_global - i * span, 0)
    val_home = torch.where(home[:, None], vals, 0.0)

    foreign = live & (owner != i)
    slot, keep = _bucket_by_owner(owner, n, w, foreign)
    overflow = _count_overflow(foreign & ~keep, group)
    r_idx = _exchange(_pack(flat_global - owner * span, slot, keep, n * w), group)
    r_val = _exchange(_pack(vals, slot, keep, n * w), group)
    for c, ch in enumerate(src_local):
        ch.view(-1).index_add_(0, idx_home, val_home[:, c].contiguous())
        ch.view(-1).index_add_(0, r_idx, r_val[:, c].contiguous())
    return src_local, overflow


def _ring_scatter(src_local: tuple, flat_global: torch.Tensor, vals: torch.Tensor,
                  d_local: int, s: int, shard: tuple) -> tuple:
    """Deposit global-bin records into bin-sharded sources: the record
    stream rides the ring once and each rank adds the records of its slice
    as they pass. IN PLACE."""
    _, n, i = shard
    span = d_local * s * s
    lo = i * span
    state = (flat_global, vals)
    for _ in range(n):
        flat_c, vals_c = state
        sel = (flat_c >= lo) & (flat_c < lo + span)
        idx = torch.where(sel, flat_c - lo, 0)
        for c, ch in enumerate(src_local):
            ch.view(-1).index_add_(0, idx, torch.where(sel, vals_c[:, c], 0.0))
        state = _ring_shift(state, shard)
    return src_local


def bins_trace_frame(mesh, fields: BinShardedFields, src: tuple,
                     gbuffer: GBuffer, lights, brdf_lut,
                     generator: torch.Generator, n_photons: int, override_bounces,
                     max_bounces: int = 4, bounce_photons: int = 0,
                     enable_brdf: bool = True, use_ring: bool = False,
                     a2a_slack: float = 4.0):
    """Trace one frame into this rank's bin-sharded sources, IN PLACE:
    point lights, the histogram direct pass and stratified bounce chains
    (sim.rbt.rbt_trace_frame with hist_direct=True, analytic_direct=False),
    re-partitioned over the 'shard' dimension.

    Ensemble row e draws from derive_generator(generator, e, E), the
    counterpart of fold_in(key, e), in the unsharded frame's order: the
    histogram's (D, cap, 2), emit_point_stratified's (D, cap_b, 3), wave 0's
    distance draws (D, cap_b), then each wave's (D*cap_b,) distance draws
    (waves >= 1) and (D*cap_b, 3) scatter draws; each rank keeps its rows.
    The material lookup is the nearest texel, as in the unsharded frame.

    Returns (src, photons_emitted (E,), overflow (E,)): overflow is each
    row's count of bounce records that exceeded the all-to-all capacity
    this frame (always 0 with use_ring=True, the exact ring ablation)."""
    g_ens, e, e_idx = world.axis(mesh, "ensemble")
    shard = world.axis(mesh, "shard")
    _, n, i = shard
    d_bins, s = fields.n_bins, fields.size
    d_local = fields.trans.shape[0]
    if d_local * n != d_bins:
        raise ValueError(f"fields hold {d_local} bins a rank, not {d_bins} / {n}")
    height, width = gbuffer.transmissibility.shape
    dev = fields.trans.device
    bin_lo = i * d_local
    gen = world.derive_generator(generator, e_idx, e)
    material = torch.cat([gbuffer.normal, gbuffer.albedo[..., :3]], -1)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)

    # DIRECT: the stratified histogram of the local bins.
    flat, vals, n_emitted = _hist_direct_local(
        lights, fields, bin_lo, d_local, n_photons, gen, override_bounces,
        float(width * height))
    for c, ch in enumerate(src):
        ch.view(-1).index_add_(0, flat, vals[:, c].contiguous())

    # BOUNCE chains (sim.rbt._bounce_chain_deposits, stratified).
    all_flat, all_vals = [], []
    if max_bounces >= 2:
        k_chains = bounce_photons if 0 < bounce_photons < n_photons else n_photons
        cap = -(-k_chains // d_bins)
        l_of_slot, slots = assign_photons_to_lights(lights, cap)
        pos, direction, energy, bounces = emit_point_stratified(
            lights, l_of_slot, slots, d_bins, fields.phase, gen, (height, width),
            1.0, override_bounces)
        u_tp0 = torch.rand(bounces.shape, generator=gen, device=dev)
        rows = slice(bin_lo, bin_lo + d_local)
        pos, direction, energy, bounces, u_tp0 = (
            a[rows] for a in (pos, direction, energy, bounces, u_tp0))
        wave0 = _flight_stratified_local(fields, fields.cum_log, bin_lo, pos,
                                         bounces > 0, u_tp0)
        m = d_local * cap
        pos, direction, energy, bounces = (
            a.reshape((m,) + a.shape[2:]) for a in (pos, direction, energy, bounces))
        wave0 = tuple(a.reshape((m,) + a.shape[2:]) for a in wave0)
        m_full, row0 = d_bins * cap, bin_lo * cap

        dead = torch.zeros(m, dtype=torch.bool, device=dev)
        for wave in range(max_bounces - 1):
            live = (~dead) & (wave < bounces)
            if wave == 0:
                p_hit, t_esc, found = wave0
            else:
                u_tp = torch.rand((m_full,), generator=gen, device=dev)[row0:row0 + m]
                if use_ring:
                    p_hit, t_esc, found = _ring_flight(
                        fields, fields.cum_log, pos, direction, live, u_tp, shard)
                else:
                    p_hit, t_esc, found, ovf = _a2a_flight(
                        fields, fields.cum_log, pos, direction, live, u_tp, shard,
                        slack=a2a_slack)
                    overflow = overflow + ovf
            dead = dead | (live & ~found)

            gx = torch.floor(p_hit[:, 0]).long().clamp(0, width - 1)
            gy = torch.floor(p_hit[:, 1]).long().clamp(0, height - 1)
            mat = material[gy, gx]
            rand3 = torch.rand((m_full, 3), generator=gen, device=dev)[row0:row0 + m]
            new_dir, mat_scale, pushback = scatter_materially(
                brdf_lut, mat[:, :4], direction, rand3, fast=True,
                enable_brdf=enable_brdf)
            bounced = found[:, None]
            energy = torch.where(
                bounced, energy * mat[:, 4:7] * ((1.0 - t_esc) * mat_scale)[:, None],
                energy)
            pos = torch.where(bounced, p_hit + pushback + new_dir, pos)
            direction = torch.where(bounced, new_dir, direction)

            live_next = (~dead) & (wave + 1 < bounces)
            all_flat.append(_deposit_cells(fields, pos, direction))
            all_vals.append(torch.where(live_next[:, None], energy, 0.0))

    if all_flat:
        flat, vals = torch.cat(all_flat), torch.cat(all_vals)
        if use_ring:
            _ring_scatter(src, flat, vals, d_local, s, shard)
        else:
            _, ovf = _a2a_scatter(src, flat, vals, d_local, s, shard, slack=a2a_slack)
            overflow = overflow + ovf
    emitted = torch.full((1,), n_emitted, dtype=torch.int64, device=dev)
    return (src, world.gather_rows(emitted, g_ens)[:, 0],
            world.gather_rows(overflow.reshape(1), g_ens)[:, 0])


def bins_resolve(mesh, fields: BinShardedFields, src: tuple, height: int,
                 width: int) -> torch.Tensor:
    """Resolve bin-sharded sources: each rank scans and rotates back its
    D/n bins (K1, then K2 and K3), one (H, W, 3) all-reduce sums them.
    Returns (E, H, W, 3) on every rank."""
    g_ens, _, _ = world.axis(mesh, "ensemble")
    group, _, i = world.axis(mesh, "shard")
    d_local = fields.trans.shape[0]
    partial = resolve_bin_slice(fields, fields.trans, src, i * d_local, height, width)
    dist.all_reduce(partial, dist.ReduceOp.SUM, group=group)
    return world.gather_rows(partial, g_ens)
