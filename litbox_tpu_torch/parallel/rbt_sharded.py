"""The production RBT engine, data-parallel (counterpart of the JAX
package's parallel/rbt_sharded.py).

  * photon batch -> the mesh's 'data' dimension: every rank traces an
    independent full estimate of the frame into its OWN source buffers
    (3 x (D, S, S)); accumulation is linear, so nothing crosses ranks
    while tracing and frames accumulate locally
  * dual-tracer pair -> the 'ensemble' dimension
  * resolve -> either every rank resolves its own sources and the small
    (H, W, 3) lightmaps are averaged over 'data' (`sharded_rbt_resolve`;
    mean(resolve(s_i)) == resolve(mean(s_i)) by linearity), or the sources
    are reduce-scattered over the bin axis and each rank resolves D/n bins
    (`sharded_rbt_resolve_bins`)
  * fields, GBuffer, scene -> replicated

The bin-slice resolve (`resolve_bin_slice`, shared with rbt_bins.py) runs
the kernel K1 and then `rotate_bins` (K2, K3) whenever S is a multiple of
128 and the slice holds at least 8 bins, on every device; otherwise the
plain dense branch (the plain scan, then a bilinear gather per bin), as
the JAX version off the TPU.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from ..core.types import GBuffer
from ..ops.attnscan import attenuation_scan_rows, attenuation_scan_rows_plain
from ..ops.rotate import rotate_bins
from ..sim.rbt import RotatedFields, rbt_trace_frame, resolve_raw, rotate_back_dense
from . import world


def zero_sources_sharded(mesh, fields: RotatedFields) -> tuple:
    """This rank's source buffers: 3 x (D, S, S) zeros on the fields'
    device (the JAX version's (E, Dd, 3, D, S, S) block of one device)."""
    d, s = fields.n_bins, fields.size
    return tuple(torch.zeros((d, s, s), device=fields.trans.device) for _ in range(3))


def sharded_rbt_trace_frame(mesh, fields: RotatedFields, src: tuple,
                            gbuffer: GBuffer, lights, field_textures, brdf_lut,
                            generator: torch.Generator, n_photons: int,
                            override_bounces, max_bounces: int = 4,
                            analytic_direct: bool = True, bounce_photons: int = 0,
                            mc_direct: bool = True, enable_brdf: bool = True,
                            light_kinds: tuple | None = None):
    """Trace `n_photons` on this rank into its own sources, IN PLACE.

    No collective touches the sources. Rank (e, i) traces with
    derive_generator(generator, e * d + i, E * d). Returns (src,
    photons_emitted (E,)): the photons of each ensemble row, summed over
    'data'."""
    g_ens, _, e_idx = world.axis(mesh, "ensemble")
    g_data, d, d_idx = world.axis(mesh, "data")
    e = world.mesh_shape(mesh)["ensemble"]
    gen = world.derive_generator(generator, e_idx * d + d_idx, e * d)
    src, n = rbt_trace_frame(
        fields, src, gbuffer, lights, field_textures, brdf_lut, gen, n_photons,
        override_bounces, max_bounces=max_bounces, analytic_direct=analytic_direct,
        bounce_photons=bounce_photons, mc_direct=mc_direct,
        enable_brdf=enable_brdf, light_kinds=light_kinds)
    n = torch.full((1,), n, dtype=torch.int64, device=fields.trans.device)
    dist.all_reduce(n, dist.ReduceOp.SUM, group=g_data)
    return src, world.gather_rows(n, g_ens)[:, 0]


def sharded_rbt_resolve(mesh, fields: RotatedFields, src: tuple,
                        height: int, width: int) -> torch.Tensor:
    """resolve_raw of this rank's sources (K1 -> K2 -> K3), averaged over
    'data'. Returns (E, H, W, 3) on every rank: one lightmap per ensemble
    row (the dual-tracer pair)."""
    g_ens, _, _ = world.axis(mesh, "ensemble")
    g_data, _, _ = world.axis(mesh, "data")
    raw = resolve_raw(fields, src, height, width)
    dist.all_reduce(raw, dist.ReduceOp.AVG, group=g_data)
    return world.gather_rows(raw, g_ens)


def resolve_bin_slice(fields, trans: torch.Tensor, src: tuple, bin_lo: int,
                      height: int, width: int) -> torch.Tensor:
    """The (H, W, 3) partial lightmap of the bins [bin_lo, bin_lo + Dl):
    scan the slice's rows, rotate each bin back by its angle
    theta_d = (d + phase) * 2pi / D and sum. `fields` (full or
    bin-sharded) gives D, the phase and the center; trans and src hold the
    slice's Dl bins.

    Kernel branch (S % 128 == 0 and Dl >= 8): K1, then rotate_bins(
    deposited, -theta, reduce_rows) (K2 on channel-interleaved rows, K3
    fused with the sum over the slice), as the JAX version on the TPU.
    Otherwise the plain scan and sim.rbt.rotate_back_dense at the slice's
    angles, as the JAX version elsewhere."""
    d_local, s, _ = trans.shape
    bins = bin_lo + torch.arange(d_local, dtype=torch.float32, device=trans.device)
    theta = (bins + fields.phase) * (2.0 * math.pi / fields.n_bins)
    if s % 128 == 0 and d_local >= 8:
        deposited = torch.stack(attenuation_scan_rows(trans, *src), dim=-1)
        oy = (s - height) // 2
        ox = (s - width) // 2
        lo = (oy // 64) * 64
        hi = min(-(-(oy + height) // 64) * 64, s)
        rotated = rotate_bins(deposited, -theta, reduce_rows=(lo, hi))
        return rotated[oy - lo:oy - lo + height, ox:ox + width].contiguous()
    deposited = torch.stack(attenuation_scan_rows_plain(trans, *src), dim=-1)
    at_slice = dataclasses.replace(fields, cos=torch.cos(theta), sin=torch.sin(theta),
                                   trans=trans)
    return rotate_back_dense(at_slice, deposited, height, width)


def sharded_rbt_resolve_bins(mesh, fields: RotatedFields, src: tuple,
                             height: int, width: int) -> torch.Tensor:
    """Bin-sharded resolve: each rank resolves D/n bins of the mean
    sources.

      1. reduce-scatter the ranks' sources over 'data' along the bin axis:
         rank i ends with the sum, divided by n, of every rank's sources
         for its contiguous bins [i*D/n, (i+1)*D/n);
      2. resolve_bin_slice of those bins (K1, then K2 and K3);
      3. sum the (H, W, 3) partial lightmaps over 'data'.

    By linearity this equals sharded_rbt_resolve to float rounding, with
    1/n of the resolve's work a rank. Returns (E, H, W, 3) on every rank."""
    g_ens, _, _ = world.axis(mesh, "ensemble")
    g_data, n, i = world.axis(mesh, "data")
    d_total, s = fields.n_bins, fields.size
    if d_total % n:
        raise ValueError(f"{d_total} bins do not divide over {n} ranks")
    d_local = d_total // n
    # reduce_scatter_tensor scatters the leading axis, so the input is laid
    # out with the bin blocks leading, (n, 3, D/n, S, S): one copy of the
    # 3*D*S*S sources. Both sides go flat over their leading axes.
    blocks = torch.empty((n, 3, d_local, s, s), device=src[0].device)
    for c in range(3):
        blocks[:, c] = src[c].view(n, d_local, s, s)
    mine = torch.empty((3, d_local, s, s), device=src[0].device)
    dist.reduce_scatter_tensor(mine.view(-1, s), blocks.view(-1, s), dist.ReduceOp.SUM,
                               group=g_data)
    del blocks
    mine /= n
    trans = fields.trans[i * d_local:(i + 1) * d_local]
    partial = resolve_bin_slice(fields, trans, tuple(mine), i * d_local, height, width)
    dist.all_reduce(partial, dist.ReduceOp.SUM, group=g_data)
    return world.gather_rows(partial, g_ens)
