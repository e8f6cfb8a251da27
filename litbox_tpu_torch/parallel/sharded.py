"""The oracle tracer, data-parallel over photons (counterpart of the JAX
package's parallel/sharded.py).

  * photon batch -> the mesh's 'data' dimension: every rank traces an
    independent sub-batch with its own generator
  * ensemble (the dual-tracer variance pair) -> the 'ensemble' dimension
  * lightmaps -> averaged over 'data' with one all-reduce per frame, then
    gathered over 'ensemble' so every rank returns the (E, H, W, 3) maps
  * GBuffer, scene -> replicated (small)

Each rank's estimate carries energy normalized to its own photon count, so
the combine over 'data' is a mean.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.types import GBuffer
from ..sim.oracle import trace_frame
from . import world


def make_mesh(n_devices: int | None = None, ensemble: int = 1):
    """Mesh ('ensemble', 'data') over the first n ranks (all by default).
    Every rank of the world calls it. Raises ValueError when n is not a
    multiple of `ensemble`."""
    n = n_devices or dist.get_world_size()
    if n % ensemble:
        raise ValueError(f"{n} devices not divisible by ensemble={ensemble}")
    return world.build_mesh(n, (ensemble, n // ensemble), ("ensemble", "data"))


def sharded_trace_frame(mesh, gbuffer: GBuffer, lights, field_textures,
                        brdf_lut, generator: torch.Generator, n_photons: int,
                        interval: float, override_bounces,
                        max_bounces: int = 4, bilinear: bool = True):
    """Trace `n_photons` on this rank with the oracle march; average the
    lightmaps over 'data', keep the 'ensemble' rows apart.

    Rank (e, i) traces with derive_generator(generator, e * d + i, E * d),
    the counterpart of jax.random.split(key, E * d). Returns (raw
    (E, H, W, 3), writes (E,)) on every rank of the mesh: one lightmap and
    one deposit count (summed over 'data') per ensemble row."""
    g_ens, _, e_idx = world.axis(mesh, "ensemble")
    g_data, d, d_idx = world.axis(mesh, "data")
    e = world.mesh_shape(mesh)["ensemble"]
    gen = world.derive_generator(generator, e_idx * d + d_idx, e * d)
    raw, writes = trace_frame(gbuffer, lights, field_textures, brdf_lut, gen,
                              n_photons, interval, override_bounces,
                              max_bounces=max_bounces, bilinear=bilinear)
    dist.all_reduce(raw, dist.ReduceOp.AVG, group=g_data)
    dist.all_reduce(writes, dist.ReduceOp.SUM, group=g_data)
    return world.gather_rows(raw, g_ens), world.gather_rows(writes, g_ens)
