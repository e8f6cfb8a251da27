"""Rank bodies of tests/test_torch_parallel.py and
tests/test_torch_parallel_train.py.

Each test module starts one gloo world through litbox_tpu_torch.parallel.
world.run and runs all of its cases in it; a spawned rank imports this
module by name, so it imports neither JAX nor the JAX package. Inputs come
in as numpy arrays (the JAX package's fields and Flax variables), results
go back as numpy arrays. Every rank of the world builds every mesh (group
creation is collective); ranks outside a mesh skip its calls.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from litbox_tpu_torch import convert
from litbox_tpu_torch.core import luts
from litbox_tpu_torch.nn.unet import LitboxDenoiserNet
from litbox_tpu_torch.parallel import (bins_resolve, bins_trace_frame, make_bins_mesh,
                                       make_mesh, shard_fields_bins,
                                       sharded_rbt_resolve, sharded_rbt_resolve_bins,
                                       sharded_rbt_trace_frame, sharded_trace_frame,
                                       world, zero_sources_bins, zero_sources_sharded)
from litbox_tpu_torch.parallel.train_sharded import (build_sharded_train_step,
                                                     make_train_mesh, param_shardings)
from litbox_tpu_torch.scene import SceneBuilder, rasterize

W = 32
N_BINS = 32


def scene(kind: str):
    """tests/test_parallel.py's scenes at W=32, built by the port: "rbt"
    (a point light of one bounce in a medium rect), "bins" (two point
    lights of three bounces: the bounce chains run >= 2 waves)."""
    b = SceneBuilder()
    if kind == "rbt":
        b.add_point_light((W / 2, W / 2), radius=1.0, bounces=1)
        b.add_rect((W / 2, W / 2), (W, W), log_density=-1.0)
        sc = b.build(max_lights=1, max_shapes=1, device="cpu")
    else:
        b.add_point_light((W / 2, W / 2), radius=1.0, intensity=1.5, bounces=3)
        b.add_point_light((W * 0.3, W * 0.6), radius=1.5, intensity=1.0, bounces=3)
        b.add_rect((W / 2, W / 2), (W, W), log_density=-1.0)
        sc = b.build(max_lights=2, max_shapes=1, device="cpu")
    return sc, rasterize(sc, W, W), torch.from_numpy(luts.brdf_lut((16, 5, 3)))


def sources(seed: int, d: int, s: int) -> tuple:
    """3 x (d, S, S) random sources from a numpy seed, smoothed over each
    bin's plane by two 5-point averages (accumulated photon deposits are
    smooth; white noise is the worst case of any two interpolations)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        x = rng.uniform(0, 1, (d, s, s))
        for _ in range(2):
            x = (np.roll(x, 1, 1) + np.roll(x, -1, 1) + np.roll(x, 1, 2)
                 + np.roll(x, -1, 2) + x) / 5.0
        out.append(x.astype(np.float32))
    return tuple(out)


def resolve_seed(rank: int) -> int:
    return 1000 + rank


def bins_seed(row: int) -> int:
    return 2000 + row


def gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _in(mesh) -> bool:
    return mesh.get_coordinate() is not None


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _meshes() -> dict:
    """Shape and this rank's coordinate of each constructor's meshes, and
    the error of a non-dividing ensemble."""
    out = {}
    for name, build in (("mesh_8_2", lambda: make_mesh(8, ensemble=2)),
                        ("mesh_4_1", lambda: make_mesh(4)),
                        ("bins_8_2", lambda: make_bins_mesh(8, ensemble=2)),
                        ("bins_8_4", lambda: make_bins_mesh(8, ensemble=4)),
                        ("train_8_2", lambda: make_train_mesh(8, model_parallel=2)),
                        ("train_8_3", lambda: make_train_mesh(8, model_parallel=3)),
                        ("train_4_2", lambda: make_train_mesh(4, model_parallel=2))):
        mesh = build()
        coord = mesh.get_coordinate()
        out[name] = (world.mesh_shape(mesh), None if coord is None else tuple(coord))
    for name, build in (("mesh_8_3", lambda: make_mesh(8, ensemble=3)),
                        ("bins_6_4", lambda: make_bins_mesh(6, ensemble=4))):
        try:
            build()
            out[name] = None
        except ValueError as err:
            out[name] = str(err)
    return out


def _resolves(fields_np: dict) -> dict:
    """Both resolves at n = 2 and 4 with ensemble = 2, for each phase."""
    rank = dist.get_rank()
    out = {}
    for phase, tree in fields_np.items():
        fields = convert.from_numpy(tree, "cpu")
        s = fields.size
        for n in (2, 4):
            mesh = make_mesh(2 * n, ensemble=2)
            if _in(mesh):
                src = tuple(torch.from_numpy(c) for c in sources(resolve_seed(rank), N_BINS, s))
                out[("full", phase, n)] = _np(sharded_rbt_resolve(mesh, fields, src, W, W))
                out[("bins", phase, n)] = _np(sharded_rbt_resolve_bins(mesh, fields, src, W, W))
            mesh = make_bins_mesh(2 * n, ensemble=2)
            if _in(mesh):
                bf = shard_fields_bins(mesh, fields)
                row, i = mesh.get_coordinate()
                dl = N_BINS // n
                src = tuple(torch.from_numpy(c[i * dl:(i + 1) * dl].copy())
                            for c in sources(bins_seed(row), N_BINS, s))
                out[("bins_resolve", phase, n)] = _np(bins_resolve(mesh, bf, src, W, W))
                out[("shapes", phase, n)] = (
                    tuple(bf.trans.shape), tuple(bf.cum_log.shape),
                    tuple(bf.cum_coarse.shape),
                    tuple(zero_sources_bins(mesh, bf)[0].shape))
    return out


def _mc_frames(fields_np: dict) -> dict:
    """The data-parallel oracle and RBT frames (tests/test_parallel.py's
    configurations)."""
    sc, gb, brdf = scene("rbt")
    fields = convert.from_numpy(fields_np, "cpu")
    out = {}
    mesh = make_mesh(8, ensemble=2)
    raw, writes = sharded_trace_frame(mesh, gb, sc.lights, sc.field_textures, brdf,
                                      gen(0), 512, 3.2, 1, max_bounces=1)
    out["oracle_2x4"] = (_np(raw), _np(writes))
    src = zero_sources_sharded(mesh, fields)
    for f in range(2):
        src, n = sharded_rbt_trace_frame(
            mesh, fields, src, gb, sc.lights, sc.field_textures, brdf, gen(f), 1024, 1,
            max_bounces=1, mc_direct=True, analytic_direct=False)
    out["rbt_2x4"] = (_np(sharded_rbt_resolve(mesh, fields, src, W, W)), _np(n))

    mesh = make_mesh(4)
    if _in(mesh):
        raw, _ = sharded_trace_frame(mesh, gb, sc.lights, sc.field_textures, brdf,
                                     gen(1), 4096, 3.2, 1, max_bounces=1)
        out["oracle_1x4"] = _np(raw)
        src = zero_sources_sharded(mesh, fields)
        src, _ = sharded_rbt_trace_frame(
            mesh, fields, src, gb, sc.lights, sc.field_textures, brdf, gen(3), 4096, 1,
            max_bounces=1, mc_direct=True, analytic_direct=False)
        out["rbt_1x4"] = _np(sharded_rbt_resolve(mesh, fields, src, W, W))
    for n in (1, 2, 4):
        mesh = make_mesh(n)
        if _in(mesh):
            src = zero_sources_sharded(mesh, fields)
            src, emitted = sharded_rbt_trace_frame(
                mesh, fields, src, gb, sc.lights, sc.field_textures, brdf, gen(9 + n),
                8192, 1, max_bounces=1, mc_direct=True, analytic_direct=False)
            out[("scaling", n)] = (_np(sharded_rbt_resolve(mesh, fields, src, W, W)),
                                   _np(emitted))
    return out


BINS_RUNS = {  # name: (n, ensemble, seed, options)
    "exact_4x2": (4, 2, 5, dict(n_photons=2048, max_bounces=4, bounce_photons=512,
                                enable_brdf=True)),
    "exact_2": (2, 1, 21, dict(n_photons=2048, max_bounces=4, bounce_photons=512,
                               enable_brdf=False)),
    "exact_8": (8, 1, 21, dict(n_photons=2048, max_bounces=4, bounce_photons=512,
                               enable_brdf=False)),
    "a2a_8": (8, 1, 13, dict(n_photons=2048, max_bounces=4, bounce_photons=512,
                             enable_brdf=True, a2a_slack=8.0)),
    "ring_8": (8, 1, 13, dict(n_photons=2048, max_bounces=4, bounce_photons=512,
                              enable_brdf=True, a2a_slack=8.0, use_ring=True)),
}


def _bins_frames(fields_np: dict) -> dict:
    """BINS_RUNS (resolved lightmaps, photon and overflow counts and this
    rank's sources) and two accumulating frames at n = 8."""
    sc, gb, brdf = scene("bins")
    fields = convert.from_numpy(fields_np, "cpu")
    out = {}
    for name, (n, e, seed, opts) in BINS_RUNS.items():
        mesh = make_bins_mesh(n * e, ensemble=e)
        if not _in(mesh):
            continue
        bf = shard_fields_bins(mesh, fields)
        src = zero_sources_bins(mesh, bf)
        opts = dict(opts)
        n_photons = opts.pop("n_photons")
        src, emitted, ovf = bins_trace_frame(mesh, bf, src, gb, sc.lights, brdf, gen(seed),
                                             n_photons, -1, **opts)
        out[name] = (_np(bins_resolve(mesh, bf, src, W, W)), _np(emitted), _np(ovf),
                     np.stack([_np(c) for c in src]))
    mesh = make_bins_mesh(8)
    bf = shard_fields_bins(mesh, fields)
    src = zero_sources_bins(mesh, bf)
    sums = []
    for f in range(2):
        src, _, _ = bins_trace_frame(mesh, bf, src, gb, sc.lights, brdf, gen(100 + f),
                                     1024, -1, max_bounces=3, enable_brdf=False)
        sums.append(float(bins_resolve(mesh, bf, src, W, W).sum()))
    out["accumulate"] = sums
    return out


def sim_cases(case: dict) -> dict:
    """Every case of tests/test_torch_parallel.py, on this rank."""
    return {"meshes": _meshes(), "resolves": _resolves(case["resolve_fields"]),
            "mc": _mc_frames(case["rbt_fields"]), "bins": _bins_frames(case["bins_fields"])}


def _meta_params(unet_size: int, features: int) -> dict:
    """The full-size parameters of the net, on the meta device (shapes)."""
    with torch.device("meta"):
        net = LitboxDenoiserNet(unet_size=unet_size, initial_features=features)
    return dict(net.named_parameters())


def _full_params(params: dict, mesh, shardings: dict) -> dict:
    """This rank's parameters with the model-sharded kernels gathered whole."""
    group, _, _ = world.axis(mesh, "model")
    out = {}
    for name, p in params.items():
        p = p.detach()
        if shardings[name] is not None:
            p = torch.cat(list(world.gather_rows(p, group)), dim=0)
        out[name] = p.numpy().copy()
    return out


TRAIN_RUNS = {  # name: (n_devices, model_parallel, initial_features, from JAX)
    "jax_1": (1, 1, 4, True),
    "data_4": (4, 1, 4, True),
    "wide_1": (1, 1, 32, False),
    "wide_2x2": (4, 2, 32, False),
}


def train_cases(case: dict) -> dict:
    """Every world case of tests/test_torch_parallel_train.py: one step of
    each TRAIN_RUNS configuration (unet_size 2, crop 16, batch 4, the
    JAX step's initial state or the port's init from seed 0), and
    param_shardings of the full-width net on a (4, 2) mesh."""
    out = {}
    for name, (n, mp, features, from_jax) in TRAIN_RUNS.items():
        mesh = make_train_mesh(n, model_parallel=mp)
        if not _in(mesh):
            continue
        run, params, stats, opt = build_sharded_train_step(
            mesh, unet_size=2, initial_features=features, batch=4,
            variables=case["variables"] if from_jax else None)
        shardings = param_shardings(_meta_params(2, features), mesh)
        params, stats, opt, loss = run(params, stats, opt, case["inputs"], case["targets"])
        out[name] = dict(loss=float(loss), params=_full_params(params, mesh, shardings),
                         mu=_full_params(opt.state["mu"], mesh, shardings),
                         stats={k: v.numpy().copy() for k, v in stats.items()},
                         local_shapes={k: tuple(v.shape) for k, v in params.items()})
    mesh = make_train_mesh(4, model_parallel=2)
    if _in(mesh):
        out["shardings"] = sorted(k for k, v in param_shardings(
            _meta_params(5, 32), mesh).items() if v is not None)
    return out


def fail_on_rank(bad: int) -> None:
    """Rank `bad` raises; the others wait at a barrier it never reaches."""
    if dist.get_rank() == bad:
        raise RuntimeError(f"rank {bad} fails on purpose")
    dist.barrier()
