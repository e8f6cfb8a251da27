"""Port parity for litbox_tpu_torch/parallel/ (the data-parallel oracle and
RBT, the bin-sharded RBT) against the JAX package's parallel/, at W=32
(S=128) and D=32 on the CPU.

The JAX side runs on conftest's 8-device CPU mesh (its first n devices).
The port's side runs in ONE gloo world of 8 spawned ranks
(litbox_tpu_torch.parallel.world), which runs every case of this module
(tests/torch_parallel_ranks.py) and returns numpy arrays. Fields and
sources cross as numpy arrays.

The bin-sharded resolves take the kernel branch (K1, then rotate_bins)
wherever D/n >= 8, on every device; the JAX functions take it only on the
TPU. So they are held to 1e-5 of the maximum against the JAX package's TPU
composition (the interpreted Pallas scan and rotate_bins per device, summed
over devices), and against the JAX functions' own CPU output (a dense
bilinear rotate) by the port's standing convention: mass within 2%, mean
|difference| under 1% of the mean. Monte Carlo frames use torch
generators, so they are held in distribution (the JAX tests' 5% on mass),
and the bin-sharded frame exactly against the port's unsharded frame on
the generator its row derives.

sharded_rbt_resolve goes through resolve_raw, which on the kernel branch
rotates at the phase-0 bin angles (as the JAX package's TPU branch), so it
is held to JAX's CPU function (whose dense rotate folds the phase in) at
phase 0 only (ROADMAP C8)."""

import dataclasses
import inspect
import multiprocessing
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_ranks as ranks
from test_torch_rbt import _np_tree

import litbox_tpu.parallel as jpar
from litbox_tpu.core import luts as jluts
from litbox_tpu.ops.attnscan import attenuation_scan_rows as jax_scan
from litbox_tpu.ops.rotate import rotate_bins as jax_rotate_bins
from litbox_tpu.parallel.rbt_bins import _a2a_capacity as jax_a2a_capacity
from litbox_tpu.parallel.rbt_bins import _bucket_by_owner as jax_bucket_by_owner
from litbox_tpu.parallel.train_sharded import make_train_mesh as jax_train_mesh
from litbox_tpu.scene import SceneBuilder as JaxSceneBuilder
from litbox_tpu.scene import rasterize as jax_rasterize
from litbox_tpu.sim import rbt as jrbt
from litbox_tpu_torch import convert
from litbox_tpu_torch.parallel import world
from litbox_tpu_torch.parallel.rbt_bins import (_a2a_capacity, _bucket_by_owner,
                                                _hist_direct_local)
from litbox_tpu_torch.parallel.rbt_sharded import resolve_bin_slice
from litbox_tpu_torch.sim import oracle, rbt

REPO = Path(__file__).resolve().parent.parent
W, D = ranks.W, ranks.N_BINS
TOL = 1e-5           # of the maximum: float32 roundings of one composition
MC_MASS = 0.05       # tests/test_parallel.py's bound on Monte Carlo mass
EXACT = dict(rtol=2e-4, atol=1e-6)  # tests/test_parallel.py:373


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_scene(kind: str):
    """ranks.scene's scenes built by the JAX package."""
    b = JaxSceneBuilder()
    if kind == "rbt":
        b.add_point_light((W / 2, W / 2), radius=1.0, bounces=1)
        b.add_rect((W / 2, W / 2), (W, W), log_density=-1.0)
        sc = b.build(max_lights=1, max_shapes=1)
    else:
        b.add_point_light((W / 2, W / 2), radius=1.0, intensity=1.5, bounces=3)
        b.add_point_light((W * 0.3, W * 0.6), radius=1.5, intensity=1.0, bounces=3)
        b.add_rect((W / 2, W / 2), (W, W), log_density=-1.0)
        sc = b.build(max_lights=2, max_shapes=1)
    return sc, jax_rasterize(sc, W, W), jnp.asarray(jluts.brdf_lut((16, 5, 3)))


@pytest.fixture(scope="module")
def jax_fields():
    """The JAX package's fields: the rbt scene at phase 0 and 0.3, the bins
    scene at phase 0."""
    _, gb, _ = _jax_scene("rbt")
    _, gbb, _ = _jax_scene("bins")
    return {"p0": jrbt.precompute_rotated_fields(gb, n_bins=D),
            "p3": jrbt.precompute_rotated_fields(gb, n_bins=D, phase=0.3),
            "bins": jrbt.precompute_rotated_fields(gbb, n_bins=D)}


@pytest.fixture(scope="module", autouse=True)
def _port_world(jax_fields):
    """Starts the port's world at once, in a thread, so that its ranks run
    while this process computes the JAX references."""
    trees = {k: _np_tree(v) for k, v in jax_fields.items()}
    case = dict(resolve_fields={"p0": trees["p0"], "p3": trees["p3"]},
                rbt_fields=trees["p0"], bins_fields=trees["bins"])
    with ThreadPoolExecutor(max_workers=1) as pool:
        yield pool.submit(world.run, ranks.sim_cases, 8, case, device="cpu",
                          timeout=600)


@pytest.fixture(scope="module")
def port(_port_world):
    """Every rank's results of ranks.sim_cases, by rank."""
    return _port_world.result()


def _fields(jax_fields, key):
    return convert.from_numpy(_np_tree(jax_fields[key]), "cpu")


def _row_ranks(n: int, e: int) -> list:
    return [e * n + i for i in range(n)]


# --- resolves ---------------------------------------------------------------

@jax.jit
def _jax_tpu_slice(trans, s0, s1, s2, theta):
    """One device of the JAX functions' TPU branch (rbt_sharded.py:161-172,
    rbt_bins.py:682-693) at W=32, S=128: the interpreted Pallas scan and
    rotate_bins' fused last shear over rows [0, 128)."""
    dep = jnp.stack(jax_scan(trans, s0, s1, s2), axis=-1)
    s = trans.shape[-1]
    oy = (s - W) // 2
    lo, hi = (oy // 64) * 64, min(-(-(oy + W) // 64) * 64, s)
    rotated = jax_rotate_bins(dep, -theta, reduce_rows=(lo, hi))
    return rotated[oy - lo:oy - lo + W, oy:oy + W]


def _jax_tpu_composition(fields, src):
    """The sum over devices of _jax_tpu_slice on each device's bins, taken
    8 bins at a time (one interpreted compile; the scan and the rotation
    are per bin, so the blocks change only the order of the final sum)."""
    total = 0.0
    for lo in range(0, D, 8):
        bins = lo + jnp.arange(8, dtype=jnp.float32)
        theta = (bins + fields.phase) * (2.0 * np.pi / D)
        part = [jnp.asarray(c[lo:lo + 8]) for c in src]
        total = total + _jax_tpu_slice(fields.trans[lo:lo + 8], *part, theta)
    return np.asarray(total)


def _mean_sources(n, e, s):
    """Row e's mean over its data ranks of ranks.sources."""
    per_rank = [ranks.sources(ranks.resolve_seed(r), D, s) for r in _row_ranks(n, e)]
    return tuple(np.mean([p[c] for p in per_rank], axis=0) for c in range(3))


def _row_sources(e, s):
    return ranks.sources(ranks.bins_seed(e), D, s)


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=tol * np.abs(ref).max())


def _convention(got, ref):
    """The port's standing convention against a JAX dense-rotate result:
    mass within 2%, mean |difference| under 1% of the mean."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert abs(got.sum() / ref.sum() - 1) < 0.02, (got.sum(), ref.sum())
    assert np.abs(got - ref).mean() < 0.01 * np.abs(ref).mean()


CASES = [(which, phase, n) for which in ("bins", "bins_resolve")
         for phase in ("p0", "p3") for n in (2, 4)]


@pytest.fixture(scope="module")
def jax_tpu_refs(jax_fields):
    """The TPU composition of every CASES entry's sources, by ensemble row."""
    s = jax_fields["p0"].size
    return {(which, phase, n): [_jax_tpu_composition(
        jax_fields[phase], _mean_sources(n, e, s) if which == "bins" else _row_sources(e, s))
        for e in range(2)] for which, phase, n in CASES}


# The JAX functions' own CPU output at n = 4 (each mesh is a compile of a
# few seconds; the port's n = 2 and 4 are held elementwise above).
CPU_CASES = [(which, phase, 4) for which in ("bins", "bins_resolve")
             for phase in ("p0", "p3")] + [("full", "p0", 4)]


@pytest.fixture(scope="module")
def jax_cpu_refs(jax_fields):
    """The JAX functions' own CPU output of every CPU_CASES entry ("full":
    sharded_rbt_resolve)."""
    s = jax_fields["p0"].size
    out = {}
    for which, phase, n in CPU_CASES:
        fields = jax_fields[phase]
        if which == "bins_resolve":
            mesh = jpar.make_bins_mesh(2 * n, ensemble=2)
            src = np.stack([np.stack(_row_sources(e, s)) for e in range(2)])
            src = src.reshape(2, 3, n, D // n, s, s).transpose(0, 2, 1, 3, 4, 5)
            ref = jpar.bins_resolve(mesh, jpar.shard_fields_bins(mesh, fields),
                                    jnp.asarray(src), W, W)
        else:
            mesh = jpar.make_mesh(2 * n, ensemble=2)
            src = jnp.asarray(np.stack([np.stack(ranks.sources(ranks.resolve_seed(r), D, s))
                                        for r in range(2 * n)]).reshape(2, n, 3, D, s, s))
            fn = jpar.sharded_rbt_resolve_bins if which == "bins" else jpar.sharded_rbt_resolve
            ref = fn(mesh, fields, src, W, W)
        out[(which, phase, n)] = np.asarray(ref)
    return out


@pytest.mark.parametrize("which,phase,n", CASES)
def test_bin_resolves_match_jax_tpu_composition(jax_tpu_refs, port, which, phase, n):
    """sharded_rbt_resolve_bins (the reduce-scattered mean sources) and
    bins_resolve (a row's sources over its shards), every ensemble row, to
    1e-5 of the maximum; every rank of the mesh returns the same maps."""
    got = port[0]["resolves"][(which, phase, n)]
    assert got.shape == (2, W, W, 3)
    for r in range(1, 2 * n):
        np.testing.assert_array_equal(port[r]["resolves"][(which, phase, n)], got)
    for e in range(2):
        _close(got[e], jax_tpu_refs[(which, phase, n)][e])


@pytest.mark.parametrize("which,phase,n", CPU_CASES[:-1])
def test_bin_resolves_match_jax_cpu(jax_cpu_refs, port, which, phase, n):
    """The same two against the JAX functions' CPU output (their dense
    branch), by the convention."""
    for e in range(2):
        _convention(port[0]["resolves"][(which, phase, n)][e],
                    jax_cpu_refs[(which, phase, n)][e])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("phase", ["p0", "p3"])
def test_sharded_rbt_resolve_is_mean_of_resolves(port, jax_fields, phase, n):
    """sharded_rbt_resolve equals the mean over a row's ranks of the port's
    resolve_raw of each rank's sources, to 1e-6 of the maximum."""
    fields = _fields(jax_fields, phase)
    got = port[0]["resolves"][("full", phase, n)]
    for e in range(2):
        raws = [rbt.resolve_raw(fields, tuple(torch.from_numpy(c) for c in ranks.sources(
            ranks.resolve_seed(r), D, fields.size)), W, W).numpy() for r in _row_ranks(n, e)]
        _close(got[e], np.mean(raws, axis=0), tol=1e-6)


def test_sharded_rbt_resolve_matches_jax_cpu(jax_cpu_refs, port):
    """sharded_rbt_resolve against the JAX function's CPU output, by the
    convention, at phase 0 (C8: the kernel branch rotates at phase-0
    angles, the JAX CPU branch folds the phase in)."""
    for e in range(2):
        _convention(port[0]["resolves"][("full", "p0", 4)][e],
                    jax_cpu_refs[("full", "p0", 4)][e])


@pytest.mark.parametrize("n", [2, 4])
def test_bins_per_rank_tensors_hold_d_over_n(port, n):
    """trans, cum_log, cum_coarse and the source buffers of each rank hold
    D/n bins."""
    s = 128
    for r in range(2 * n):
        trans, cum_log, coarse, src = port[r]["resolves"][("shapes", "p0", n)]
        assert trans == cum_log == src == (D // n, s, s)
        assert coarse == (D // n, s, s // rbt.COARSE)


# --- Monte Carlo frames -----------------------------------------------------

def test_sharded_trace_frame_runs_and_reduces(port):
    raw, writes = port[0]["mc"]["oracle_2x4"]
    assert raw.shape == (2, W, W, 3)
    assert np.all(np.isfinite(raw)) and raw.sum() > 0
    assert np.abs(raw[0] - raw[1]).max() > 0     # independent ensemble rows
    assert writes.shape == (2,) and (writes > 0).all()
    for r in range(1, 8):
        np.testing.assert_array_equal(port[r]["mc"]["oracle_2x4"][0], raw)


def test_sharded_rbt_trace_and_resolve(port):
    raw, emitted = port[0]["mc"]["rbt_2x4"]
    assert raw.shape == (2, W, W, 3)
    assert np.all(np.isfinite(raw)) and raw.sum() > 0
    assert np.abs(raw[0] - raw[1]).max() > 0
    np.testing.assert_array_equal(emitted, [4 * 1024, 4 * 1024])


@pytest.fixture(scope="module")
def jax_mc(jax_fields):
    """The JAX functions' masses at tests/test_parallel.py's configurations:
    the oracle and RBT on 4 devices at 4096 photons each."""
    sc, gb, brdf = _jax_scene("rbt")
    fields = jax_fields["p0"]
    mesh = jpar.make_mesh(4)
    raw, _ = jpar.sharded_trace_frame(mesh, gb, sc.lights, sc.field_textures, brdf,
                                      jax.random.key(1), 4096, 3.2, jnp.int32(1),
                                      max_bounces=1)
    src = jpar.zero_sources_sharded(mesh, fields)
    src, _ = jpar.sharded_rbt_trace_frame(
        mesh, fields, src, gb, sc.lights, sc.field_textures, brdf, jax.random.key(3),
        4096, jnp.int32(1), max_bounces=1, mc_direct=True, analytic_direct=False)
    return {"oracle": float(np.asarray(raw)[0].sum()),
            "rbt": float(np.asarray(jpar.sharded_rbt_resolve(mesh, fields, src, W, W))[0].sum())}


def _port_single(kind, fields):
    """The port's unsharded frame at 16,384 photons (4 x 4096)."""
    sc, gb, brdf = ranks.scene("rbt")
    g = ranks.gen(2)
    if kind == "oracle":
        raw, _ = oracle.trace_frame(gb, sc.lights, sc.field_textures, brdf, g, 16384,
                                    3.2, 1, max_bounces=1)
        return float(raw.sum())
    src = rbt.zero_sources(fields)
    src, _ = rbt.rbt_trace_frame(fields, src, gb, sc.lights, sc.field_textures, brdf, g,
                                 16384, 1, max_bounces=1, mc_direct=True,
                                 analytic_direct=False)
    return float(rbt.resolve_raw(fields, src, W, W).sum())


@pytest.mark.parametrize("ref", ["jax", "port"])
@pytest.mark.parametrize("kind", ["oracle", "rbt"])
def test_sharded_mass_matches(jax_mc, port, jax_fields, kind, ref):
    """The 4-rank frame's mass within 5% of the JAX function's on 4 devices
    and of the port's unsharded frame with as many photons."""
    got = float(port[0]["mc"][f"{kind}_1x4"][0].sum())
    want = jax_mc[kind] if ref == "jax" else _port_single(kind, _fields(jax_fields, "p0"))
    assert abs(got / want - 1) < MC_MASS, (got, want)


def test_sharded_rbt_device_count_scaling(port):
    """The same photons a rank on 1, 2 and 4 ranks: the emitted count
    scales with n and the lightmap's mass stays within 5% (each rank's
    estimate is normalized by its own photons)."""
    sums = {}
    for n in (1, 2, 4):
        raw, emitted = port[0]["mc"][("scaling", n)]
        assert np.all(np.isfinite(raw))
        np.testing.assert_array_equal(emitted, [n * 8192])
        sums[n] = float(raw.sum())
    for n, s in sums.items():
        assert abs(s / sums[1] - 1) < MC_MASS, sums


# --- the bin-sharded frame ----------------------------------------------------

def _bins_sources(port, name):
    """Row 0's sources of a BINS_RUNS run, gathered over its shards: (3, D, S, S)."""
    n = ranks.BINS_RUNS[name][0]
    return np.concatenate([port[i]["bins"][name][3] for i in range(n)], axis=1)


def _unsharded(jax_fields, name):
    """The port's unsharded frame on the generator row 0 derives: its
    sources (3, D, S, S) and photons."""
    n, e, seed, opts = ranks.BINS_RUNS[name]
    opts = {k: v for k, v in opts.items() if k not in ("a2a_slack", "use_ring")}
    n_photons = opts.pop("n_photons")
    sc, gb, brdf = ranks.scene("bins")
    fields = _fields(jax_fields, "bins")
    src = rbt.zero_sources(fields)
    src, n_ref = rbt.rbt_trace_frame(
        fields, src, gb, sc.lights, sc.field_textures, brdf,
        world.derive_generator(ranks.gen(seed), 0, e), n_photons, -1, mc_direct=True,
        analytic_direct=False, hist_direct=True, **opts)
    return fields, src, n_ref


@pytest.mark.parametrize("name", ["exact_4x2", "exact_2", "exact_8"])
def test_bins_frame_matches_unsharded(port, jax_fields, name):
    """Row 0 of bins_trace_frame IS the port's unsharded frame
    (hist_direct=True) re-partitioned: its sources, gathered over the
    shards, and its resolved lightmap within 2e-4 relative and 1e-6
    absolute, with no bucket overflow; the lightmap against resolve_raw
    where D/n >= 8 (the kernel branch), else against the dense branch's
    per-slice composition of the unsharded sources."""
    n, e, _, _ = ranks.BINS_RUNS[name]
    raw, emitted, ovf, _ = port[0]["bins"][name]
    fields, src_ref, n_ref = _unsharded(jax_fields, name)
    np.testing.assert_array_equal(ovf, np.zeros(e))
    np.testing.assert_array_equal(emitted, [n_ref] * e)
    np.testing.assert_allclose(_bins_sources(port, name), torch.stack(src_ref).numpy(),
                               **EXACT)
    dl = D // n
    if dl >= 8:
        ref = rbt.resolve_raw(fields, src_ref, W, W).numpy()
    else:
        ref = sum(resolve_bin_slice(fields, fields.trans[i * dl:(i + 1) * dl],
                                    tuple(c[i * dl:(i + 1) * dl] for c in src_ref),
                                    i * dl, W, W) for i in range(n)).numpy()
    np.testing.assert_allclose(raw[0], ref, **EXACT)
    if e > 1:
        assert np.abs(raw[1] - ref).max() > 1e-6      # row 1: its own generator


@pytest.fixture(scope="module")
def jax_bins(jax_fields):
    """The JAX functions' bin-sharded frame at exact_4x2's configuration
    (tests/test_parallel.py's): bins_trace_frame and bins_resolve on 8
    devices, ensemble 2, 2048 + 512 photons a row, BRDF on."""
    n, e, seed, opts = ranks.BINS_RUNS["exact_4x2"]
    opts = dict(opts)
    n_photons = opts.pop("n_photons")
    sc, gb, brdf = _jax_scene("bins")
    mesh = jpar.make_bins_mesh(n * e, ensemble=e)
    bf = jpar.shard_fields_bins(mesh, jax_fields["bins"])
    src = jpar.zero_sources_bins(mesh, bf)
    src, emitted, ovf = jpar.bins_trace_frame(mesh, bf, src, gb, sc.lights, brdf,
                                              jax.random.key(seed), n_photons,
                                              jnp.int32(-1), **opts)
    return (np.asarray(jpar.bins_resolve(mesh, bf, src, W, W)), np.asarray(emitted),
            np.asarray(ovf))


@pytest.mark.parametrize("row", [0, 1])
def test_bins_frame_mass_matches_jax(jax_bins, port, row):
    """Each ensemble row of the port's bin-sharded frame (4 shards, 2 rows)
    holds the JAX function's photons and its mass within 5%, the JAX
    tests' bound on Monte Carlo mass (the generators differ)."""
    raw, emitted, ovf = port[0]["bins"]["exact_4x2"][:3]
    j_raw, j_emitted, j_ovf = jax_bins
    np.testing.assert_array_equal(ovf, j_ovf)
    np.testing.assert_array_equal(emitted, j_emitted)
    assert raw.shape == j_raw.shape
    got, want = float(raw[row].sum()), float(j_raw[row].sum())
    assert abs(got / want - 1) < MC_MASS, (got, want)


def test_bins_a2a_matches_ring(port):
    """The all-to-all exchange and the ring ablation fly the same records
    with the same draws: equal sources and lightmaps within 2e-4 relative
    and 1e-6 absolute, no overflow at slack 8."""
    for name in ("a2a_8", "ring_8"):
        np.testing.assert_array_equal(port[0]["bins"][name][2], [0])
    np.testing.assert_allclose(_bins_sources(port, "a2a_8"), _bins_sources(port, "ring_8"),
                               **EXACT)
    np.testing.assert_allclose(port[0]["bins"]["a2a_8"][0], port[0]["bins"]["ring_8"][0],
                               **EXACT)


def test_bins_frames_accumulate(port):
    sums = port[0]["bins"]["accumulate"]
    assert sums[1] > sums[0] * 1.5


# --- meshes ---------------------------------------------------------------

JAX_MESHES = {
    "mesh_8_2": lambda: jpar.make_mesh(8, ensemble=2),
    "mesh_4_1": lambda: jpar.make_mesh(4),
    "bins_8_2": lambda: jpar.make_bins_mesh(8, ensemble=2),
    "bins_8_4": lambda: jpar.make_bins_mesh(8, ensemble=4),
    "train_8_2": lambda: jax_train_mesh(8, model_parallel=2),
    "train_8_3": lambda: jax_train_mesh(8, model_parallel=3),
    "train_4_2": lambda: jax_train_mesh(4, model_parallel=2),
}


@pytest.mark.parametrize("name", sorted(JAX_MESHES))
def test_mesh_matches_jax(port, name):
    """Shape and every rank's coordinate equal the JAX mesh's (device id r
    at the same position as rank r); ranks past n are outside the mesh."""
    mesh = JAX_MESHES[name]()
    ids = np.vectorize(lambda dev: dev.id)(mesh.devices)
    for r in range(8):
        shape, coord = port[r]["meshes"][name]
        assert shape == dict(mesh.shape)
        where = np.argwhere(ids == r)
        assert coord == (tuple(int(x) for x in where[0]) if len(where) else None)


@pytest.mark.parametrize("name,build", [
    ("mesh_8_3", lambda: jpar.make_mesh(8, ensemble=3)),
    ("bins_6_4", lambda: jpar.make_bins_mesh(6, ensemble=4))])
def test_mesh_errors_match_jax(port, name, build):
    with pytest.raises(ValueError) as err:
        build()
    assert port[0]["meshes"][name] == str(err.value)


# --- exact pieces -----------------------------------------------------------

def test_a2a_capacity_matches_jax():
    for m in (1, 7, 8, 9, 100, 512, 4096, 16384, 65536):
        for n in (1, 2, 3, 4, 8):
            for slack in (1.0, 2.5, 4.0, 8.0):
                assert _a2a_capacity(m, n, slack) == jax_a2a_capacity(m, n, slack)


@pytest.mark.parametrize("seed", range(4))
def test_bucket_by_owner_matches_jax(seed):
    """Slots and keep flags bit for bit on seeded owners and active masks,
    with buckets small enough to overflow."""
    rng = np.random.default_rng(seed)
    m, n = 257, 4
    owner = rng.integers(0, n, m)
    active = rng.uniform(size=m) < 0.6
    for w in (8, 32, 64):
        slot, keep = _bucket_by_owner(torch.from_numpy(owner), n, w,
                                      torch.from_numpy(active))
        j_slot, j_keep = jax_bucket_by_owner(jnp.asarray(owner, jnp.int32), n, w,
                                             jnp.asarray(active))
        np.testing.assert_array_equal(slot.numpy(), np.asarray(j_slot))
        np.testing.assert_array_equal(keep.numpy(), np.asarray(j_keep))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_hist_direct_local_concatenates_to_unsharded(jax_fields, n):
    """The local histograms of the n slices, concatenated in order with
    their cells moved to global bins, are the unsharded
    _mc_point_hist_deposits stream exactly."""
    sc, _, _ = ranks.scene("bins")
    fields = _fields(jax_fields, "bins")
    s, dl = fields.size, D // n
    flat_ref, vals_ref, n_ref = rbt._mc_point_hist_deposits(
        sc.lights, fields, 2048, ranks.gen(7), -1, float(W * W))
    parts = [_hist_direct_local(sc.lights, fields, i * dl, dl, 2048, ranks.gen(7), -1,
                                float(W * W)) for i in range(n)]
    assert all(p[2] == n_ref for p in parts)
    flat = torch.cat([p[0] + i * dl * s * s for i, p in enumerate(parts)])
    np.testing.assert_array_equal(flat.numpy(), flat_ref.numpy())
    np.testing.assert_array_equal(torch.cat([p[1] for p in parts]).numpy(), vals_ref.numpy())


# --- the runner and the imports --------------------------------------------

def test_world_stops_at_a_failing_rank():
    """A rank that raises ends the run with its traceback, while the other
    rank waits at a barrier it never leaves."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        world.run(ranks.fail_on_rank, 2, 1, device="cpu", timeout=120)


def test_world_runs_on_the_card_by_default(monkeypatch):
    """world.run and world.init default to "cuda" (NCCL), as every entry
    point of the port does. With no card visible a call with the default
    raises before it starts a rank: there is no fallback to gloo."""
    for fn in (world.run, world.init):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = set(multiprocessing.active_children())
    with pytest.raises(RuntimeError, match="CUDA devices, 0 visible"):
        world.run(ranks.fail_on_rank, 1, 0)
    assert set(multiprocessing.active_children()) <= before


def test_parallel_imports_without_jax():
    """The package, its runner and the rank bodies import in a process
    where `jax` and `litbox_tpu` cannot be imported."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['litbox_tpu'] = None\n"
            "sys.path.insert(0, 'tests')\n"
            "import litbox_tpu_torch.parallel, litbox_tpu_torch.parallel.world\n"
            "import litbox_tpu_torch.parallel.train_sharded, torch_parallel_ranks\n"
            "assert len(litbox_tpu_torch.parallel.__all__) == 12\n"
            "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_public_names_match_jax():
    import litbox_tpu_torch.parallel as ppar

    assert sorted(ppar.__all__) == sorted(jpar.__all__)
    assert dataclasses.is_dataclass(ppar.BinShardedFields)
