"""Port parity for the RBT frame: litbox_tpu_torch's scene, fields, trace,
resolve and HDR against the JAX package on the same inputs, at a small size
on the CPU (where the port's kernel wrappers take their plain versions).

Deterministic stages are held elementwise. The trace is Monte Carlo with a
different generator (threefry in JAX, torch's in the port), so it is held in
distribution: the closed-form direct energy, and bounce energy means within
4 sigma over seeds. Injection is held exactly by feeding both packages one
deposit stream."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litbox_tpu.core import luts
from litbox_tpu.ops.attnscan import attenuation_scan_rows as jax_scan
from litbox_tpu.ops.resample import gather_bilinear_mxu
from litbox_tpu.ops.rotate import rotate_planar_sum as jax_planar_sum
from litbox_tpu.scene import SceneBuilder as JaxSceneBuilder
from litbox_tpu.scene import rasterize as jax_rasterize
from litbox_tpu.sim import rbt as jrbt
from litbox_tpu.sim.oracle import to_hdr as jax_to_hdr
from litbox_tpu_torch.convert import from_numpy
from litbox_tpu_torch.ops.resample import gather_bilinear
from litbox_tpu_torch.scene import SceneBuilder, rasterize
from litbox_tpu_torch.sim import rbt
from litbox_tpu_torch.sim.oracle import to_hdr

W = 64
N_BINS = 16
N_PHOTONS = 16384
BOUNCE_PHOTONS = 4096
# bench.py's trace options: the configuration this slice of the port runs.
BENCH_OPTS = dict(max_bounces=2, bounce_photons=BOUNCE_PHOTONS, mc_direct=True,
                  analytic_direct=False, enable_brdf=False, light_kinds=(1,),
                  hist_direct=True)


def _np_tree(obj):
    """A JAX dataclass or tuple -> the dict/tuple of numpy arrays that
    convert.from_numpy takes."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _np_tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (tuple, list)):
        return tuple(_np_tree(v) for v in obj)
    return np.asarray(obj)


def _to_port(obj):
    return from_numpy(_np_tree(obj), "cpu")


def _scene(builder_cls):
    """bench.py's scene (a point light in a smoothed random cloud), at 64^2,
    plus a rotated rect and an ellipse so every shape kind rasterizes."""
    rng = np.random.default_rng(0)
    cloud = rng.uniform(0.0, 1.0, (32, 32)).astype(np.float32)
    for _ in range(3):
        cloud = (np.roll(cloud, 1, 0) + np.roll(cloud, -1, 0)
                 + np.roll(cloud, 1, 1) + np.roll(cloud, -1, 1) + cloud) / 5.0
    b = builder_cls(texture_size=32)
    b.add_point_light((W * 0.5, W * 0.55), radius=4.0, color=(1.0, 0.85, 0.6),
                      intensity=2.0, bounces=2)
    b.add_sprite((W / 2, W / 2), (W / 2, W / 2), color=(1, 1, 1, 1),
                 log_density=-1.0, texture=np.stack([cloud] * 3 + [cloud], -1))
    b.add_rect((W * 0.3, W * 0.7), (8, 5), rotation=0.4,
               color=(1, 0.3, 0.2, 1), log_density=-0.5, alignment=0.5)
    b.add_ellipse((W * 0.7, W * 0.3), (6, 9), rotation=0.2,
                  color=(0.2, 0.9, 0.3, 1), log_density=-0.7)
    return b


@pytest.fixture(scope="module")
def jax_setup():
    scene = _scene(JaxSceneBuilder).build(max_lights=2, max_shapes=4)
    gb = jax_rasterize(scene, W, W)
    fields = jrbt.precompute_rotated_fields(gb, n_bins=N_BINS)
    brdf = jnp.asarray(luts.brdf_lut((32, 9, 4)))
    return scene, gb, fields, brdf


@pytest.fixture(scope="module")
def port_setup():
    scene = _scene(SceneBuilder).build(max_lights=2, max_shapes=4, device="cpu")
    gb = rasterize(scene, W, W)
    fields = rbt.precompute_rotated_fields(gb, n_bins=N_BINS)
    brdf = torch.from_numpy(luts.brdf_lut((32, 9, 4)))
    return scene, gb, fields, brdf


@pytest.fixture(scope="module")
def jax_sources(jax_setup):
    """Four frames of bench-option sources traced by the JAX package."""
    scene, gb, fields, brdf = jax_setup
    src = jrbt.zero_sources(fields)
    for f in range(4):
        src, _ = jrbt.rbt_trace_frame(fields, src, gb, scene.lights,
                                      scene.field_textures, brdf,
                                      jax.random.key(f), N_PHOTONS,
                                      jnp.int32(-1), **BENCH_OPTS)
    return src


def test_scene_and_rasterize_match(jax_setup, port_setup):
    for name in ("kind", "affine", "energy", "bounces", "active"):
        np.testing.assert_array_equal(
            getattr(port_setup[0].lights, name).numpy(),
            np.asarray(getattr(jax_setup[0].lights, name)))
    for name in ("albedo", "transmissibility", "normal"):
        np.testing.assert_allclose(getattr(port_setup[1], name).numpy(),
                                   np.asarray(getattr(jax_setup[1], name)),
                                   atol=1e-5, rtol=0)


def test_from_numpy_round_trips_state(jax_setup):
    scene, gb, fields, _ = jax_setup
    port_scene = _to_port(scene)
    np.testing.assert_array_equal(port_scene.shapes.inv_affine.numpy(),
                                  np.asarray(scene.shapes.inv_affine))
    assert port_scene.lights.active.dtype == torch.bool
    port_fields = _to_port(fields)
    assert (port_fields.n_bins, port_fields.size) == (fields.n_bins, fields.size)
    with pytest.raises(ValueError):
        from_numpy({"albedo": np.zeros(1)}, "cpu")


def test_gather_bilinear_matches_f32_mxu_gather():
    rng = np.random.default_rng(1)
    field = rng.uniform(-3.0, 0.0, (40, 56, 3)).astype(np.float32)
    # Points inside, on and outside the border (zero-weight taps).
    pts = rng.uniform(-2.0, 60.0, (5000, 2)).astype(np.float32)
    ref = gather_bilinear_mxu(jnp.asarray(field), jnp.asarray(pts),
                              chunk=1024, precision="f32")
    got = gather_bilinear(torch.from_numpy(field), torch.from_numpy(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_rotated_fields_match(jax_setup, port_setup):
    """The JAX fields come through its bf16 gather; the port's are float32."""
    jf, pf = jax_setup[2], port_setup[2]
    assert pf.trans.shape == tuple(jf.trans.shape) == (N_BINS, 128, 128)
    np.testing.assert_allclose(pf.cos.numpy(), np.asarray(jf.cos), atol=1e-6)
    np.testing.assert_allclose(pf.trans.numpy(), np.asarray(jf.trans),
                               atol=5e-3, rtol=0)
    np.testing.assert_array_equal(pf.cum_coarse.numpy(),
                                  pf.cum_log.numpy()[..., rbt.COARSE - 1::rbt.COARSE])
    # Against the JAX construction with the f32 gather: float32 rounding only.
    logt = np.log(np.clip(np.asarray(jax_setup[1].transmissibility),
                          np.exp(rbt.LOGT_CLAMP), 1.0))
    s = pf.size
    xs = np.arange(s, dtype=np.float32) + 0.5 - s / 2.0
    c, sn = np.asarray(jf.cos)[:, None, None], np.asarray(jf.sin)[:, None, None]
    px = c * xs[None, None, :] - sn * xs[None, :, None] + W / 2
    py = sn * xs[None, None, :] + c * xs[None, :, None] + W / 2
    pts = np.stack([px, py], -1).reshape(-1, 2).astype(np.float32)
    ref = gather_bilinear_mxu(jnp.asarray(logt), jnp.asarray(pts),
                              precision="f32").reshape(N_BINS, s, s)
    np.testing.assert_allclose(pf.trans.numpy(), np.exp(np.asarray(ref)),
                               atol=1e-5, rtol=0)


def test_inject_flat_exact(jax_setup, port_setup):
    scene, gb, fields, brdf = jax_setup
    flat, vals, _ = jrbt.rbt_frame_deposits(
        fields, gb, scene.lights, scene.field_textures, brdf,
        jax.random.key(7), N_PHOTONS, jnp.int32(-1), **BENCH_OPTS)
    ref = jrbt._inject_flat(jrbt.zero_sources(fields), flat, vals)
    src = rbt.zero_sources(port_setup[2])
    got = rbt._inject_flat(src, torch.from_numpy(np.array(flat)),
                           torch.from_numpy(np.array(vals)))
    assert got is src  # in place
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=0)


def _direct_closed_form(lights) -> np.ndarray:
    """Per-frame direct energy of active point lights with bounces > 0:
    energy_l * W * H / (2 pi), exact under the stamp histogram."""
    energy = np.asarray(lights.energy)
    keep = np.asarray(lights.active) & (np.asarray(lights.bounces) > 0)
    return (energy * keep[:, None]).sum(0) * (W * W) / (2 * np.pi)


def test_direct_energy_closed_form_both(jax_setup, port_setup):
    expect = _direct_closed_form(jax_setup[0].lights)
    opts = dict(BENCH_OPTS, max_bounces=1)
    scene, gb, fields, brdf = jax_setup
    _, vals, n = jrbt.rbt_frame_deposits(
        fields, gb, scene.lights, scene.field_textures, brdf,
        jax.random.key(0), N_PHOTONS, jnp.int32(-1), **opts)
    np.testing.assert_allclose(np.asarray(vals).sum(0), expect, rtol=1e-4)
    scene, gb, fields, brdf = port_setup
    _, vals, n_port = rbt.rbt_frame_deposits(
        fields, gb, scene.lights, scene.field_textures, brdf,
        torch.Generator().manual_seed(0), N_PHOTONS, -1, **opts)
    np.testing.assert_allclose(vals.double().sum(0).numpy(), expect, rtol=1e-4)
    assert n_port == int(n) == N_PHOTONS


def test_bounce_energy_in_distribution(jax_setup, port_setup):
    """Wave >= 1 deposit energy per frame: JAX and port means agree within
    4 sigma of the difference of the two means over 6 seeds each."""
    direct = _direct_closed_form(jax_setup[0].lights).sum()
    seeds = range(6)
    scene, gb, fields, brdf = jax_setup
    jax_e = [float(np.asarray(jrbt.rbt_frame_deposits(
        fields, gb, scene.lights, scene.field_textures, brdf,
        jax.random.key(100 + s), N_PHOTONS, jnp.int32(-1),
        **BENCH_OPTS)[1]).astype(np.float64).sum()) - direct for s in seeds]
    scene, gb, fields, brdf = port_setup
    port_e = [float(rbt.rbt_frame_deposits(
        fields, gb, scene.lights, scene.field_textures, brdf,
        torch.Generator().manual_seed(100 + s), N_PHOTONS, -1,
        **BENCH_OPTS)[1].double().sum()) - direct for s in seeds]
    assert min(jax_e) > 0 and min(port_e) > 0
    sigma = np.sqrt(np.var(jax_e, ddof=1) / len(jax_e)
                    + np.var(port_e, ddof=1) / len(port_e))
    assert abs(np.mean(jax_e) - np.mean(port_e)) < 4 * sigma, (jax_e, port_e)


def test_resolve_matches_pallas_path(jax_setup, jax_sources):
    """resolve_raw against the JAX package's TPU resolve (Pallas scan +
    planar 3-shear rotate-and-sum, interpreted): the same lattice, so the
    two agree to float32 rounding."""
    jf = jax_setup[2]
    d, s = jf.n_bins, jf.size
    dep = jax_scan(jf.trans, *jax_sources)
    oy = ox = (s - W) // 2
    lo, hi = (oy // 64) * 64, min(-(-(oy + W) // 64) * 64, s)
    ref = jax_planar_sum(dep, tuple(-i * 2.0 * np.pi / d for i in range(d)),
                         0.0, 2.0 * np.pi / d, lo, hi)
    ref = np.moveaxis(np.asarray(ref)[:, oy - lo:oy - lo + W, ox:ox + W], 0, -1)
    got = rbt.resolve_raw(_to_port(jf), _to_port(jax_sources), W, W).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_resolve_matches_jax_resolve_raw(jax_setup, jax_sources):
    """Against JAX resolve_raw off the TPU (a dense bilinear rotate through
    the bf16 gather) and the port's own dense rotate_back, on the same fields
    and sources: interpolation differs, so hold mass within 2% and the mean
    absolute error below 1% of the mean (test_pallas_ops.py's tolerances,
    scaled to the image)."""
    jf = jax_setup[2]
    pf = _to_port(jf)
    ref = np.asarray(jrbt.resolve_raw(jf, jax_sources, W, W))
    src = _to_port(jax_sources)
    got = rbt.resolve_raw(pf, src, W, W).numpy()
    dense = rbt.rotate_back(pf, torch.stack(
        rbt.attenuation_scan_rows(pf.trans, *src), -1), W, W).numpy()
    for other in (ref, dense):
        assert abs(got.sum() / other.sum() - 1) < 0.02
        assert np.abs(got - other).mean() < 0.01 * other.mean()


def test_resolve_group_partition(port_setup, jax_sources):
    fields = port_setup[2]
    src = _to_port(jax_sources)
    full = rbt.resolve_raw(fields, src, W, W).numpy()
    for k in (2, 4):
        parts = sum(rbt.resolve_raw(fields, src, W, W, group=g, n_groups=k).numpy()
                    for g in range(k))
        np.testing.assert_allclose(parts, full, rtol=2e-5, atol=1e-6 * full.max())


def test_resolve_tracer_offset_exact(port_setup):
    fields = port_setup[2]
    d, s = fields.n_bins, fields.size
    rng = np.random.default_rng(3)
    src_a = tuple(torch.from_numpy(rng.uniform(0, 1, (d, s, s)).astype(np.float32))
                  for _ in range(3))
    src_b = tuple(torch.from_numpy(rng.uniform(0, 1, (d, s, s)).astype(np.float32))
                  for _ in range(3))
    src2 = tuple(torch.cat([a, b]) for a, b in zip(src_a, src_b))
    for t, ref_src in ((0, src_a), (1, src_b)):
        ref = rbt.resolve_raw(fields, ref_src, W, W)
        torch.testing.assert_close(rbt.resolve_raw(fields, src2, W, W, tracer=t),
                                   ref, atol=0, rtol=0)
    ref = rbt.resolve_raw(fields, src_b, W, W)
    parts = sum(rbt.resolve_raw(fields, src2, W, W, tracer=1, group=g, n_groups=4)
                for g in range(4))
    torch.testing.assert_close(parts, ref, rtol=1e-4, atol=1e-5)


def test_to_hdr_matches(jax_setup, port_setup):
    raw = np.random.default_rng(4).uniform(0, 2, (W, W, 3)).astype(np.float32)
    for iterations in (4.0, 0.0):
        ref = jax_to_hdr(jnp.asarray(raw), jnp.float32(iterations), jax_setup[1])
        got = to_hdr(torch.from_numpy(raw), iterations, port_setup[1])
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_frame_end_to_end_mean_energy(jax_setup, jax_sources, port_setup):
    """The slice end to end (trace 4 frames, resolve, HDR) in both packages:
    mean HDR energy within 3% (Monte-Carlo noise plus interpolation)."""
    scene, gb, fields, brdf = jax_setup
    ref = np.asarray(jax_to_hdr(jrbt.resolve_raw(fields, jax_sources, W, W),
                                jnp.float32(4.0), gb))
    scene, gb, fields, brdf = port_setup
    src = rbt.zero_sources(fields)
    gen = torch.Generator().manual_seed(0)
    for _ in range(4):
        src, _ = rbt.rbt_trace_frame(fields, src, gb, scene.lights,
                                     scene.field_textures, brdf, gen,
                                     N_PHOTONS, -1, **BENCH_OPTS)
    got = to_hdr(rbt.resolve_raw(fields, src, W, W), 4.0, gb).numpy()
    assert got.shape == ref.shape == (W, W, 3)
    assert np.isfinite(got).all() and got.min() >= 0
    np.testing.assert_allclose(got.mean(), ref.mean(), rtol=0.03)


@pytest.mark.parametrize("opts,phase", [
    (dict(), "_analytic_point_deposits"),
    (dict(analytic_direct=False, light_kinds=(1,)), "_mc_scatter_deposits"),
    (dict(analytic_direct=False, light_kinds=(1,), hist_direct=True,
          n_tracers=2), "n_tracers>1"),
    (dict(analytic_direct=False, light_kinds=None, hist_direct=True), "emit"),
    (dict(analytic_direct=False, light_kinds=(1,), hist_direct=True,
          exact_collimated=True), "collimated"),
    (dict(analytic_direct=False, light_kinds=(1,), hist_direct=True,
          max_bounces=2), "sample_brdf_fast"),
])
def test_unported_options_raise(port_setup, opts, phase):
    scene, gb, fields, brdf = port_setup
    with pytest.raises(NotImplementedError, match=phase):
        rbt.rbt_trace_frame(fields, rbt.zero_sources(fields), gb, scene.lights,
                            scene.field_textures, brdf,
                            torch.Generator().manual_seed(0), 1024, -1, **opts)
