"""Port parity for the oracle tracer: litbox_tpu_torch's deposit splats,
nearest sampling, mip step, escape distance and `trace_frame` against the
JAX package on the CPU, at a small size.

The splats and samplers are deterministic and held elementwise. The trace
is Monte Carlo with another generator (threefry in JAX, torch's in the
port), so it is held to the closed-form profile of a point light in a
uniform medium (tests/test_oracle_physics.py), to the JAX package's energy
in distribution, and to the port's own RBT engine (tests/test_rbt.py's
oracle anchor)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litbox_tpu.core import luts
from litbox_tpu.core import sampling as jsampling
from litbox_tpu.ops import scatter as jscatter
from litbox_tpu.scene import SceneBuilder as JaxSceneBuilder
from litbox_tpu.scene import rasterize as jax_rasterize
from litbox_tpu.sim import oracle as joracle
from litbox_tpu_torch.core import sampling
from litbox_tpu_torch.ops import scatter
from litbox_tpu_torch.scene import SceneBuilder, rasterize
from litbox_tpu_torch.sim import oracle, rbt

W = 64
DENSITY_LOG = -1.3  # light haze


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU work: the suite runs test files
    in parallel workers, and torch's thread pool spin-waits when they share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _uniform_scene(builder_cls):
    """tests/test_oracle_physics.py's scene: a small point light in a
    uniform medium."""
    b = builder_cls()
    b.add_point_light((W / 2, W / 2), radius=0.5, color=(1, 1, 1), intensity=1.0,
                      bounces=2)
    b.add_rect((W / 2, W / 2), (W, W), color=(1, 1, 1, 1), log_density=DENSITY_LOG)
    return b


@pytest.fixture(scope="module")
def port_setup():
    scene = _uniform_scene(SceneBuilder).build(max_lights=2, max_shapes=2, device="cpu")
    return scene, rasterize(scene, W, W), torch.from_numpy(luts.brdf_lut((32, 9, 4)))


@pytest.fixture(scope="module")
def jax_setup():
    scene = _uniform_scene(JaxSceneBuilder).build(max_lights=2, max_shapes=2)
    return scene, jax_rasterize(scene, W, W), jnp.asarray(luts.brdf_lut((32, 9, 4)))


def _port_trace(setup, seed, n, frames, bounces):
    """Mean raw deposits per frame and the total write count."""
    scene, gb, brdf = setup
    gen = torch.Generator().manual_seed(seed)
    acc = torch.zeros((W, W, 3))
    writes = 0
    for _ in range(frames):
        raw, wc = oracle.trace_frame(gb, scene.lights, scene.field_textures, brdf, gen,
                                     n, float(max(1.0, 0.1 * W)), bounces,
                                     max_bounces=bounces)
        acc += raw
        writes += int(wc)
    return acc.numpy() / frames, writes


@pytest.mark.parametrize("kind", ["bilinear", "nearest"])
def test_scatters_match_jax(kind):
    """The splats against the JAX package's matmul scatters on the same
    positions (inside, on and outside the frame) and values, in chunks:
    1e-5 of the maximum."""
    rng = np.random.default_rng(0)
    accum = rng.uniform(0, 1, (24, 40, 3)).astype(np.float32)
    pos = rng.uniform(-3, 43, (5000, 2)).astype(np.float32)
    vals = rng.uniform(0, 2, (5000, 3)).astype(np.float32)
    name = f"scatter_add_{kind}_mxu"
    ref = np.asarray(getattr(jscatter, name)(jnp.asarray(accum), jnp.asarray(pos),
                                             jnp.asarray(vals), chunk=1024))
    src = torch.from_numpy(accum)
    got = getattr(scatter, name)(src, torch.from_numpy(pos), torch.from_numpy(vals),
                                 chunk=1024)
    np.testing.assert_array_equal(src.numpy(), accum)  # not changed in place
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_sampling_matches_jax():
    """sample_nearest(_uv) elementwise (clamped at the borders) and the 2x2
    mip step on odd sizes, with and without channels."""
    rng = np.random.default_rng(1)
    field = rng.uniform(0, 1, (13, 21, 4)).astype(np.float32)
    xy = rng.uniform(-3, 25, (500, 2)).astype(np.float32)
    uv = rng.uniform(-0.2, 1.2, (500, 2)).astype(np.float32)
    f, jf = torch.from_numpy(field), jnp.asarray(field)
    np.testing.assert_array_equal(sampling.sample_nearest(f, torch.from_numpy(xy)).numpy(),
                                  np.asarray(jsampling.sample_nearest(jf, jnp.asarray(xy))))
    np.testing.assert_array_equal(
        sampling.sample_nearest_uv(f, torch.from_numpy(uv)).numpy(),
        np.asarray(jsampling.sample_nearest_uv(jf, jnp.asarray(uv))))
    for img in (field, field[..., 0]):
        np.testing.assert_allclose(
            sampling.downsample2x_mean(torch.from_numpy(img)).numpy(),
            np.asarray(jsampling.downsample2x_mean(jnp.asarray(img))), rtol=1e-6)


def test_escape_distance_matches_jax():
    rng = np.random.default_rng(2)
    origin = rng.uniform(-0.1, 1.1, (1000, 2)).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, 1000)
    direction = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32) / 64.0
    direction[:5, 0] = 0.0  # axis-aligned rays go through _nonzero_dir
    pixel = np.array([1 / 64, 1 / 48], np.float32)
    ref = joracle._escape_distance(jnp.asarray(origin),
                                   joracle._nonzero_dir(jnp.asarray(direction)),
                                   jnp.asarray(pixel))
    got = oracle._escape_distance(torch.from_numpy(origin),
                                  oracle._nonzero_dir(torch.from_numpy(direction)),
                                  torch.from_numpy(pixel))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_point_light_uniform_medium_profile(port_setup):
    """The converged raw map of a point light in a uniform medium follows
    raw(r) = W*H*t^r / (4 pi^2 r) (tests/test_oracle_physics.py:53): annulus
    means within 8%."""
    raw, writes = _port_trace(port_setup, 0, 16384, 4, 1)
    assert writes > 0 and np.all(np.isfinite(raw))
    t_texel = (1 - 10**DENSITY_LOG) ** (100 / W)
    ys, xs = np.mgrid[0:W, 0:W]
    r = np.hypot(xs + 0.5 - W / 2, ys + 0.5 - W / 2)
    expected = W * W * t_texel**r / (4 * np.pi**2 * np.maximum(r, 1e-3))
    lum = raw.mean(-1)
    for r0, r1 in [(8, 12), (14, 18), (20, 24)]:
        m = (r >= r0) & (r < r1)
        ratio = lum[m].mean() / expected[m].mean()
        assert abs(ratio - 1.0) < 0.08, (r0, r1, ratio)


def test_energy_and_writes_match_jax_in_distribution(jax_setup, port_setup):
    """One frame of 4,096 photons with 2 bounces: total deposited energy and
    write count, JAX and port means within 4 sigma of the difference over 6
    seeds a side."""
    scene, gb, brdf = jax_setup
    jax_e, jax_w, port_e, port_w = [], [], [], []
    for seed in range(6):
        raw, wc = joracle.trace_frame(gb, scene.lights, scene.field_textures, brdf,
                                      jax.random.key(seed), 4096, 6.4, jnp.int32(2),
                                      max_bounces=2)
        jax_e.append(float(np.asarray(raw, np.float64).sum()))
        jax_w.append(int(wc))
        raw, writes = _port_trace(port_setup, seed, 4096, 1, 2)
        port_e.append(float(raw.astype(np.float64).sum()))
        port_w.append(writes)
    for a, b in ((jax_e, port_e), (jax_w, port_w)):
        sigma = np.sqrt(np.var(a, ddof=1) / 6 + np.var(b, ddof=1) / 6)
        assert abs(np.mean(a) - np.mean(b)) < 4 * sigma, (a, b)


def test_same_generator_state_same_bits(port_setup):
    a, wa = _port_trace(port_setup, 7, 2048, 1, 2)
    b, wb = _port_trace(port_setup, 7, 2048, 1, 2)
    np.testing.assert_array_equal(a, b)
    assert wa == wb
    c, _ = _port_trace(port_setup, 8, 2048, 1, 2)
    assert np.abs(a - c).max() > 0  # another seed, another stream


def test_bounce_adds_energy(port_setup):
    one, _ = _port_trace(port_setup, 3, 4096, 2, 1)
    two, _ = _port_trace(port_setup, 3, 4096, 2, 2)
    assert two.sum() > one.sum() * 1.02


def test_rbt_agrees_with_oracle(port_setup):
    """The port's converged RBT against the port's oracle, 4x-downsampled
    (tests/test_rbt.py:67): total energy within 8% (the half-source-cell
    attenuation convention), median relative error under 15% where the
    signal is strong."""
    scene, gb, brdf = port_setup
    fields = rbt.precompute_rotated_fields(gb, n_bins=64)
    gen = torch.Generator().manual_seed(1)
    src = rbt.zero_sources(fields)
    for _ in range(3):
        src, _ = rbt.rbt_trace_frame(fields, src, gb, scene.lights, scene.field_textures,
                                     brdf, gen, 16384, 2, max_bounces=2)
    raw_rbt = rbt.resolve_raw(fields, src, W, W).numpy() / 3
    raw_oracle, _ = _port_trace(port_setup, 2, 16384, 3, 2)

    def down(x):
        return x.reshape(W // 4, 4, W // 4, 4, 3).mean((1, 3))

    a, b = down(raw_rbt), down(raw_oracle)
    assert abs(a.sum() / b.sum() - 1) < 0.08, (a.sum(), b.sum())
    mask = b.mean(-1) > np.percentile(b.mean(-1), 60)
    rel = np.abs(a.mean(-1) - b.mean(-1))[mask] / b.mean(-1)[mask]
    assert np.median(rel) < 0.15, float(np.median(rel))
