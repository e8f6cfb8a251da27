"""Port parity for the compositor, the cloud relight, the analysis filters
and the buffer picker: litbox_tpu_torch.post / .diag against the JAX
package on the CPU, on the same numpy inputs.

The picker's GBuffer views are held against the JAX picker reading the JAX
package's GBuffer of the same scene; its tracer views against the JAX
functions fed the port's tracer outputs (the two packages' Monte Carlo
draws differ)."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_pipeline import _flax_variables
from test_torch_simulation import SIZE, FEATURES, W, _build, _one_torch_thread  # noqa: F401

from litbox_tpu.diag import analysis as janalysis
from litbox_tpu.diag import picker as jpicker
from litbox_tpu.nn import unet as junet
from litbox_tpu.post import cloud_relight as jrelight
from litbox_tpu.post import compositor as jcompositor
from litbox_tpu.scene import SceneBuilder as JaxSceneBuilder
from litbox_tpu.scene import rasterize as jrasterize
from litbox_tpu_torch.convert import unet_from_flax
from litbox_tpu_torch.diag import analysis, picker
from litbox_tpu_torch.engine import Mode, Simulation, pipeline
from litbox_tpu_torch.post import cloud_relight, compositor
from litbox_tpu_torch.scene import SceneBuilder

# Elementwise float32 arithmetic in the same order; exp, pow and the
# 15-tap kernel's normalizing sum may round an ulp apart.
ATOL = 1e-6


def _rand(seed, shape, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _close(got, want, atol=ATOL):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=ATOL, atol=atol)


def test_compositor_matches_jax():
    bg, hdr, rgba = _rand(0, (24, 20, 3)), _rand(1, (24, 20, 3), 0, 4), _rand(2, (24, 20, 4))
    t = torch.from_numpy
    _close(compositor.composite_additive(t(bg), t(hdr)),
           jcompositor.composite_additive(jnp.asarray(bg), jnp.asarray(hdr)))
    _close(compositor.composite_premultiplied(t(bg), t(rgba)),
           jcompositor.composite_premultiplied(jnp.asarray(bg), jnp.asarray(rgba)))


@pytest.mark.parametrize("axis", [0, 1])
def test_directional_blur_matches_jax(axis):
    hdr, trans = _rand(3, (40, 36, 4), 0, 3), _rand(4, (40, 36), 0.2, 1.0)
    got = cloud_relight.directional_blur(torch.from_numpy(hdr), torch.from_numpy(trans),
                                         1.5, 2.5, 15, axis)
    _close(got, jrelight.directional_blur(jnp.asarray(hdr), jnp.asarray(trans), 1.5, 2.5,
                                          15, axis))


@pytest.mark.parametrize("depth,sigma", [(1.5, 3.0), (4.0, 2.0)])
def test_relight_and_shade_match_jax(depth, sigma):
    hdr, trans = _rand(5, (48, 40, 3), 0, 3), _rand(6, (48, 40), 0.2, 1.0)
    sprite = _rand(7, (48, 40, 4))
    blurred = cloud_relight.relight_layer(torch.from_numpy(hdr), torch.from_numpy(trans),
                                          depth, sigma)
    jblurred = jrelight.relight_layer(jnp.asarray(hdr), jnp.asarray(trans), depth, sigma=sigma)
    _close(blurred, jblurred)
    _close(cloud_relight.shade_foreground(torch.from_numpy(sprite), blurred,
                                          torch.from_numpy(trans)),
           jrelight.shade_foreground(jnp.asarray(sprite), jblurred, jnp.asarray(trans)))


def test_analysis_a_matches_jax():
    a, b = _rand(8, (32, 28, 3), 0, 2), _rand(9, (32, 28, 3), 0, 2)
    _close(analysis.analysis_a(torch.from_numpy(a), torch.from_numpy(b)),
           janalysis.analysis_a(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("channels", [0, 3])
def test_analysis_b_matches_jax(channels):
    """The 5x5 bilateral filter of a variance map (2D) and of an image (3D),
    with a variance spread over the adaptive luminance sigma's ramp."""
    shape = (32, 28) + ((channels,) if channels else ())
    prev, albedo = _rand(10, shape, 0, 2), _rand(11, (32, 28, 4))
    hdr, var = _rand(12, (32, 28, 3), 0, 3), _rand(13, (32, 28), 0, 0.8)
    params = analysis.AnalysisParameters(sigma_spatial=1.5, k_luminance=1.5)
    jparams = janalysis.AnalysisParameters(sigma_spatial=1.5, k_luminance=1.5)
    got = analysis.analysis_b(*map(torch.from_numpy, (prev, albedo, hdr, var)), params)
    _close(got, janalysis.analysis_b(*map(jnp.asarray, (prev, albedo, hdr, var)), jparams))


@pytest.fixture(scope="module")
def picked():
    """A CPU Simulation at W=48 after 2 frames, with an AIAccelerator on a
    small mono UNet whose Flax weights are carried by unet_from_flax."""
    sim = Simulation(width=W, height=W, mode=Mode.REFERENCE, rays_per_frame=2048,
                     frame_limit=2, measurement_interval=0, device="cpu")
    sim.set_scene(_build(SceneBuilder).build(max_lights=2, max_shapes=4, device="cpu"))
    flax = _flax_variables(junet.LitboxDenoiserNet(unet_size=SIZE, initial_features=FEATURES),
                           (1, 32, 32, 1), 4)
    ai = pipeline.AIAccelerator(sim, unet_from_flax(flax, unet_size=SIZE,
                                                    initial_features=FEATURES),
                                unet_size=SIZE, initial_features=FEATURES)
    sim.run()
    return sim, ai


@pytest.mark.parametrize("which", ["ALBEDO", "TRANSMISSIBILITY", "NORMAL_ROUGHNESS",
                                   "QUADTREE"])
def test_gbuffer_views_match_the_jax_picker(picked, which):
    sim, _ = picked
    jscene = _build(JaxSceneBuilder).build(max_lights=2, max_shapes=4)
    stand_in = types.SimpleNamespace(gbuffer=jrasterize(jscene, W, W))
    got = picker.pick(sim, picker.TextureType[which])
    want = jpicker.pick(stand_in, jpicker.TextureType[which])
    assert got.dtype == np.float32 and got.shape == (W, W, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_analysis_views_match_jax_on_the_port_outputs(picked):
    sim, _ = picked
    a = jnp.asarray(sim.tracer_a.tracer_output.numpy())
    b = jnp.asarray(sim.tracer_b.tracer_output.numpy())
    rel = janalysis.analysis_a(a, b)
    filtered = janalysis.analysis_b(rel, jnp.asarray(sim.gbuffer.albedo.numpy()),
                                    jnp.asarray(sim.simulation_output_hdr.numpy()), rel)
    for which, want in (("ANALYSIS_A", rel), ("ANALYSIS_B", filtered)):
        want = np.asarray(want)
        want = np.stack([want / want.max()] * 3, -1)
        got = picker.pick(sim, picker.TextureType[which])
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=which)


def test_every_view_renders_and_dumps(picked, tmp_path):
    """Every view finite, (H, W, 3) float32 at the JAX picker's sizes (the
    CV map at a quarter of the resolution, the importance pyramid's base at
    half), the AI views carrying signal; dump_all writes 12 PNGs; without an
    accelerator the AI views are black."""
    sim, ai = picked
    scale = {picker.TextureType.VARIANCE: 4, picker.TextureType.IMPORTANCE: 2}
    for which in picker.TextureType:
        img = picker.pick(sim, which, ai=ai)
        shape = (W // scale.get(which, 1), W // scale.get(which, 1), 3)
        assert img.shape == shape and img.dtype == np.float32, which
        assert np.all(np.isfinite(img)), which
    assert picker.pick(sim, picker.TextureType.AI_HDR, ai=ai).sum() > 0
    assert picker.pick(sim, picker.TextureType.FORWARD_ACCUMULATION).sum() > 0
    assert picker.pick(sim, picker.TextureType.AI_TONEMAPPED).sum() == 0
    paths = picker.dump_all(sim, str(tmp_path), ai=ai)
    assert len(paths) == 12
    for p in paths:
        assert np.asarray(Image.open(p)).ndim == 3
