"""Port parity for the default-option trace: litbox_tpu_torch's emission of
every light kind, BRDF sampling, analytic and Monte-Carlo direct deposits
and unstratified bounce chains against the JAX package, at a small size on
the CPU.

Random draws differ between the packages (threefry against torch's
generator), so the Monte-Carlo stages are fed JAX's own uniforms where an
elementwise comparison is asked for, and held in distribution otherwise.
The JAX functions run jitted, as the JAX package's frame runs them (eager
dispatch of their many small operations costs seconds a call on the CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litbox_tpu.core import luts
from litbox_tpu.scene import SceneBuilder as JaxSceneBuilder
from litbox_tpu.scene import rasterize as jax_rasterize
from litbox_tpu.sim import emission as jemission
from litbox_tpu.sim import materials as jmaterials
from litbox_tpu.sim import rbt as jrbt
from litbox_tpu_torch.convert import from_numpy
from litbox_tpu_torch.scene import SceneBuilder
from litbox_tpu_torch.sim import emission, materials, rbt

W = 32
N_BINS = 32
N_PHOTONS = 4096

_jemit = jax.jit(jemission.emit, static_argnums=(5,), static_argnames=("active_kinds",))
_jmc_scatter = jax.jit(jrbt._mc_scatter_deposits, static_argnums=(4, 7),
                       static_argnames=("exclude_analytic",))
_janalytic = jax.jit(jrbt._analytic_point_deposits, static_argnums=(3,))
_jscatter = jax.jit(jmaterials.scatter_materially, static_argnames=("fast", "enable_brdf"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU work: the suite runs test files
    in parallel workers, and torch's thread pool spin-waits when they share
    the cores (a test took 11x as long)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _np_tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    return np.asarray(obj)


def _to_port(obj):
    return from_numpy(_np_tree(obj), "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def all_kinds_scene(builder_cls, w: int, seed: int = 0):
    """One light of every kind (two point lights), haze, a textured sprite
    and a rect with particle alignment (the BRDF branch), from a numpy seed."""
    rng = np.random.default_rng(seed)
    cloud = rng.uniform(0.0, 1.0, (16, 16)).astype(np.float32)
    field_tex = rng.uniform(0.0, 1.0, (8, 8, 4)).astype(np.float32)
    b = builder_cls(texture_size=16, field_texture_size=8)
    b.add_point_light((w * 0.3, w * 0.6), radius=2.0, color=(1.0, 0.8, 0.6),
                      intensity=1.5, bounces=2)
    b.add_point_light((w * 0.7, w * 0.4), radius=1.5, color=(0.5, 0.7, 1.0),
                      intensity=1.2, bounces=2)
    b.add_spot_light((w * 0.5, w * 0.8), (w * 0.06, w * 0.02), rotation=0.3,
                     color=(0.7, 1.0, 0.6), intensity=1.4, bounces=2)
    b.add_laser_light((w * 0.2, w * 0.2), (w * 0.04, w * 0.3), rotation=2.0,
                      color=(1.0, 0.2, 0.2), intensity=1.1, bounces=2)
    b.add_ambient_light(color=(0.3, 0.3, 0.4), intensity=0.6, bounces=1)
    b.add_field_light((w * 0.6, w * 0.7), (w * 0.1, w * 0.08), rotation=0.5,
                      intensity=1.3, bounces=2, texture=field_tex)
    b.add_directional_light(rotation=0.7, color=(1.0, 0.9, 0.7), intensity=0.8,
                            bounces=2)
    b.add_rect((w / 2, w / 2), (w / 2, w / 2), log_density=-1.8)
    b.add_sprite((w * 0.4, w * 0.45), (w * 0.2, w * 0.15), log_density=-0.8,
                 texture=np.stack([cloud] * 3 + [cloud], -1))
    b.add_rect((w * 0.65, w * 0.25), (w * 0.12, w * 0.05), rotation=0.4,
               color=(0.9, 0.6, 0.3, 1), log_density=0.3, alignment=0.6)
    b.add_ellipse((w * 0.25, w * 0.8), (w * 0.08, w * 0.1), rotation=0.2,
                  color=(0.2, 0.9, 0.3, 1), log_density=0.0, alignment=1.0)
    return b


@pytest.fixture(scope="module")
def jax_setup():
    scene = all_kinds_scene(JaxSceneBuilder, W).build(max_lights=8, max_shapes=4)
    gb = jax_rasterize(scene, W, W)
    fields = jrbt.precompute_rotated_fields(gb, n_bins=N_BINS, phase=0.37)
    brdf = jnp.asarray(luts.brdf_lut((32, 9, 4)))
    return scene, gb, fields, brdf


@pytest.fixture(scope="module")
def port_setup(jax_setup):
    """The JAX scene, GBuffer and fields carried across, so every difference
    below comes from the trace alone."""
    scene, gb, fields, brdf = jax_setup
    return (_to_port(scene), _to_port(gb), _to_port(fields),
            torch.from_numpy(np.array(brdf)))


def test_scene_builder_lights_match(jax_setup):
    port = all_kinds_scene(SceneBuilder, W).build(max_lights=8, max_shapes=4,
                                                  device="cpu")
    ref = jax_setup[0]
    for name in ("kind", "affine", "energy", "bounces", "tex_index", "active"):
        np.testing.assert_array_equal(getattr(port.lights, name).numpy(),
                                      np.asarray(getattr(ref.lights, name)))
    np.testing.assert_array_equal(port.field_textures.numpy(),
                                  np.asarray(ref.field_textures))


@pytest.mark.parametrize("kinds", [None, (2,), (5,), (6,), (1, 3, 4)])
def test_emit_matches_on_jax_uniforms(jax_setup, port_setup, kinds):
    """emit of every light kind, fed the (N, 5) uniforms JAX draws."""
    scene, pscene = jax_setup[0], port_setup[0]
    n = 2000
    l_idx, rays = jemission.assign_photons_to_lights(scene.lights, n)
    key = jax.random.key(3)
    ref = _jemit(scene.lights, scene.field_textures, l_idx, rays, key,
                         (W, W), jnp.float32(1.0), jnp.int32(-1),
                         active_kinds=kinds)
    r = _t(jax.random.uniform(key, (n, 5)))
    p_idx, p_rays = emission.assign_photons_to_lights(pscene.lights, n)
    np.testing.assert_array_equal(p_idx.numpy(), np.asarray(l_idx))
    np.testing.assert_array_equal(p_rays.numpy(), np.asarray(rays))
    got = emission._emit_from_uniforms(pscene.lights, pscene.field_textures,
                                       p_idx, p_rays, r, (W, W), 1.0, -1,
                                       active_kinds=kinds)
    for g, e in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n,interleave", [(2000, 4), (2003, 8), (64, 1)])
def test_assign_photons_interleave_matches(jax_setup, port_setup, n, interleave):
    """assign_photons_to_lights(lights, n, interleave) in the JAX order,
    a ragged tail included (n not a multiple of interleave)."""
    l_idx, rays = jemission.assign_photons_to_lights(jax_setup[0].lights, n,
                                                     interleave)
    p_idx, p_rays = emission.assign_photons_to_lights(port_setup[0].lights, n,
                                                      interleave)
    np.testing.assert_array_equal(p_idx.numpy(), np.asarray(l_idx))
    np.testing.assert_array_equal(p_rays.numpy(), np.asarray(rays))


def _brdf_inputs(seed, n=3000):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n)
    normal = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    ang2 = rng.uniform(0, 2 * np.pi, n)
    refl = np.stack([np.cos(ang2), np.sin(ang2)], -1).astype(np.float32)
    rough = rng.uniform(-0.1, 1.1, n).astype(np.float32)
    u = rng.uniform(0, 1, n).astype(np.float32)
    return normal, refl, rough, u


@pytest.mark.parametrize("name", ["sample_brdf", "sample_brdf_fast"])
def test_sample_brdf_matches(jax_setup, name, seed=5):
    brdf = jax_setup[3]
    args = _brdf_inputs(seed)
    ref = jax.jit(getattr(jmaterials, name))(brdf, *map(jnp.asarray, args))
    got = getattr(materials, name)(_t(brdf), *map(torch.from_numpy, args))
    for g, e in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fast", [False, True])
def test_scatter_materially_brdf_matches(jax_setup, fast):
    """Every branch: no normal, transmit, mirror, diffuse and BRDF."""
    brdf = jax_setup[3]
    rng = np.random.default_rng(6)
    n = 4000
    ang = rng.uniform(0, 2 * np.pi, n)
    length = rng.choice([0.0, 0.5, 1.0], n)
    align = rng.choice([0.0, 0.3, 0.7, 1.0], n) * length
    normal4 = np.stack([np.cos(ang) * length, np.sin(ang) * length,
                        np.zeros(n), align], -1).astype(np.float32)
    ang2 = rng.uniform(0, 2 * np.pi, n)
    incoming = np.stack([np.cos(ang2), np.sin(ang2)], -1).astype(np.float32)
    rand3 = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    ref = _jscatter(brdf, jnp.asarray(normal4), jnp.asarray(incoming),
                    jnp.asarray(rand3), fast=fast, enable_brdf=True)
    got = materials.scatter_materially(_t(brdf), torch.from_numpy(normal4),
                                       torch.from_numpy(incoming),
                                       torch.from_numpy(rand3), fast=fast,
                                       enable_brdf=True)
    for g, e in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=1e-5, rtol=1e-5)


def test_analytic_point_deposits_match(jax_setup, port_setup):
    scene, _, fields, _ = jax_setup
    pscene, _, pfields, _ = port_setup
    mask = jrbt.analytic_light_mask(scene.lights, jnp.int32(-1))
    pmask = rbt.analytic_light_mask(pscene.lights, -1)
    np.testing.assert_array_equal(pmask.numpy(), np.asarray(mask))
    assert int(pmask.sum()) == 2
    ref_f, ref_v = _janalytic(scene.lights, mask, fields, float(W * W))
    got_f, got_v = rbt._analytic_point_deposits(pscene.lights, pmask, pfields,
                                                float(W * W))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(ref_f))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), atol=1e-6, rtol=0)
    # The closed form: energy * W * H / (2 pi) for each admitted light.
    expect = (np.asarray(scene.lights.energy) * np.asarray(mask)[:, None]).sum(0)
    np.testing.assert_allclose(got_v.double().sum(0).numpy(),
                               expect * W * W / (2 * np.pi), rtol=1e-5)


def test_mc_scatter_deposits_match_on_jax_emission(jax_setup, port_setup, monkeypatch):
    """The generic MC direct phase on JAX's own emission uniforms: the port's
    `emit` is replaced by one that takes them."""
    scene, gb, fields, _ = jax_setup
    pscene, pgb, pfields, _ = port_setup
    key = jax.random.key(11)
    ref_f, ref_v = _jmc_scatter(
        scene.lights, scene.field_textures, fields, gb, N_PHOTONS, key,
        jnp.int32(-1), None, exclude_analytic=True)
    r = _t(jax.random.uniform(key, (N_PHOTONS, 5)))

    def emit_fixed(lights, ft, l_idx, rays, generator, *args, **kwargs):
        return emission._emit_from_uniforms(lights, ft, l_idx, rays, r, *args, **kwargs)

    monkeypatch.setattr(rbt, "emit", emit_fixed)
    got_f, got_v = rbt._mc_scatter_deposits(
        pscene.lights, pscene.field_textures, pfields, pgb, N_PHOTONS,
        torch.Generator().manual_seed(0), -1, None, exclude_analytic=True)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(ref_f))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), atol=1e-5, rtol=1e-5)
    # The analytic lights' photons carry nothing here.
    assert float(got_v.sum()) > 0


def _frame_energy(values) -> float:
    return float(np.asarray(values, np.float64).sum())


def test_default_trace_energy_in_distribution(jax_setup, port_setup):
    """rbt_frame_deposits with the JAX defaults (analytic + MC direct,
    unstratified bounce chains of every light kind, BRDF): total deposit
    energy per frame, JAX and port means within 4 sigma over 8 seeds."""
    scene, gb, fields, brdf = jax_setup
    jax_e = [_frame_energy(jrbt.rbt_frame_deposits(
        fields, gb, scene.lights, scene.field_textures, brdf,
        jax.random.key(200 + s), N_PHOTONS, jnp.int32(-1), max_bounces=3)[1])
        for s in range(8)]
    pscene, pgb, pfields, pbrdf = port_setup
    port_e = []
    for s in range(8):
        flat, vals, n = rbt.rbt_frame_deposits(
            pfields, pgb, pscene.lights, pscene.field_textures, pbrdf,
            torch.Generator().manual_seed(200 + s), N_PHOTONS, -1, max_bounces=3)
        assert n == N_PHOTONS
        assert int(flat.min()) >= 0 and int(flat.max()) < N_BINS * pfields.size ** 2
        port_e.append(_frame_energy(vals.double()))
    sigma = np.sqrt(np.var(jax_e, ddof=1) / 8 + np.var(port_e, ddof=1) / 8)
    assert abs(np.mean(jax_e) - np.mean(port_e)) < 4 * sigma, (jax_e, port_e)
