"""Port parity for the deterministic multi-bounce cascade
(litbox_tpu_torch/sim/dom.py against the JAX package's sim/dom.py) at 48x48,
S=128, on the CPU.

Off the TPU the JAX package takes other branches than the port: an
associative scan, a dense bilinear rotate-back and a gathered forward
rotation. The port takes the TPU's branches everywhere (the scan K1, then
`rotate_bins`, K2 and K3), so dom_bounce_sources is held elementwise, to
1e-5 of its maximum, against the same loop written with the JAX package's
TPU pieces (the interpreted Pallas scan and `rotate_bins`), and against the
JAX package's own CPU cascade on the scene's direct sources in mass (2%)
and mean absolute difference (1% of the mean). Both branches of
`_forward_rotate` are held elementwise, and the integrator's DOM mode
against its Monte-Carlo bounce mode (tests/test_dom.py)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_rbt import _to_port

import litbox_tpu.sim.dom as jdom
from litbox_tpu.ops.attnscan import attenuation_scan_rows as jax_scan
from litbox_tpu.ops.resample import gather_bilinear_mxu
from litbox_tpu.ops.rotate import rotate_bins as jax_rotate_bins
from litbox_tpu.scene import SceneBuilder as JaxSceneBuilder
from litbox_tpu.scene import rasterize as jax_rasterize
from litbox_tpu.sim import rbt as jrbt
from litbox_tpu_torch.core import luts
from litbox_tpu_torch.scene import SceneBuilder, rasterize
from litbox_tpu_torch.sim import rbt
from litbox_tpu_torch.sim.dom import _forward_rotate, dom_bounce_sources
from litbox_tpu_torch.sim.tracers import RBTForwardIntegrator

W = 48
N_BINS = 8
TOL = 1e-5  # of the maximum: float32 roundings of one composition


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud():
    rng = np.random.default_rng(0)
    cloud = rng.uniform(0.2, 1.0, (64, 64)).astype(np.float32)
    for _ in range(2):
        cloud = (np.roll(cloud, 1, 0) + np.roll(cloud, -1, 0)
                 + np.roll(cloud, 1, 1) + np.roll(cloud, -1, 1) + cloud) / 5.0
    return np.stack([cloud] * 3 + [cloud], -1)


def _medium(builder_cls, bounces=2):
    """tests/test_dom.py's scene: a point light in a cloudy sprite, a medium
    with no normal field."""
    b = builder_cls(texture_size=64)
    b.add_point_light((W * 0.5, W * 0.5), radius=2.0, intensity=2.0, bounces=bounces)
    b.add_sprite((W / 2, W / 2), (W / 2, W / 2), color=(1, 1, 1, 1), log_density=-0.7,
                 texture=_cloud())
    return b


@pytest.fixture(scope="module")
def jax_case():
    """The JAX GBuffer and 8-bin fields of the medium scene, the port's
    copies, and 3 x (D, S, S) direct sources drawn with numpy."""
    gb = jax_rasterize(_medium(JaxSceneBuilder).build(max_lights=1, max_shapes=1), W, W)
    fields = jrbt.precompute_rotated_fields(gb, n_bins=N_BINS)
    s = fields.size
    rng = np.random.default_rng(3)
    src = tuple((rng.uniform(0, 1, (N_BINS, s, s)) * (rng.uniform(0, 1, (N_BINS, s, s)) < 0.2))
                .astype(np.float32) for _ in range(3))
    return gb, fields, src, _to_port(gb), _to_port(fields)


def _jax_forward_rotate_tpu(fields, world):
    """dom.py:70-78, the TPU branch: rotate_bins of the centre-embedded map."""
    s, d = fields.size, fields.n_bins
    oy, ox = (s - W) // 2, (s - W) // 2
    emb = jnp.zeros((s, s, 3)).at[oy:oy + W, ox:ox + W].set(world)
    angles = (jnp.arange(d, dtype=jnp.float32) + fields.phase) * (2.0 * np.pi / d)
    return jax_rotate_bins(jnp.broadcast_to(emb[None], (d, s, s, 3)), angles)


def _jax_dom_tpu(fields, gb, src, n_waves):
    """dom.py:111-134 with the JAX package's TPU pieces: the interpreted
    Pallas scan (rbt.py:897-901), rotate_back's traced-phase rotate_bins
    (rbt.py:936-958) and the forward rotate above."""
    s, d = fields.size, fields.n_bins
    albedo = gb.albedo[..., :3] / d
    trans = fields.trans
    oy = ox = (s - W) // 2
    lo, hi = (oy // 64) * 64, min(-(-(oy + W) // 64) * 64, s)
    back = -(jnp.arange(d, dtype=jnp.float32) + fields.phase) * (2.0 * np.pi / d)
    src_w = tuple(jnp.asarray(c) for c in src)
    out = tuple(jnp.zeros_like(c) for c in src_w)
    for _ in range(n_waves):
        dep = jnp.stack(jax_scan(trans, *src_w), axis=-1)
        incoming = jnp.pad(dep[:, :, :-1, :], ((0, 0), (0, 0), (1, 0), (0, 0)))
        interact = (incoming * (1.0 - trans)[..., None]
                    + jnp.stack(src_w, -1) * (1.0 - jnp.sqrt(trans))[..., None])
        flux = jax_rotate_bins(interact, back, reduce_rows=(lo, hi))
        flux = flux[oy - lo:oy - lo + W, ox:ox + W]
        rotated = _jax_forward_rotate_tpu(fields, flux * albedo)
        rotated = jnp.roll(rotated, 1, axis=2).at[:, :, 0, :].set(0.0)
        src_w = tuple(rotated[..., c] for c in range(3))
        out = tuple(o + c for o, c in zip(out, src_w))
    return out


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=tol * np.abs(ref).max())


def test_forward_rotate_shear_branch_matches_jax_tpu(jax_case):
    """S=128 with even embedding offsets: rotate_bins of the embedded map at
    +(d + phase)*2pi/D against the JAX TPU branch, 1e-5 of the maximum."""
    _, fields, _, _, pfields = jax_case
    world = np.random.default_rng(4).uniform(0, 1, (W, W, 3)).astype(np.float32)
    ref = _jax_forward_rotate_tpu(fields, jnp.asarray(world))
    _close(_forward_rotate(pfields, torch.from_numpy(world), W, W).numpy(), ref)


def test_forward_rotate_gather_branch_matches_jax(monkeypatch):
    """S=96 (not a multiple of 128): the masked bilinear gather against the
    JAX function's own branch with its gather in float32, 1e-5 of the
    maximum."""
    gb = jax_rasterize(_medium(JaxSceneBuilder).build(max_lights=1, max_shapes=1), W, W)
    fields = jrbt.precompute_rotated_fields(gb, n_bins=N_BINS, rot_size=96)
    world = np.random.default_rng(5).uniform(0, 1, (W, W, 3)).astype(np.float32)
    monkeypatch.setattr(jdom, "gather_bilinear_mxu",
                        functools.partial(gather_bilinear_mxu, precision="f32"))
    ref = jdom._forward_rotate(fields, jnp.asarray(world), W, W)
    got = _forward_rotate(_to_port(fields), torch.from_numpy(world), W, W).numpy()
    _close(got, ref)
    assert np.abs(got).max() > 0.5


def test_dom_sources_match_jax_tpu_composition(jax_case):
    """Two waves of dom_bounce_sources against the JAX TPU composition on
    the same fields and sources: 1e-5 of the maximum."""
    gb, fields, src, pgb, pfields = jax_case
    ref = _jax_dom_tpu(fields, gb, src, n_waves=2)
    got = dom_bounce_sources(pfields, pgb, tuple(torch.from_numpy(c) for c in src), n_waves=2)
    for g, r in zip(got, ref):
        _close(g.numpy(), r)


def test_dom_sources_match_jax_cpu(jax_case):
    """Against the JAX package's own CPU cascade (another scan, a dense
    bilinear rotate-back, a gathered forward rotation, bf16 gathers) on the
    scene's direct sources (the analytic point light's, traced by the port
    and fed to both): on the resolved bounce light, mass within 2% and mean
    absolute difference within 1% of the mean, per wave count and channel.
    (The two interpolations lie further apart on the sparse random sources
    of the elementwise test: 1.2-1.3% in mass and mean difference.)"""
    gb, fields, _, pgb, pfields = jax_case
    scene = _medium(SceneBuilder).build(max_lights=1, max_shapes=1, device="cpu")
    src, _ = rbt.rbt_trace_frame(
        pfields, rbt.zero_sources(pfields), pgb, scene.lights, scene.field_textures,
        torch.from_numpy(luts.brdf_lut((16, 5, 3))), torch.Generator().manual_seed(0), 0,
        -1, max_bounces=1, analytic_direct=True, mc_direct=False)
    for waves in (1, 2):
        ref = jdom.dom_bounce_sources(fields, gb, tuple(jnp.asarray(c.numpy()) for c in src),
                                      n_waves=waves)
        got = dom_bounce_sources(pfields, pgb, src, n_waves=waves)
        ref = rbt.resolve_raw(pfields, _to_port(ref), W, W).numpy()
        got = rbt.resolve_raw(pfields, got, W, W).numpy()
        for c in range(3):
            g, r = got[..., c], ref[..., c]
            assert abs(g.sum() / r.sum() - 1) < 0.02, (waves, c, g.sum(), r.sum())
            assert np.abs(g - r).mean() < 0.01 * r.mean(), (waves, c)


def test_dom_sources_deterministic_and_linear(jax_case):
    """Zero variance: two calls equal bit for bit; linear in the direct
    sources: twice the sources give twice the output, to 1e-5."""
    _, _, src, pgb, pfields = jax_case
    src = tuple(torch.from_numpy(c) for c in src)
    a = dom_bounce_sources(pfields, pgb, src)
    b = dom_bounce_sources(pfields, pgb, src)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    doubled = dom_bounce_sources(pfields, pgb, tuple(2.0 * c for c in src))
    for x, y in zip(doubled, a):
        np.testing.assert_allclose(x.numpy(), 2.0 * y.numpy(), rtol=1e-5, atol=1e-7)


def _integrate(scene, gb, dom, bounces, frames=12, rays=8192):
    t = RBTForwardIntegrator(n_bins=16)
    t.gbuffer = gb
    t.rays_to_emit = rays
    t.max_bounces = bounces
    t.dom_bounce = dom
    t.dom_refresh = 4
    gen = torch.Generator().manual_seed(3)
    for _ in range(frames):
        t.integrate(scene, gen)
    return t


@pytest.mark.parametrize("bounces", [2, 3])
def test_dom_integrator_mode_matches_mc(bounces):
    """RBTForwardIntegrator with dom_bounce: direct-only tracing plus the
    cascade (one wave, or two) accumulates the same output as the
    Monte-Carlo bounce mode within 5% (tests/test_dom.py), and two DOM runs
    agree bit for bit."""
    scene = _medium(SceneBuilder, bounces).build(max_lights=1, max_shapes=1, device="cpu")
    gb = rasterize(scene, W, W)
    mc = _integrate(scene, gb, False, bounces).output_hdr.numpy()
    t = _integrate(scene, gb, True, bounces)
    dom = t.output_hdr.numpy()
    assert t._dom_active() and t._dom_waves == bounces - 1 and t._dom_it == 12
    assert abs(dom.sum() / mc.sum() - 1.0) < 0.05, (dom.sum(), mc.sum())
    np.testing.assert_array_equal(_integrate(scene, gb, True, bounces).output_hdr.numpy(),
                                  dom)


@pytest.mark.parametrize("option", ["jitter_bins", "n_tracers"])
def test_dom_unsupported_options_raise(option):
    """The JAX package's two NotImplementedErrors: DOM with the jitter-phase
    ladder, and DOM with more than one tracer."""
    scene = _medium(SceneBuilder).build(max_lights=1, max_shapes=1, device="cpu")
    gb = rasterize(scene, W, W)
    opts = {"n_tracers": 2} if option == "n_tracers" else {}
    t = RBTForwardIntegrator(n_bins=8, **opts)
    t.gbuffer = gb
    t.rays_to_emit = 64
    t.dom_bounce = True
    t.jitter_bins = option == "jitter_bins"
    match = "jitter" if option == "jitter_bins" else "per-tracer"
    with pytest.raises(NotImplementedError, match=match):
        t.integrate(scene, torch.Generator().manual_seed(0))
