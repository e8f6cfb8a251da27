"""Port parity for the display half of the frame and the frame as a whole:
litbox_tpu_torch's UNet, transforms, tone maps, denoise_hdr and
make_frame_fn against the JAX package, at a small size on the CPU (UNet
size 2 with 4 features, W=32, D=32).

The deterministic stages are held elementwise, with the Flax weights
carried across by convert.unet_from_flax. The frame is Monte Carlo with
different generators, so its HDR energy is held in distribution."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litbox_tpu.core import luts
from litbox_tpu.engine import pipeline as jpipe
from litbox_tpu.nn import unet as junet
from litbox_tpu.post import tonemap as jtone
from litbox_tpu.scene import SceneBuilder as JaxSceneBuilder
from litbox_tpu.scene import rasterize as jax_rasterize
from litbox_tpu.sim import rbt as jrbt
from litbox_tpu_torch.convert import from_numpy, unet_from_flax
from litbox_tpu_torch.engine import pipeline
from litbox_tpu_torch.nn import unet
from litbox_tpu_torch.post import tonemap
from litbox_tpu_torch.sim import rbt
from test_torch_trace import _np_tree, all_kinds_scene

W = 32
N_BINS = 32
SIZE, FEATURES = 2, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU work: the suite runs test files
    in parallel workers, and torch's thread pool spin-waits when they share
    the cores (a test took 11x as long)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flax_variables(model, shape, seed: int):
    """The variable tree that the model's Flax init makes for an input of
    `shape` (through jax.eval_shape, so the initializers are not compiled),
    every leaf drawn with numpy from `seed`: conv kernels N(0, 1/fan_in),
    BatchNorm scale and var in [0.5, 1.5), biases and means in [-0.2, 0.2),
    so that every tensor's mapping is exercised."""
    tree = jax.eval_shape(lambda: model.init(jax.random.key(0), jnp.zeros(shape),
                                             train=False))
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "kernel":
                fan_in = int(np.prod(v.shape[:-1]))
                out[k] = rng.normal(0, fan_in ** -0.5, v.shape).astype(np.float32)
            elif k in ("scale", "var"):
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                out[k] = rng.uniform(-0.2, 0.2, v.shape).astype(np.float32)
        return out

    return walk(tree)


@functools.cache
def _flax_net(out_channels: int = 1, global_residual: bool = False):
    model = junet.LitboxDenoiserNet(unet_size=SIZE, initial_features=FEATURES,
                                    out_channels=out_channels,
                                    global_residual=global_residual)
    return model, _flax_variables(model, (1, 32, 32, out_channels), 0)


def _flax_apply(model, variables, x):
    return np.asarray(jax.jit(lambda v, y: model.apply(v, y, train=False))(
        variables, jnp.asarray(x)))


def _port_net(variables, **arch):
    net = unet.LitboxDenoiserNet(unet_size=SIZE, initial_features=FEATURES, **arch)
    net.load_state_dict(unet_from_flax(variables, unet_size=SIZE,
                                       initial_features=FEATURES, **arch))
    return net.eval()


@pytest.mark.parametrize("out_channels,global_residual", [(1, False), (3, True)])
def test_unet_forward_matches_flax(out_channels, global_residual):
    model, variables = _flax_net(out_channels, global_residual)
    x = np.random.default_rng(1).uniform(0, 2, (2, 64, 32, out_channels)).astype(np.float32)
    ref = _flax_apply(model, variables, x)
    net = _port_net(variables, out_channels=out_channels,
                    global_residual=global_residual)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == x.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_unet_options_and_pixel_shuffle():
    """padding_mode and use_sigmoid carried through; pixel_shuffle in NHWC
    equals the JAX one."""
    model = junet.LitboxDenoiserNet(unet_size=1, initial_features=4,
                                    padding_mode="replicate", use_sigmoid=True)
    variables = _flax_variables(model, (1, 16, 16, 1), 2)
    x = np.random.default_rng(3).uniform(0, 1, (1, 16, 16, 1)).astype(np.float32)
    ref = _flax_apply(model, variables, x)
    arch = dict(unet_size=1, initial_features=4, padding_mode="replicate",
                use_sigmoid=True)
    net = unet.LitboxDenoiserNet(**arch)
    net.load_state_dict(unet_from_flax(variables, **arch))
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)
    y = np.random.default_rng(4).normal(size=(2, 3, 5, 8)).astype(np.float32)
    np.testing.assert_array_equal(unet.pixel_shuffle(torch.from_numpy(y)).numpy(),
                                  np.asarray(junet.pixel_shuffle(jnp.asarray(y))))
    with pytest.raises(ValueError):
        unet_from_flax(variables, unet_size=2, initial_features=4)


@pytest.mark.parametrize("log,norm", [(False, False), (True, False),
                                      (False, True), (True, True)])
def test_pre_post_transform_match(log, norm):
    cfg_j = junet.TransformConfig(use_log_space=log, normalize_input=norm)
    cfg_p = unet.TransformConfig(use_log_space=log, normalize_input=norm)
    x = np.random.default_rng(5).uniform(0, 3, (3, 8, 12, 1)).astype(np.float32)
    ref, ref_stats = junet.pre_transform(jnp.asarray(x), cfg_j)
    got, stats = unet.pre_transform(torch.from_numpy(x), cfg_p)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
    y = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)
    ref = junet.post_transform(jnp.asarray(y), ref_stats, cfg_j)
    got = unet.post_transform(torch.from_numpy(y), stats, cfg_p)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


def test_tonemaps_match():
    x = np.concatenate([np.zeros(3), np.logspace(-6, 3, 2000),
                        -np.ones(2)]).astype(np.float32)
    pairs = [(tonemap.tonemap_ue5(torch.from_numpy(x)), jtone.tonemap_ue5(jnp.asarray(x))),
             (tonemap.tonemap_ue5(torch.from_numpy(x), tonemap.UE5Shape(1.0, 2.0, -3.0)),
              jtone.tonemap_ue5(jnp.asarray(x), jtone.UE5Shape(1.0, 2.0, -3.0))),
             (tonemap.tonemap_uchimura(torch.from_numpy(x)),
              jtone.tonemap_uchimura(jnp.asarray(x))),
             (tonemap.srgb_encode(torch.from_numpy(x)), jtone.srgb_encode(jnp.asarray(x)))]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("out_channels,blend", [(1, 1.0), (3, 0.6)])
def test_denoise_hdr_non_multiple_of_32(out_channels, blend):
    """A 40 x 50 image: reflect-padded to 64 x 64, cropped back; the RGB net
    with its global residual."""
    residual = out_channels == 3
    model, variables = _flax_net(out_channels, residual)
    hdr = np.random.default_rng(7).uniform(0, 4, (40, 50, 3)).astype(np.float32)
    tcfg = junet.TransformConfig(normalize_input=True)
    ref = np.asarray(jax.jit(lambda v, x: jpipe.denoise_hdr(
        model, v, x, tcfg, blend=blend))(variables, jnp.asarray(hdr)))
    net = _port_net(variables, out_channels=out_channels, global_residual=residual)
    got = pipeline.denoise_hdr(net, None, torch.from_numpy(hdr),
                               unet.TransformConfig(normalize_input=True), blend=blend)
    assert got.shape == (40, 50, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    # The same through functional variables on a module without weights.
    with torch.device("meta"):
        bare = unet.LitboxDenoiserNet(unet_size=SIZE, initial_features=FEATURES,
                                      out_channels=out_channels,
                                      global_residual=residual)
    state = unet_from_flax(variables, unet_size=SIZE, initial_features=FEATURES,
                           out_channels=out_channels, global_residual=residual)
    again = pipeline.denoise_hdr(bare, state, torch.from_numpy(hdr),
                                 unet.TransformConfig(normalize_input=True), blend=blend)
    torch.testing.assert_close(again, got, atol=0, rtol=0)


def test_denoise_pair_hdr_matches():
    model, variables = _flax_net(1, False)
    rng = np.random.default_rng(8)
    a, b = (rng.uniform(0, 2, (36, 30, 3)).astype(np.float32) for _ in range(2))
    tcfg = junet.TransformConfig()
    ref = jax.jit(lambda v, x, y: jpipe.denoise_pair_hdr(model, v, x, y, tcfg))(
        variables, jnp.asarray(a), jnp.asarray(b))
    got = pipeline.denoise_pair_hdr(_port_net(variables), None, torch.from_numpy(a),
                                    torch.from_numpy(b), unet.TransformConfig())
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-4 * np.abs(r).max())


@pytest.fixture(scope="module")
def frame_setup():
    scene = all_kinds_scene(JaxSceneBuilder, W).build(max_lights=8, max_shapes=4)
    gb = jax_rasterize(scene, W, W)
    fields = jrbt.precompute_rotated_fields(gb, n_bins=N_BINS)
    brdf = jnp.asarray(luts.brdf_lut((16, 5, 3)))
    model, variables = _flax_net(1, False)
    cfg_j = jpipe.PipelineConfig(n_photons=2048, unet_size=SIZE,
                                 initial_features=FEATURES, exposure=0.5)
    cfg_p = pipeline.PipelineConfig(n_photons=2048, unet_size=SIZE,
                                    initial_features=FEATURES, exposure=0.5)
    jframe = jpipe.make_frame_fn(cfg_j, gb, scene.lights, scene.field_textures,
                                 brdf, fields, model_variables=variables)
    port = [from_numpy(_np_tree(x), "cpu") for x in (scene, gb, fields)]
    pframe = pipeline.make_frame_fn(
        cfg_p, port[1], port[0].lights, port[0].field_textures,
        torch.from_numpy(np.array(brdf)), port[2],
        model_variables=unet_from_flax(variables, unet_size=SIZE,
                                       initial_features=FEATURES))
    return jframe, pframe, fields, port[2], variables, model, scene, gb, brdf


def test_frame_hdr_energy_in_distribution(frame_setup):
    """Two frames of the whole pipeline per seed, 8 seeds: the HDR's total
    energy, JAX and port means within 4 sigma; display in [0, 1].

    Off the TPU the JAX package resolves with a dense bilinear rotation,
    which differs from the port's three shears by interpolation (about 0.5%
    of the mass here; test_torch_rbt holds the two within 2%). So the JAX
    sources are resolved by the port's resolve_hdr stage, and that HDR is
    the one held in distribution: the comparison then sees the trace's
    Monte Carlo alone. The JAX frame function runs the second frame of the
    first seed, and its HDR is held to the port-resolved one within 2%; the
    other frames run the JAX trace alone, with the frame's options (its
    dense resolve on the CPU costs 1.5 s a call)."""
    jframe, pframe, jfields, pfields = frame_setup[:4]
    jscene, jgb, jbrdf = frame_setup[6:]

    def jtrace(src, key):
        return jrbt.rbt_trace_frame(jfields, src, jgb, jscene.lights,
                                    jscene.field_textures, jbrdf, key, 2048,
                                    jnp.int32(-1), max_bounces=2)[0]

    jax_e, port_e = [], []
    for seed in range(8):
        src = jtrace(jrbt.zero_sources(jfields), jax.random.key(100 * seed))
        if seed == 0:
            src, _, hdr = jframe(src, jnp.float32(2.0), jax.random.key(1))
        else:
            src = jtrace(src, jax.random.key(100 * seed + 1))
        psrc = rbt.zero_sources(pfields)
        gen = torch.Generator().manual_seed(seed)
        for i in range(2):
            psrc, pdisplay, phdr = pframe(psrc, float(i + 1), gen)
        jax_hdr = pframe.stages["resolve_hdr"](
            tuple(torch.from_numpy(np.array(c)) for c in src), 2.0)
        jax_e.append(float(jax_hdr.double().sum()))
        if seed == 0:
            assert abs(float(np.asarray(hdr, np.float64).sum()) / jax_e[-1] - 1) < 0.02
        port_e.append(float(phdr.double().sum()))
        assert phdr.shape == (W, W, 3) and pdisplay.shape == (W, W, 3)
        assert bool(torch.isfinite(pdisplay).all()) and bool(torch.isfinite(phdr).all())
        assert float(pdisplay.min()) >= 0 and float(pdisplay.max()) <= 1
        assert float(phdr.min()) >= 0
    sigma = np.sqrt(np.var(jax_e, ddof=1) / 8 + np.var(port_e, ddof=1) / 8)
    assert abs(np.mean(jax_e) - np.mean(port_e)) < 4 * sigma, (jax_e, port_e)


def test_frame_tail_matches_on_shared_hdr(frame_setup):
    """The deterministic tail of both frame functions on one HDR image,
    elementwise, stage by stage: the denoiser to 1e-4 of its output's
    largest magnitude, as the UNet tests hold it, and the tone map with the
    frame's exposure on the same denoised image to 1e-6. (Their composite is
    not held to one absolute bound: near the tone map's toe a UNet difference
    of 1e-6 of the largest magnitude grows to 1e-4 of the display.)"""
    _, pframe, _, _, variables, model = frame_setup[:6]
    hdr = np.random.default_rng(10).uniform(0, 3, (W, W, 3)).astype(np.float32)
    tcfg = junet.TransformConfig()
    ref = np.asarray(jax.jit(lambda v, x: jpipe.denoise_hdr(model, v, x, tcfg))(
        variables, jnp.asarray(hdr)))
    stages = pframe.stages
    got = stages["denoise"](torch.from_numpy(hdr))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    ref = jtone.tonemap_ue5(jnp.asarray(got.numpy()) * (10.0 ** 0.5),
                            jtone.UE5Shape(exposure=0.0))
    np.testing.assert_allclose(stages["tonemap"](got).numpy(), np.asarray(ref),
                               atol=1e-6, rtol=1e-6)
