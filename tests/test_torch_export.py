"""The port's export (litbox_tpu_torch.nn.export, nn.onnx_writer), tiled
inference and blends (the rest of nn.infer), the display panel and
AIAccelerator's from_checkpoint and blend_prior, against the JAX package
on the CPU with the same weights (a Flax tree drawn with numpy, carried by
convert.unet_from_flax).

- export_torch_state equals JAX's key for key, bit for bit, and
  import_torch_state inverts it; export_onnx's file equals JAX's byte for
  byte; the reference-layout module and its TorchScript give the port's
  forward to 1e-5 of its maximum.
- infer_large (mono, RGB, sub-tile), fit_blend and evaluate to 1e-5 of the
  maximum; blend_pair_banded, fit_blend_prior and blend_prior_lookup (inside
  and outside its table) to 1e-6 relative.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pipeline import _flax_variables
from test_torch_simulation import W, _Outputs, _scene, _sim

from litbox_tpu.engine import pipeline as jpipeline
from litbox_tpu.nn import export as jexport
from litbox_tpu.nn import infer as jinfer
from litbox_tpu.nn import unet as junet
from litbox_tpu_torch import convert
from litbox_tpu_torch.engine import Mode, pipeline
from litbox_tpu_torch.io import read_exr_rgb, write_exr_rgb, write_png
from litbox_tpu_torch.nn import export as texport
from litbox_tpu_torch.nn import infer as tinfer
from litbox_tpu_torch.nn import train as ttrain
from litbox_tpu_torch.nn import unet as tunet
from litbox_tpu_torch.nn.display import DenoiserDisplay

SIZE, FEATURES = 2, 4
FWD_TOL = 1e-5  # of the maximum
REL = 1e-6


def _arch(out_channels=1, global_residual=False, **kw):
    return dict(unet_size=SIZE, initial_features=FEATURES, out_channels=out_channels,
                global_residual=global_residual, **kw)


def _weights(seed, out_channels=1, global_residual=False, padding_mode="reflect",
             use_sigmoid=False):
    """(Flax tree, the port's state_dict, the port's net in eval mode)."""
    model = junet.LitboxDenoiserNet(unet_size=SIZE, initial_features=FEATURES,
                                    out_channels=out_channels,
                                    global_residual=global_residual)
    flax = _flax_variables(model, (1, 32, 32, out_channels), seed)
    arch = _arch(out_channels, global_residual)
    state = convert.unet_from_flax(flax, **arch)
    net = tunet.LitboxDenoiserNet(**arch, padding_mode=padding_mode, use_sigmoid=use_sigmoid)
    net.load_state_dict(state)
    return flax, state, net.eval()


@pytest.fixture(scope="module")
def mono():
    return _weights(0)


@pytest.fixture(scope="module")
def rgb():
    return _weights(1, out_channels=3, global_residual=True)


def _runs(flax, net, out_channels=1, global_residual=False):
    """The eval-mode forward in both packages: JAX jitted, the port's on CPU
    tensors."""
    model = junet.LitboxDenoiserNet(unet_size=SIZE, initial_features=FEATURES,
                                    out_channels=out_channels,
                                    global_residual=global_residual)
    jrun = jax.jit(lambda x: model.apply(flax, x, train=False))

    def trun(x):
        with torch.no_grad():
            return net(x)
    return jrun, trun


@pytest.mark.parametrize("global_residual", [False, True])
def test_export_torch_state_matches_jax_and_import_inverts(mono, rgb, global_residual):
    flax, state, _ = rgb if global_residual else mono
    ref = jexport.export_torch_state(flax, SIZE, global_residual=global_residual)
    got = texport.export_torch_state(state, SIZE, global_residual=global_residual)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]))
    if not global_residual:
        back = tunet.import_torch_state(got, SIZE)
        assert sorted(back) == sorted(state)
        for k in state:
            assert torch.equal(back[k], state[k]), k
        jback = convert.unet_from_flax(junet.import_torch_state(ref, SIZE), **_arch())
        for k in state:
            assert torch.equal(back[k], jback[k]), k


@pytest.mark.parametrize("padding_mode,use_sigmoid,channels", [
    ("reflect", False, 1), ("zeros", True, 1), ("reflect", False, 3)])
def test_export_onnx_matches_jax_bytes(tmp_path, mono, rgb, padding_mode, use_sigmoid,
                                       channels):
    flax, state, _ = rgb if channels == 3 else mono
    kw = dict(unet_size=SIZE, initial_features=FEATURES, padding_mode=padding_mode,
              use_sigmoid=use_sigmoid, global_residual=channels == 3)
    ours, theirs = str(tmp_path / "o.onnx"), str(tmp_path / "t.onnx")
    assert texport.export_onnx(state, ours, **kw) == ours
    jexport.export_onnx(flax, theirs, **kw)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        data = f.read()
        assert data == g.read()
    assert len(data) > 4 * sum(v.numel() for k, v in state.items() if "num_batches" not in k)


@pytest.mark.parametrize("padding_mode", ["reflect", "zeros"])
def test_reference_module_and_torchscript_match_the_port(tmp_path, padding_mode):
    flax, state, net = _weights(2, padding_mode=padding_mode)
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (2, 32, 32, 1))
                         .astype(np.float32))
    with torch.no_grad():
        ref = net(x)
        mirror = texport.build_torch_module(state, SIZE, FEATURES, padding_mode)
        got = mirror(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert float((got - ref).abs().max()) <= FWD_TOL * float(ref.abs().max())
    path = str(tmp_path / "net.pt")
    texport.export_torchscript(state, path, SIZE, FEATURES, padding_mode, example_size=32)
    loaded = torch.jit.load(path)
    with torch.no_grad():
        assert torch.equal(loaded(x.permute(0, 3, 1, 2)), mirror(x.permute(0, 3, 1, 2)))
    pth = str(tmp_path / "ref.pth")
    texport.save_torch_checkpoint(state, pth, SIZE)
    saved = torch.load(pth)
    assert sorted(saved) == sorted(mirror.state_dict())
    back = tunet.import_torch_state(saved, SIZE)
    assert all(torch.equal(back[k], state[k]) for k in state)


def _close(got, ref, tol=FWD_TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), np.abs(got - ref).max()


@pytest.mark.parametrize("shape,rgb_net,blend", [((70, 90, 3), False, 1.0),
                                                  ((70, 90, 3), True, 0.7),
                                                  ((20, 26, 3), False, 1.0)])
def test_infer_large_matches_jax(mono, rgb, shape, rgb_net, blend):
    flax, _, net = rgb if rgb_net else mono
    jrun, trun = _runs(flax, net, 3 if rgb_net else 1, rgb_net)
    img = np.random.default_rng(4).uniform(0.05, 1, shape).astype(np.float32)
    kw = dict(tile=32, overlap=8, batch=4, rgb=rgb_net, blend=blend)
    _close(tinfer.infer_large(trun, img, **kw), jinfer.infer_large(jrun, img, **kw))


def test_fit_blend_and_evaluate_match_jax(tmp_path, mono):
    flax, _, net = mono
    jrun, trun = _runs(flax, net)
    rng = np.random.default_rng(5)
    pairs = []
    for _ in range(2):
        ref = rng.uniform(0.1, 1, (40, 36, 3)).astype(np.float32)
        pairs.append(((ref + rng.normal(0, 0.2, ref.shape)).astype(np.float32), ref))
    kw = dict(tile=32, overlap=8, batch=4)
    got, want = tinfer.fit_blend(trun, pairs, **kw), jinfer.fit_blend(jrun, pairs, **kw)
    assert abs(got - want) <= FWD_TOL * max(abs(want), 1e-6) or got == want
    src = tmp_path / "in"
    src.mkdir()
    write_exr_rgb(str(src / "a.exr"), pairs[0][0])
    write_png(str(src / "b.png"), pairs[1][1])
    ours = tinfer.evaluate(trun, str(src / "*"), str(tmp_path / "ours"), tile=32, overlap=8)
    theirs = jinfer.evaluate(jrun, str(src / "*"), str(tmp_path / "theirs"), tile=32, overlap=8)
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs] == [
        "a_eval.exr", "b_eval.png"]
    _close(read_exr_rgb(ours[0]), read_exr_rgb(theirs[0]))


def _pair_outputs(seed, shape=(48, 40, 3), noise=0.2):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(0.1, 1, shape).astype(np.float32)
    ref[: shape[0] // 2] *= 0.01
    a = (ref + rng.normal(0, noise, shape) * ref).astype(np.float32)
    b = (ref + rng.normal(0, noise, shape) * ref).astype(np.float32)
    out_a = (ref + 0.3 * (a - ref) + rng.normal(0, 0.01, shape)).astype(np.float32)
    out_b = (ref + 0.3 * (b - ref) + rng.normal(0, 0.01, shape)).astype(np.float32)
    return out_a, out_b, a, b, ref


def _rel_close(got, ref, rel=REL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rel, atol=rel * np.abs(ref).max())


def _banded_outputs(seed, shape=(64, 48, 3)):
    """A pair noisy in its top half (the net removes most of that noise)
    and nearly converged in the bottom half (the net adds a bias there), so
    that the bands' k part."""
    rng = np.random.default_rng(seed)
    ref = rng.uniform(0.1, 1, shape).astype(np.float32)
    rel = np.where(np.arange(shape[0])[:, None, None] < shape[0] // 2, 0.3, 1e-3)
    a = (ref * (1 + rel * rng.normal(size=shape))).astype(np.float32)
    b = (ref * (1 + rel * rng.normal(size=shape))).astype(np.float32)
    bias = np.where(rel < 0.01, 0.05, 0.0)
    out_a = (ref + 0.2 * (a - ref) + bias).astype(np.float32)
    out_b = (ref + 0.2 * (b - ref) + bias).astype(np.float32)
    return out_a, out_b, a, b


@pytest.mark.parametrize("pool,gate", [(16, 0.01), (8, 0.03)])
def test_blend_pair_banded_matches_jax(pool, gate):
    out_a, out_b, a, b = _banded_outputs(6)
    disp, k = tinfer.blend_pair_banded(*(torch.from_numpy(x) for x in (out_a, out_b, a, b)),
                                       pool=pool, gate=gate)
    jdisp, jk = jinfer.blend_pair_banded(out_a, out_b, a, b, pool=pool, gate=gate)
    _rel_close(k, jk)
    _rel_close(disp, jdisp)
    assert 0.0 <= float(k.min()) and float(k.max()) <= 1.0 and float(k.max() - k.min()) > 0.1


def test_fit_blend_prior_and_lookup_match_jax():
    samples = [_pair_outputs(s, (24, 20, 3), noise) for s, noise in
               ((7, 0.02), (8, 0.2), (9, 0.9), (10, 0.05))]
    table = tinfer.fit_blend_prior([tuple(torch.from_numpy(x) for x in s) for s in samples])
    jtable = jinfer.fit_blend_prior(samples)
    _rel_close(table, jtable)
    assert table.shape == (6, 2)
    for out_a, out_b, a, b, _ in samples + [_pair_outputs(11, noise=0.0),
                                            _pair_outputs(12, noise=30.0)]:
        got = tinfer.blend_prior_lookup(table, torch.from_numpy(a), torch.from_numpy(b))
        want = jinfer.blend_prior_lookup(jtable, jnp.asarray(a), jnp.asarray(b))
        _rel_close(got, want)
    # outside the table at both ends, and between two knots
    t = np.array([[-4.0, 0.2], [-2.0, 0.6], [-1.0, 0.9]])
    for scale in (1e-6, 0.03, 0.3, 10.0):
        a = np.full((4, 4, 3), 1.0, np.float32)
        b = a * (1 + scale)
        _rel_close(tinfer.blend_prior_lookup(t, torch.from_numpy(a), torch.from_numpy(b)),
                   jinfer.blend_prior_lookup(t, a, b))


def test_ai_accelerator_from_checkpoint_and_blend_prior(tmp_path, mono):
    """from_checkpoint builds the net its checkpoint's TrainConfig names and
    gives the same step as the accelerator built from the weights; a
    blend_prior raises the auto k to the prior's, as the JAX package's
    AIAccelerator does on the same tracer outputs (1e-4 of the maximum)."""
    cfg = ttrain.TrainConfig(unet_size=SIZE, initial_features=FEATURES, rgb=True,
                             global_residual=True, padding_mode="zeros",
                             transform=tunet.TransformConfig(use_log_space=True))
    tr = ttrain.Trainer(cfg, device="cpu")
    x = np.random.default_rng(13).uniform(0.1, 1, (2, 16, 16, 3)).astype(np.float32)
    tr.train_batch(x, x * 0.9)
    path = str(tmp_path / "ck" / "model.npz")
    tr.save(path)
    np.save(str(tmp_path / "ck" / "model_blend_prior.npy"), np.ones((6, 2)))

    s = _sim(mode=Mode.REFERENCE, rays_per_frame=1024, measurement_interval=0, frame_limit=2)
    s.set_scene(_scene())
    acc = pipeline.AIAccelerator.from_checkpoint(s, path, blend="auto")
    assert acc.blend_prior is None and acc.model.out_channels == 3
    direct = pipeline.AIAccelerator(s, tr.model.state_dict(), unet_size=SIZE,
                                    initial_features=FEATURES, transform=cfg.transform,
                                    out_channels=3, padding_mode="zeros",
                                    global_residual=True, blend="auto")
    table = np.array([[-6.0, 0.9], [0.0, 0.95]])
    prior = pipeline.AIAccelerator(s, tr.model.state_dict(), unet_size=SIZE,
                                   initial_features=FEATURES, transform=cfg.transform,
                                   out_channels=3, padding_mode="zeros",
                                   global_residual=True, blend="auto", blend_prior=table)
    s.run()
    assert torch.equal(acc.hdr_output, direct.hdr_output)
    assert float(prior.last_blend) >= max(float(acc.last_blend), 0.9)
    a, b = s.tracer_a.tracer_output.numpy(), s.tracer_b.tracer_output.numpy()
    flax = convert.unet_to_flax(tr.model.state_dict())
    ref = jpipeline.AIAccelerator(_Outputs(a, b), flax, unet_size=SIZE,
                                  initial_features=FEATURES,
                                  transform=junet.TransformConfig(use_log_space=True),
                                  out_channels=3, padding_mode="zeros",
                                  global_residual=True, blend="auto", blend_prior=table)
    ref._on_step()
    want = np.asarray(ref.hdr_output)
    assert prior.hdr_output.shape == want.shape == (W, W, 3)
    np.testing.assert_allclose(prior.hdr_output.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(float(prior.last_blend), float(ref.last_blend), rtol=0,
                               atol=1e-5)


def test_display_writes_the_panel(tmp_path):
    out = str(tmp_path / "panel" / "p.png")
    disp = DenoiserDisplay(out_path=out)
    x = torch.rand(2, 16, 16, 1)
    disp.show(x, x * 0.5, np.asarray(x) * 2)
    disp.show(x[0], x[0], x[0])
    disp.shutdown()
    assert os.path.getsize(out) > 0
