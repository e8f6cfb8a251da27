"""The port's denoiser training (litbox_tpu_torch.nn.train, the UNet's
training mode and init) against the JAX package's nn/train.py.

- One step from JAX's init carried across (convert.unet_from_flax), mono
  and pair: the loss to 1e-5 relative, every gradient and the new
  BatchNorm running statistics to 1e-5 of the largest magnitude in their
  tree (the conv biases before a BatchNorm have a gradient of 0 up to
  rounding, so no tensor is held to its own maximum); JAX's gradients come
  from jax.value_and_grad of the JAX Trainer's own loss, written out here.
- The optimizer chain against the JAX Trainer's optax chain over 5 updates
  of the same gradient trees, clip on and off, norms above and below
  grad_clip, constant and scheduled lr: parameters and moments to 1e-6
  relative (of each tensor's maximum).
- Checkpoints across packages: a JAX checkpoint gives the port the same
  eval_fn output to 1e-5; a port checkpoint, optimizer included, resumes in
  JAX's Trainer to the port's next loss (1e-5 relative).
- In distribution: the port's Flax init, identity at init under
  global_residual, and the loss falling over 20 steps on a tiny corpus.
"""

import contextlib
import copy
import dataclasses
import glob

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from litbox_tpu.nn import loss as jloss
from litbox_tpu.nn import train as jtrain
from litbox_tpu.nn import unet as junet
from litbox_tpu_torch import convert
from litbox_tpu_torch.engine.pipeline import denoise_hdr
from litbox_tpu_torch.io import write_exr_rgb, write_png
from litbox_tpu_torch.nn import train as ttrain
from litbox_tpu_torch.nn import unet as tunet
from litbox_tpu_torch.nn.dataset import DenoiserDataset
from litbox_tpu_torch.nn.infer import infer_large
from litbox_tpu_torch.nn.loss import HdrLossConfig
from litbox_tpu_torch.ops import conv

STEP_TOL = 1e-5   # of the largest magnitude in a tree
OPT_REL = 1e-6

MONO = dict(unet_size=2, initial_features=4, crop_size=16, batch_size=2)
# runs/train_denoiser_r5.py's recipe (SMOKE off) at a small width.
PAIR = dict(unet_size=2, initial_features=4, crop_size=16, batch_size=2, rgb=True,
            global_residual=True, pair_composition=True, raw_loss_weight=0.5,
            lr_decay_steps=40, lr_min=3e-7, warmup_steps=2, learn_rate=1.5e-5)
PAIR_LOSS = dict(normalize_weights=True, log_l1=0.25, rel_l2=1.0, compress="log1p")
PAIR_TRANSFORM = dict(use_log_space=True, normalize_input=True)


def _configs(arch: dict, loss: dict | None = None, transform: dict | None = None):
    j = jtrain.TrainConfig(**arch, loss=jloss.HdrLossConfig(**(loss or {})),
                           transform=junet.TransformConfig(**(transform or {})))
    t = ttrain.TrainConfig(**arch, loss=HdrLossConfig(**(loss or {})),
                           transform=tunet.TransformConfig(**(transform or {})))
    return j, t


@contextlib.contextmanager
def _jitted_flax_init():
    """Flax's model.init, jitted (eager it takes ~25 s on the CPU)."""
    orig = flax_nn.Module.init

    def init(self, rngs, *args, **kwargs):
        return jax.jit(lambda r, *a: orig(self, r, *a, **kwargs))(rngs, *args)

    flax_nn.Module.init = init
    try:
        yield
    finally:
        flax_nn.Module.init = orig


def _jax_trainer(cfg):
    with _jitted_flax_init():
        return jtrain.Trainer(cfg)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_trainer(tcfg, jt=None):
    """A CPU Trainer of the port, with the JAX trainer's weights when given."""
    tr = ttrain.Trainer(tcfg, device="cpu")
    if jt is not None:
        state = convert.unet_from_flax(
            {"params": _np_tree(jt.params), "batch_stats": _np_tree(jt.batch_stats)},
            unet_size=tcfg.unet_size, initial_features=tcfg.initial_features,
            out_channels=3 if tcfg.rgb else 1, global_residual=tcfg.global_residual)
        tr.model.load_state_dict(state)
    return tr


@pytest.fixture(scope="module")
def mono():
    jcfg, tcfg = _configs(MONO)
    return jcfg, tcfg, _jax_trainer(jcfg)


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _configs(PAIR, PAIR_LOSS, PAIR_TRANSFORM)
    return jcfg, tcfg, _jax_trainer(jcfg)


def _batch(seed, n, c, size=16):
    """HDR-like (n, size, size, c) inputs with exact zeros and a target."""
    rng = np.random.default_rng(seed)
    ref = rng.exponential(0.6, (n, size, size, c)).astype(np.float32)
    noisy = (ref * rng.exponential(1.0, ref.shape)).astype(np.float32)
    noisy[rng.uniform(size=ref.shape) < 0.15] = 0.0
    return noisy, ref


def _assert_trees_close(got: dict, ref: dict, tol: float, what: str):
    """Every leaf within tol of the largest magnitude in ref's tree."""
    got, ref = _flat(got), _flat(ref)
    assert sorted(got) == sorted(ref), what
    scale = max(float(np.abs(np.asarray(r)).max()) for r in ref.values())
    for k in ref:
        err = float(np.abs(np.asarray(got[k]) - np.asarray(ref[k])).max())
        assert err <= tol * scale, (what, k, err, scale)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _port_grads(tr) -> dict:
    return convert.unet_to_flax({k: p.grad for k, p in tr.params.items()})["params"]


def _port_stats(tr) -> dict:
    return convert.unet_to_flax(tr.model.state_dict())["batch_stats"]


def _jax_mono_step(jcfg, jt, x, y):
    """The JAX Trainer's _build_step loss, its gradients and the new
    running statistics."""
    def loss_fn(p):
        xin, stats = junet.pre_transform(x, jcfg.transform)
        out, upd = jt.model.apply({"params": p, "batch_stats": jt.batch_stats}, xin,
                                  train=True, mutable=["batch_stats"])
        pred = junet.post_transform(out, stats, jcfg.transform)
        return jloss.hdr_loss(pred, y, jcfg.loss), upd["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jt.params)
    return loss, grads, stats


def test_mono_step_matches_jax(mono):
    jcfg, tcfg, jt = mono
    x, y = _batch(0, 2, 1)
    loss, grads, stats = _jax_mono_step(jcfg, jt, x, y)
    tr = _port_trainer(tcfg, jt)
    got = tr.train_batch_async(x, y)
    assert abs(float(got) - float(loss)) <= STEP_TOL * abs(float(loss))
    _assert_trees_close(_port_grads(tr), _np_tree(grads), STEP_TOL, "grads")
    _assert_trees_close(_port_stats(tr), _np_tree(stats), STEP_TOL, "running stats")
    assert tr.global_step == 1 and int(tr.optimizer.state["count"]) == 1


def test_gradients_match_jax_without_an_update(mono):
    """Trainer.gradients (what a step and chip_smoke.py's gate take): the
    loss and every gradient as the JAX step's, the weights not moved."""
    jcfg, tcfg, jt = mono
    x, y = _batch(1, 2, 1)
    loss, grads, _ = _jax_mono_step(jcfg, jt, x, y)
    tr = _port_trainer(tcfg, jt)
    before = {k: p.detach().clone() for k, p in tr.params.items()}
    got = tr.gradients(tr.loss, x, y)
    assert not got.requires_grad
    assert abs(float(got) - float(loss)) <= STEP_TOL * abs(float(loss))
    _assert_trees_close(_port_grads(tr), _np_tree(grads), STEP_TOL, "grads")
    assert all(torch.equal(p, before[k]) for k, p in tr.params.items())
    assert tr.global_step == 0 and int(tr.optimizer.state["count"]) == 0


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_step_convolutions_turn_cudnn_off_on_a_card_only(device, monkeypatch):
    """step_convolutions turns cuDNN off for a CUDA device only (a device
    name, no card needed) and restores the setting, on an error too."""
    monkeypatch.setattr(torch.backends.cudnn, "enabled", True)
    with conv.step_convolutions(device):
        assert torch.backends.cudnn.enabled == (device == "cpu")
    assert torch.backends.cudnn.enabled
    with pytest.raises(KeyError), conv.step_convolutions(torch.device(device)):
        raise KeyError
    assert torch.backends.cudnn.enabled


def test_pair_step_matches_jax(pair):
    """The composition step from JAX's init with conv_out's kernel drawn
    small (the init's zero kernel makes the pair's corrections rounding
    noise), on a batch whose per-crop k lies inside (0, 1) for both items,
    so that the stop-gradient through k shows in the gradients."""
    jcfg, tcfg, jt = pair
    a, ref = _batch(33, 2, 3)
    b = (ref * np.random.default_rng(34).exponential(1.0, ref.shape)).astype(np.float32)
    tr = _port_trainer(tcfg, jt)
    with torch.no_grad():
        w = tr.model.conv_out.weight
        w.copy_(torch.from_numpy(np.random.default_rng(63).uniform(-0.01, 0.01, tuple(w.shape))
                                 .astype(np.float32)))
    start = convert.unet_to_flax(tr.model.state_dict())

    def loss_fn(p):  # the JAX Trainer's _build_pair_step loss
        nb = a.shape[0]
        xin, stats = junet.pre_transform(jnp.concatenate([a, b]), jcfg.transform)
        out, upd = jt.model.apply({"params": p, "batch_stats": start["batch_stats"]}, xin,
                                  train=True, mutable=["batch_stats"])
        pred = junet.post_transform(out, stats, jcfg.transform)
        out_a, out_b = pred[:nb], pred[nb:]
        d_a, d_b = out_a - a, out_b - b
        dbar = (d_a + d_b) * 0.5
        num = ((d_a - d_b) * (b - a)).sum((1, 2, 3)) * 0.25
        ratio = num / jnp.maximum((dbar * dbar).sum((1, 2, 3)), 1e-12)
        k = jax.lax.stop_gradient(jnp.clip(ratio, 0.0, 1.0))
        disp = (a + b) * 0.5 + k.reshape(-1, 1, 1, 1) * dbar
        total = jloss.hdr_loss(disp, ref, jcfg.loss) + jcfg.raw_loss_weight * jloss.hdr_loss(
            (out_a + out_b) * 0.5, ref, jcfg.loss)
        return total, (upd["batch_stats"], ratio)

    (loss, (stats, ratio)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        start["params"])
    assert np.all((np.asarray(ratio) > 0.05) & (np.asarray(ratio) < 0.95)), ratio
    got = tr.train_batch_pair_async(a, b, ref)
    assert abs(float(got) - float(loss)) <= STEP_TOL * abs(float(loss))
    _assert_trees_close(_port_grads(tr), _np_tree(grads), STEP_TOL, "grads")
    _assert_trees_close(_port_stats(tr), _np_tree(stats), STEP_TOL, "running stats")


@contextlib.contextmanager
def _shape_only_flax_init():
    """Flax's model.init replaced by zeros of its shapes (jax.eval_shape):
    for JAX Trainers whose optax chain alone is used."""
    orig = flax_nn.Module.init

    def init(self, rngs, *args, **kwargs):
        shapes = jax.eval_shape(lambda r, *a: orig(self, r, *a, **kwargs), rngs, *args)
        return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    flax_nn.Module.init = init
    try:
        yield
    finally:
        flax_nn.Module.init = orig


@pytest.mark.parametrize("clip,scale,schedule", [
    (1.0, 3.0, False), (1.0, 0.3, False), (0.0, 3.0, False),
    (1.0, 3.0, True), (1.0, 0.3, True), (0.0, 0.3, True)])
def test_optimizer_matches_optax(clip, scale, schedule):
    """5 updates of the same gradient trees through the JAX Trainer's optax
    chain and the port's Optimizer; `scale` puts the gradients' global norm
    above (3.0) or below (0.3) grad_clip."""
    arch = dict(MONO, grad_clip=clip, learn_rate=1e-3, weight_decay=0.01)
    if schedule:
        arch.update(lr_decay_steps=4, warmup_steps=2, lr_min=1e-4)
    jcfg, tcfg = _configs(arch)
    with _shape_only_flax_init():
        tx = jtrain.Trainer(jcfg).tx
    rng = np.random.default_rng(7)
    names = dict(tunet.LitboxDenoiserNet(2, 4).named_parameters())
    params = {k: rng.normal(0, 0.3, v.shape).astype(np.float32) for k, v in names.items()}
    jp = dict(params)
    state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = ttrain.Optimizer(tp, tcfg)
    for step in range(5):
        g = {k: rng.normal(0, 1, v.shape).astype(np.float32) for k, v in params.items()}
        norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in g.values()))
        g = {k: (v * (scale / norm)).astype(np.float32) for k, v in g.items()}
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step({k: torch.from_numpy(v) for k, v in g.items()})
        adam = state[2][0]
        for got, ref, what in ((tp, jp, "params"), (opt.state["mu"], adam.mu, "mu"),
                               (opt.state["nu"], adam.nu, "nu")):
            for k in ref:
                r = np.asarray(ref[k])
                err = float(np.abs(got[k].numpy() - r).max())
                assert err <= OPT_REL * float(np.abs(r).max()), (step, what, k, err)
        assert int(opt.state["count"]) == int(adam.count) == step + 1
        if schedule:
            assert int(opt.state["schedule_count"]) == int(state[2][1].count)


@pytest.mark.parametrize("warmup", [0, 3])
def test_lr_schedule_matches_optax(warmup):
    lr, decay, lo = 1.5e-5, 40, 3e-7
    ref = optax.warmup_cosine_decay_schedule(
        init_value=lr * 0.1 if warmup else lr, peak_value=lr, warmup_steps=warmup,
        decay_steps=decay, end_value=lo)
    fn = ttrain.lr_schedule(ttrain.TrainConfig(learn_rate=lr, lr_decay_steps=decay,
                                               warmup_steps=warmup, lr_min=lo))
    for count in (0, 1, 2, 3, 4, 10, 39, 40, 41, 100):
        got = float(fn(torch.tensor(count, dtype=torch.int32)))
        assert abs(got - float(ref(jnp.int32(count)))) <= OPT_REL * lr, count
    assert ttrain.lr_schedule(ttrain.TrainConfig(learn_rate=lr)) == lr


def test_jax_checkpoint_loads_into_port(tmp_path, mono):
    jcfg, tcfg, jt = mono
    jt2 = copy.copy(jt)
    x, y = _batch(4, 2, 1)
    jt2.train_batch(x, y)
    path = str(tmp_path / "jax" / "model.npz")
    jt2.save(path)
    cfg = ttrain.load_train_config(path)
    assert cfg == tcfg
    tr = ttrain.Trainer(cfg, device="cpu")
    tr.load(path)
    ref = np.asarray(jt2.eval_fn()(x))
    got = tr.eval_fn()(x).numpy()
    assert np.abs(got - ref).max() <= STEP_TOL * np.abs(ref).max()
    assert int(tr.optimizer.state["count"]) == 1


def test_port_checkpoint_resumes_in_jax(tmp_path, pair):
    jcfg, tcfg, jt = pair
    tr = _port_trainer(tcfg, jt)
    a, ref = _batch(5, 2, 3)
    b = (ref * 1.3).astype(np.float32)
    for _ in range(2):
        tr.train_batch_pair_async(a, b, ref)
    path = str(tmp_path / "port" / "model.npz")
    tr.save(path)
    z = np.load(path)
    assert {"opt:2/0/.count", "opt:2/1/.count"} <= set(z.files)
    assert all(k.split(":")[0] in ("params", "stats", "opt") for k in z.files)
    assert jtrain.load_train_config(path) == jcfg
    resumed = copy.copy(jt)  # a Trainer of the same TrainConfig
    resumed.load(path)
    assert int(resumed.opt_state[2][0].count) == 2 and int(resumed.opt_state[2][1].count) == 2
    _assert_trees_close(_np_tree(resumed.opt_state[2][0].nu),
                        convert.unet_to_flax(tr.optimizer.state["nu"])["params"], 0.0, "nu")
    a2, ref2 = _batch(6, 2, 3)
    b2 = (ref2 * 0.7).astype(np.float32)
    ours = float(tr.train_batch_pair_async(a2, b2, ref2))
    theirs = float(resumed.train_batch_pair_async(a2, b2, ref2))
    assert abs(ours - theirs) <= STEP_TOL * abs(theirs)
    # and the step after that, which reads the resumed moments and counts
    a3, ref3 = _batch(7, 2, 3)
    ours = float(tr.train_batch_pair_async(a3, a3 * 0.9, ref3))
    theirs = float(resumed.train_batch_pair_async(a3, a3 * 0.9, ref3))
    assert abs(ours - theirs) <= STEP_TOL * abs(theirs)


def test_resume_matches_the_uninterrupted_run(tmp_path):
    """Save after two steps and load into a Trainer that has stepped already
    (its optimizer's tensors in use): load copies into the optimizer's own
    tensors, which the card's update kernel keeps pointers to, and the next
    step gives the uninterrupted run's parameters, moments and counts bit
    for bit."""
    _, tcfg = _configs(dict(MONO, lr_decay_steps=10, warmup_steps=2))
    run = ttrain.Trainer(tcfg, device="cpu")
    batches = [_batch(20 + i, 2, 1) for i in range(3)]
    for x, y in batches[:2]:
        run.train_batch_async(x, y)
    path = str(tmp_path / "resume" / "model.npz")
    run.save(path)
    resumed = ttrain.Trainer(tcfg, device="cpu")
    resumed.train_batch_async(*_batch(30, 2, 1))
    st = resumed.optimizer.state
    held = [st["count"], st["schedule_count"], *st["mu"].values(), *st["nu"].values()]
    resumed.load(path)
    assert all(a is b for a, b in zip(held, [st["count"], st["schedule_count"],
                                             *st["mu"].values(), *st["nu"].values()]))
    assert int(st["count"]) == int(st["schedule_count"]) == 2
    for tr in (run, resumed):
        tr.train_batch_async(*batches[2])
    for name, t in run.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[name], t), name
    for key in ("count", "schedule_count"):
        assert torch.equal(st[key], run.optimizer.state[key])
    for moment in ("mu", "nu"):
        for k, t in run.optimizer.state[moment].items():
            assert torch.equal(st[moment][k], t), (moment, k)


# A layer's sample std has a standard error of about 1/sqrt(2 n) of itself:
# layers of at least 3200 values are held alone to 5% (4 standard errors);
# the smaller ones are pooled, each value over its layer's sqrt(1/fan_in).
ALONE = 3200


def test_init_is_flax_lecun_normal():
    """Each conv kernel's std within 5% of sqrt(1/fan_in), nothing beyond
    Flax's truncation at 2 sqrt(1/fan_in) / 0.8796, zero biases, BatchNorm
    at 1 and 0, and under global_residual a zero conv_out."""
    cfg = ttrain.TrainConfig(unet_size=2, initial_features=8)
    tr = ttrain.Trainer(cfg, device="cpu")
    pooled, alone = [], 0
    with torch.no_grad():
        for name, m in tr.model.named_modules():
            if isinstance(m, torch.nn.Conv2d):
                w = m.weight
                target = w[0].numel() ** -0.5
                assert float(w.abs().max()) <= 2 * target / 0.87962566103423978 * (1 + 1e-6)
                if w.numel() >= ALONE:
                    assert abs(float(w.std()) / target - 1) < 0.05, (name, float(w.std()))
                    alone += 1
                else:
                    pooled.append((w / target).flatten())
                assert float(m.bias.abs().max()) == 0.0
            elif isinstance(m, torch.nn.BatchNorm2d):
                assert torch.equal(m.weight, torch.ones_like(m.weight))
                assert float(m.bias.abs().max()) == 0.0
                assert float(m.running_mean.abs().max()) == 0.0
                assert torch.equal(m.running_var, torch.ones_like(m.running_var))
    pooled = torch.cat(pooled)
    assert alone >= 4 and pooled.numel() >= ALONE
    assert abs(float(pooled.std()) - 1) < 0.05
    w0 = tr.model.conv_in.conv.weight
    assert torch.equal(w0, ttrain.Trainer(cfg, device="cpu").model.conv_in.conv.weight)
    other = ttrain.Trainer(dataclasses.replace(cfg, seed=1), device="cpu")
    assert not torch.equal(w0, other.model.conv_in.conv.weight)
    gr = ttrain.Trainer(dataclasses.replace(cfg, global_residual=True), device="cpu")
    assert float(gr.model.conv_out.weight.abs().max()) == 0.0


def test_rgb_global_residual_identity_at_init_and_trains():
    """As tests/test_training.py:202-235 for the JAX package."""
    cfg = ttrain.TrainConfig(unet_size=2, initial_features=4, crop_size=32, batch_size=2,
                             rgb=True, padding_mode="zeros", global_residual=True,
                             transform=tunet.TransformConfig(normalize_input=True))
    trainer = ttrain.Trainer(cfg, device="cpu")
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    y = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    assert np.isfinite(trainer.train_batch(x, y))

    fresh = ttrain.Trainer(cfg, device="cpu")
    hdr = torch.from_numpy(rng.uniform(0.1, 1, (40, 48, 3)).astype(np.float32))
    den = denoise_hdr(fresh.model, None, hdr, cfg.transform)
    assert den.shape == hdr.shape
    torch.testing.assert_close(den, hdr, atol=1e-3, rtol=0)

    img = rng.uniform(0, 1, (70, 90, 3)).astype(np.float32)
    out = infer_large(fresh.eval_fn(), img, tile=32, overlap=8, rgb=True)
    assert out.shape == img.shape and np.all(np.isfinite(out))
    np.testing.assert_allclose(out[8:-8, 8:-8], img[8:-8, 8:-8], atol=1e-3)


@pytest.fixture(scope="module")
def tiny_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    for i in range(3):
        ref = rng.uniform(0, 2, (48, 48, 3)).astype(np.float32)
        write_exr_rgb(str(root / f"output_{i:03d}.exr"), ref)
        for t in "ab":
            noisy = np.abs(ref + rng.normal(0, 0.3, ref.shape)).astype(np.float32)
            write_exr_rgb(str(root / f"input_{t}_{i:03d}.exr"), noisy)
        write_png(str(root / f"albedo_{i:03d}.png"), rng.uniform(0, 1, (48, 48, 3)))
        write_exr_rgb(str(root / f"trans_{i:03d}.exr"), rng.uniform(0.5, 1, (48, 48, 3)))
    return root


def test_loss_falls_over_20_steps(tiny_corpus):
    """As tests/test_training.py:74-94 for the JAX package."""
    cfg = ttrain.TrainConfig(unet_size=2, initial_features=4, crop_size=32,
                             learn_rate=3e-4, epochs=50, batch_size=2)
    trainer = ttrain.Trainer(cfg, device="cpu")
    ds = DenoiserDataset(*(sorted(glob.glob(str(tiny_corpus / f"{p}_*")))
                           for p in ("input_a", "input_b", "albedo", "trans", "output")),
                         crop_size=32)
    rng = np.random.default_rng(0)
    losses = []
    while len(losses) < 20:
        for batch in ds.batches(2, rng):
            inp, tgt = trainer.select_random_channel(batch, rng, "cpu")
            losses.append(trainer.train_batch(inp, tgt))
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])


def test_fit_runs_the_curriculum(tiny_corpus, tmp_path):
    cfg = ttrain.TrainConfig(unet_size=1, initial_features=4, crop_size=16, epochs=2,
                             batch_size=2, checkpoint_interval=0.0)
    trainer = ttrain.Trainer(cfg, device="cpu")
    ds = DenoiserDataset(*(sorted(glob.glob(str(tiny_corpus / f"{p}_*")))
                           for p in ("input_a", "input_b", "albedo", "trans", "output")),
                         crop_size=16)
    seen = []
    log = trainer.fit([("Easy", ds), ("Final", ds)], checkpoint_folder=str(tmp_path),
                      on_checkpoint=seen.append, log_every=0.0, max_steps=3)
    assert trainer.global_step == 3 and len(log) == 3
    assert [e["curriculum"] for e in log] == ["Easy", "Easy", "Final"]
    assert all(np.isfinite(e["loss"]) for e in log) and len(seen) == 3
    assert glob.glob(str(tmp_path / "*" / "model.msgpack.npz"))
