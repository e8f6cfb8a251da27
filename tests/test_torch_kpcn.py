"""KPCN on the port (nn/kpcn.py, ops/kpn.py, DeviceStages.sample_kpcn,
Trainer.train_batch_kpcn_async) against litbench/reference/kpcn.py, the
plain PyTorch reference that decides the kpcn-21-train cell's `correct`, at
a small size on the CPU with the Trainer's seeded random weights: 3 layers
of 8 features at 5x5, a 7x7 reconstruction, 2 patches of 17^2. A reference
with raw logits in place of the softmax's weights must not agree.

On the card (`-m cuda`; this file imports neither JAX nor the JAX package):

    python -m pytest --noconftest -m cuda tests/test_torch_kpcn.py

the reconstruction kernels at the cell's shape (64 patches of 65^2, a 21x21
window) against the reference's unfold path, bit for bit across calls.
"""

import copy
import os

import pytest
import torch

from litbench import core as bench_core
from litbench.reference import kpcn as ref
from litbench.traffic.kpcn_steps import train_config
from litbox_tpu_torch.core import spans
from litbox_tpu_torch.nn import device_data, kpcn
from litbox_tpu_torch.nn.train import Trainer, TrainConfig
from litbox_tpu_torch.ops import cuda_lib, kpn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = dict(layers=3, features=8, kernel_size=5, recon_kernel=7, crop_size=17, batch_size=2)
STEPS = 3
# Tolerances, of float32 on the CPU. The port and the reference run the same
# convolutions (F.conv2d on the CPU), the same softmax and unfold; they
# differ in the order of the loss's mean and in Adam's rounding (the port's
# update rounds each operation of optax's chain alone, reference/pair.py
# update writes it out): an ulp here and there.
# - the features and the logits: a few ulps of each tensor's largest value
#   (4 x 2^-23; they came out equal bit for bit);
# - the reconstruction and its gradient to the logits: 1e-6 of the largest
#   value (the same composition on both sides);
# - the backward kernel's formula (ops.kpn.backward_plain) against autograd:
#   1e-5 of the largest value (g . x_{p+q} - g . o_p subtracts two sums of
#   the size of g . o_p, whose last bits do not cancel; 1.8e-6 seen);
# - the losses, relative: 1e-6, the first gradient, of its norm: 1e-5, and
#   the change after 3 steps, of its norm: 1e-4 (Adam's first steps move a
#   parameter by about lr x sign(g), so an ulp of a gradient near Adam's eps
#   moves the change most). Over 8 seeds the sound readings stayed at or
#   below 1.5e-7 (loss), 0 (grad) and 3.2e-5 (update), and the formula's at
#   1.9e-6.
# The reference with raw logits as weights read a loss gap of 0.44 and more,
# first-gradient and update gaps of 0.99 and more.
FEATURE_TOL = 4 * torch.finfo(torch.float32).eps
RECON_TOL, FORMULA_TOL = 1e-6, 1e-5
LOSS_TOL, GRAD_TOL, UPDATE_TOL = 1e-6, 1e-5, 1e-4
SEEDS = (2 ** 31 + 5, 7, 2 ** 40 + 3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell_config() -> dict:
    cfg = copy.deepcopy(bench_core.load_json(os.path.join(ROOT, "litbench", "configs",
                                                          "kpcn-21.json")))
    cfg.update(SIZE)
    return cfg


def _stage(seed: int, scenes: int = 3, size: int = 32) -> tuple:
    """(a, b, ref, albedo, trans) CPU tensors: positive tracers around a
    reference, albedo and transmissibility in [0, 1]."""
    g = torch.Generator().manual_seed(seed)
    r = torch.exp(torch.randn((scenes, size, size, 3), generator=g))
    noisy = lambda: r * torch.exp(0.3 * torch.randn(r.shape, generator=g))  # noqa: E731
    a, b = noisy(), noisy()
    return (a, b, r, torch.rand((scenes, size, size, 3), generator=g),
            torch.rand((scenes, size, size, 1), generator=g))


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def test_the_published_net_has_the_papers_parameters():
    """9 layers of 5x5 at 100 features from litbox's 22 channels to 441
    logits: 2,908,741 parameters, as the configuration states."""
    net = kpcn.KPCN()
    assert sum(p.numel() for p in net.parameters()) == 2908741
    assert _cell_config()["parameters"] == 2908741
    assert [c.weight.shape[0] for c in net.convs] == [100] * 8 + [441]
    assert kpcn.conv_shapes(64, 65, 65) == [(64, 22, 100, 65, 65, 5, 2),
                                            (64, 100, 100, 65, 65, 5, 2),
                                            (64, 100, 441, 65, 65, 5, 2)]


@pytest.mark.parametrize("seed", SEEDS)
def test_features_from_the_same_draws_match_the_reference(seed):
    """DeviceStages.sample_kpcn's batch against the plain sampler on the
    same draws, bit for bit, quarter turns included; the port's 22 features
    of it against the reference's."""
    stages = device_data.DeviceStages({"Final": _stage(seed)}, device="cpu")
    data = stages.data["Final"]
    g = torch.Generator().manual_seed(seed + 1)
    turns = set()
    for _ in range(3):
        state = g.get_state()
        got = stages.sample_kpcn("Final", g, 6, 17)
        g2 = torch.Generator()
        g2.set_state(state)
        d = device_data.draw(g2, data[0].shape, 6, 17, 0.0)
        turns |= set(d.rot.tolist())
        want = ref.sample(data, d, 17)
        assert all(x.shape == y.shape and torch.equal(x, y) for x, y in zip(got, want))
        feats, colour = kpcn.features(*got[:4])
        rfeats, rcolour = ref.features(*want[:4])
        assert feats.shape == (6, 22, 17, 17) and feats.is_contiguous()
        assert _rel(feats, rfeats) <= FEATURE_TOL and _rel(colour, rcolour) <= FEATURE_TOL
        # The last column of an x difference and the last row of a y one are 0.
        assert not feats[:, 8:15, :, -1].any() and not feats[:, 15:, -1, :].any()
    assert turns - {0}, "no quarter turn drawn"


def test_a_stage_without_albedo_cannot_feed_kpcn():
    stages = device_data.DeviceStages({"Final": _stage(1)[:3]}, device="cpu")
    with pytest.raises(ValueError, match="albedo"):
        stages.sample_kpcn("Final", torch.Generator().manual_seed(0), 2, 17)


def _trainer(cfg: dict, seed: int) -> Trainer:
    return Trainer(train_config(cfg, seed), device="cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_the_nets_logits_match_the_reference(seed):
    cfg = _cell_config()
    trainer = _trainer(cfg, seed)
    p = trainer.model.state_dict()
    assert {k for k, _ in ref.layout(cfg)} == set(p)
    assert all(float(p[f"convs.{i}.bias"].abs().max()) == 0 for i in range(cfg["layers"]))
    feats = ref.features(*_stage(seed)[:2], *_stage(seed)[3:])[0]
    with torch.no_grad():
        got = trainer.model(feats)
        want = ref.trunk(p, feats, cfg)
    assert got.shape == (3, 49, 32, 32)
    assert _rel(got, want) <= FEATURE_TOL


def _logits_and_colour(seed: int, n: int = 2, k: int = 7, size: int = 17):
    g = torch.Generator().manual_seed(seed)
    logits = 3.0 * torch.randn((n, k * k, size, size), generator=g)
    colour = torch.log1p(torch.rand((n, 3, size, size), generator=g) * 4.0)
    return logits, colour


@pytest.mark.parametrize("seed", SEEDS)
def test_reconstruction_and_its_gradient_match_the_reference(seed):
    """ops.kpn.kernel_apply on CPU tensors (the plain composition) against
    the reference's, forward and gradient to the logits; the backward
    kernel's formula (backward_plain) against autograd; the colour gets no
    gradient."""
    logits, colour = _logits_and_colour(seed)
    g = torch.randn((2, 3, 17, 17), generator=torch.Generator().manual_seed(seed + 1))
    z = logits.clone().requires_grad_()
    c = colour.clone().requires_grad_()
    out = kpn.kernel_apply(z, c)
    out.backward(g)
    zr = logits.clone().requires_grad_()
    want = ref.reconstruct(zr, colour)
    want.backward(g)
    assert _rel(out.detach(), want.detach()) <= RECON_TOL
    assert _rel(z.grad, zr.grad) <= RECON_TOL
    assert _rel(kpn.backward_plain(logits, colour, g), zr.grad) <= FORMULA_TOL
    assert c.grad is None


def test_the_reference_without_the_softmax_disagrees():
    """The control: raw logits as the weights (no softmax) do not give the
    port's reconstruction."""
    logits, colour = _logits_and_colour(SEEDS[0])
    n, taps, h, w = logits.shape
    cols = torch.nn.functional.unfold(colour, 7, padding=3).reshape(n, 3, taps, h * w)
    raw = (logits.reshape(n, 1, taps, h * w) * cols).sum(2).reshape(n, 3, h, w)
    assert _rel(kpn.kernel_apply(logits, colour), raw) > 0.1


def test_the_kernels_take_what_they_can_and_raise_before_the_build(monkeypatch):
    """Meta tensors stand in for CUDA ones: what the kernels do not take
    raises before the library is built."""
    def no_build():
        raise AssertionError("the kernel library was built")

    monkeypatch.setattr(cuda_lib, "library", no_build)
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    cases = [((meta(2, 48, 9, 9), meta(2, 3, 9, 9)), "odd K x K"),
             ((meta(2, 49, 9, 9), meta(2, 1, 9, 9)), "colour"),
             ((meta(2, 49, 9, 9), meta(2, 3, 9)), "4-d"),
             ((meta(1, 441, 4, 4096), meta(1, 3, 4, 4096)), "shared memory"),
             ((meta(2, 49, 9, 9), meta(2, 3, 9, 9)), "expected CUDA")]
    for args, match in cases:
        with pytest.raises(ValueError, match=match):
            kpn.kernel_apply(*args)
    assert kpn.smem_bytes(65, 21) == 4 * 3 * 22 * 85


def _port_steps(cfg: dict, seed: int) -> tuple:
    """STEPS KPCN steps of the port: the parameters it drew, the losses,
    first gradient and change, and the batches fed; the step records'
    counters."""
    rec = spans.Recorder()
    trainer = _trainer(cfg, seed)
    init = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    stages = device_data.DeviceStages({"Final": _stage(seed)}, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    got, batches = {"losses": []}, []
    for s in range(STEPS):
        batch = stages.sample_kpcn("Final", gen, cfg["batch_size"], cfg["crop_size"])
        with _recording(rec):
            got["losses"].append(float(trainer.train_batch_kpcn_async(*batch)))
        batches.append(batch)
        if s == 0:
            got["first_grad"] = {k: m / 0.1 for k, m in trainer.optimizer.state["mu"].items()}
    got["delta"] = {k: (p.detach() - init[k]) for k, p in trainer.params.items()}
    return init, got, batches, rec


class _recording:
    """Route the module-level spans through `rec` for a block."""

    def __init__(self, rec):
        self.rec = rec

    def __enter__(self):
        self.saved = spans.span, spans.step, spans.count
        spans.span, spans.step, spans.count = self.rec.span, self.rec.step, self.rec.count

    def __exit__(self, *exc):
        spans.span, spans.step, spans.count = self.saved


def _gaps(got: dict, want: dict) -> dict:
    from litbench.traffic.pair_steps import distance

    return {"loss": max(abs(g - w) / abs(w) for g, w in zip(got["losses"], want["losses"])),
            "grad": distance(got["first_grad"], want["first_grad"]),
            "update": distance(got["delta"], want["delta"])}


@pytest.fixture(scope="module")
def port_run():
    cfg = _cell_config()
    return (cfg,) + _port_steps(cfg, SEEDS[0])


def test_three_trainer_steps_match_the_reference(port_run):
    cfg, init, got, batches, rec = port_run
    gaps = _gaps(got, ref.train(init, batches, cfg))
    assert gaps["loss"] <= LOSS_TOL and gaps["grad"] <= GRAD_TOL, gaps
    assert gaps["update"] <= UPDATE_TOL, gaps
    # Something moved in every leaf, and the loss fell.
    assert all(float(g.abs().max()) > 0 for g in got["first_grad"].values())
    assert got["losses"][-1] < got["losses"][0]
    # Each step's records: the features' and the reconstruction's spans
    # inside the forward, the features' bytes.
    records = rec.step_records()
    assert len(records) == STEPS
    for r in records:
        assert r.find("data.features").parent == "train.forward"
        assert r.find("train.kernel_apply").parent == "train.forward"
        assert r.counts["data.features_bytes"] == 4 * 2 * 17 * 17 * (22 + 3)


def test_the_reference_with_raw_logits_is_not_the_port(port_run, monkeypatch):
    """The control on the whole step: the reference's reconstruction with
    raw logits as weights disagrees with the port beyond the tolerances."""
    cfg, init, got, batches, _ = port_run

    def raw(logits, colour):
        n, taps, h, w = logits.shape
        cols = torch.nn.functional.unfold(colour, 7, padding=3).reshape(n, 3, taps, h * w)
        return (logits.reshape(n, 1, taps, h * w) * cols).sum(2).reshape(n, 3, h, w)

    monkeypatch.setattr(ref, "reconstruct", raw)
    gaps = _gaps(got, ref.train(init, batches, cfg))
    assert gaps["loss"] > LOSS_TOL and gaps["grad"] > GRAD_TOL, gaps


def test_unet_configs_save_as_before(tmp_path):
    """A UNet checkpoint's saved TrainConfig has no `kpcn` key (the JAX
    package loads it), and a KPCN trainer refuses to save one."""
    import json

    t = Trainer(TrainConfig(unet_size=2, initial_features=4), device="cpu")
    t.save(str(tmp_path / "m.npz"))
    with open(tmp_path / "m.npz.json") as f:
        assert "kpcn" not in json.load(f)
    with pytest.raises(ValueError, match="KPCN"):
        _trainer(_cell_config(), 1).save(str(tmp_path / "k.npz"))


# ----- on the card -----


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 21, 65, 65), (3, 7, 17, 33), (2, 21, 9, 130)])
def test_kernels_match_the_reference(dev, shape):
    """The reconstruction kernels against the reference's unfold path on
    the card (TF32 off), forward and gradient to the logits within 1e-5 of
    the largest value; two calls equal bit for bit; two launches counted."""
    torch.backends.cuda.matmul.allow_tf32 = False
    n, k, h, w = shape
    g = torch.Generator(device=dev).manual_seed(n * k)
    logits = 3.0 * torch.randn((n, k * k, h, w), generator=g, device=dev)
    colour = torch.log1p(4.0 * torch.rand((n, 3, h, w), generator=g, device=dev))
    gout = torch.randn((n, 3, h, w), generator=g, device=dev)

    def run(fn):
        z = logits.clone().requires_grad_()
        out = fn(z, colour)
        out.backward(gout)
        return out.detach(), z.grad

    before = kpn.kernel_apply.launches
    got, again, want = run(kpn.kernel_apply), run(kpn.kernel_apply), run(ref.reconstruct)
    torch.cuda.synchronize()
    assert kpn.kernel_apply.launches == before + 4
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert _rel(got[0], want[0]) <= 1e-5 and _rel(got[1], want[1]) <= 1e-5
