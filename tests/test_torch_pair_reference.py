"""The round-5 pair recipe on the port against litbench/reference/pair.py,
the plain PyTorch reference that decides the unet4-rgb-pair-train cell's
`correct`: the on-device sampler against the plain sampler on the same
draws, and three scheduled pair steps (DeviceStages.sample_pair, then
Trainer.train_batch_pair_async) against the reference's, at a small size
on the CPU with seeded random weights (conv_out not zero). The reference
with a term of the recipe left out must not agree.

This file imports neither JAX nor the JAX package.
"""

import copy
import os

import numpy as np
import pytest
import torch

from litbench import core as bench_core
from litbench.reference import pair as ref
from litbench.reference import train as ref_train
from litbench.reference import unet
from litbench.traffic.pair_steps import train_config
from litbox_tpu_torch.nn import device_data
from litbox_tpu_torch.nn.train import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = dict(unet_size=3, initial_features=8, crop_size=32, batch_size=2)
STEPS = 3
# Tolerances, of float32 on the CPU. The port and the reference run the same
# convolutions; they differ in the order of their reductions and in the
# rounding of log2, 2^x, the learning rate and Adam (reference/pair.py), an
# ulp here and there. At this size the bottleneck's BatchNorm sees 64 values
# a channel, so an ulp that moves one ReLU across 0 there moves a leaf's
# gradient by up to a few 1e-3 (a 1-ulp change of one input moved it by
# 1.4% on one seed's batch). Over 12 seeds the sound readings reached 2.3e-7
# (loss), 2.5e-3 (grad) and 1.9e-3 (update); the reference without its raw
# term or its log L1 read a loss gap of 0.14 and more, and at a constant lr
# 3.4e-4 and more, with an update gap of 0.47 and more:
# - the losses, relative: 1e-5;
# - the first gradient and the parameters' change after the last step,
#   each leaf's norm against the reference's, over the larger of that and
#   the median leaf's (reference.train.worst_leaf; the change over the
#   leaves whose gradient is not rounding alone, moving_leaves): 1e-2.
LOSS_TOL, GRAD_TOL, UPDATE_TOL = 1e-5, 1e-2, 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell_config() -> dict:
    """The cell's configuration at SIZE, with a schedule that moves within
    STEPS updates (warm-up of 2, cosine over 10)."""
    cfg = copy.deepcopy(bench_core.load_json(os.path.join(ROOT, "litbench", "configs",
                                                          "unet4-rgb-pair.json")))
    cfg.update(SIZE, warmup_steps=2, lr_decay_steps=10)
    cfg["net"].update(unet_size=SIZE["unet_size"], initial_features=SIZE["initial_features"])
    return cfg


def _stages(seed: int, scenes: int = 3, size: int = 40) -> dict:
    """Positive HDR tracers around a reference, as numpy stage arrays."""
    rng = np.random.default_rng(seed)
    r = np.exp(rng.normal(0.0, 1.0, (scenes, size, size, 3))).astype(np.float32)
    noisy = lambda: (r * np.exp(rng.normal(0.0, 0.3, r.shape))).astype(np.float32)  # noqa: E731
    return {"Final": (noisy(), noisy(), r)}


@pytest.mark.parametrize("rgb", [True, False])
@pytest.mark.parametrize("identity_p", [0.0, 0.5, 1.0])
def test_sampler_matches_the_plain_sampler(rgb, identity_p):
    data = tuple(torch.as_tensor(x) for x in _stages(1)["Final"])
    g = torch.Generator().manual_seed(7)
    for _ in range(3):
        d = device_data.draw(g, data[0].shape, 6, 16, identity_p)
        got = device_data.sample_batch_pair_from(*data, d, 16, rgb)
        want = ref.sample_pair(*data, d, 16, rgb=rgb)
        for x, y in zip(got, want):
            assert x.shape == y.shape and torch.equal(x, y)
        if identity_p == 1.0:
            assert torch.equal(got[0], got[2]) and torch.equal(got[1], got[2])
    assert bool(d.flag.any()) == (identity_p > 0) and d.swap.any() and not d.swap.all()


def _port_steps(cfg: dict, seed: int) -> tuple[dict, dict, list]:
    """STEPS pair steps of the port from weights drawn from `seed`: returns
    the parameters drawn, the losses, first gradient and change, and the
    batches fed."""
    trainer = Trainer(train_config(cfg, 0), device="cpu")
    init = unet.draw(cfg["net"], torch.Generator().manual_seed(seed), "cpu")
    with torch.no_grad():
        for k, v in trainer.model.state_dict().items():
            v.copy_(init[k])
    stages = device_data.DeviceStages(_stages(seed), device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    got = {"losses": []}
    batches = []
    for s in range(STEPS):
        batch = stages.sample_pair("Final", gen, cfg["batch_size"], cfg["crop_size"], True,
                                   identity_p=cfg["identity_p"])
        got["losses"].append(float(trainer.train_batch_pair_async(*batch)))
        batches.append(tuple(x.clone() for x in batch))
        if s == 0:
            got["first_grad"] = {k: m / 0.1 for k, m in trainer.optimizer.state["mu"].items()}
    got["delta"] = {k: (p.detach() - init[k]) for k, p in trainer.params.items()}
    return init, got, batches


def _gaps(got: dict, want: dict) -> dict:
    keep = ref_train.moving_leaves(want["first_grad"])
    return {
        "loss": max(abs(g - w) / max(abs(w), 1e-30)
                    for g, w in zip(got["losses"], want["losses"])),
        "grad": ref_train.worst_leaf(got["first_grad"], want["first_grad"]),
        "update": ref_train.worst_leaf(got["delta"], want["delta"], keep),
    }


def _agrees(gaps: dict) -> bool:
    return gaps["loss"] <= LOSS_TOL and gaps["grad"] <= GRAD_TOL and gaps["update"] <= UPDATE_TOL


@pytest.fixture(scope="module")
def port_run():
    cfg = _cell_config()
    return (cfg,) + _port_steps(cfg, 2 ** 31 + 5)


def test_scheduled_pair_steps_match_the_reference(port_run):
    cfg, init, got, batches = port_run
    # The schedule moves the learning rate at each of the three updates.
    assert len({ref.learning_rate(c, cfg) for c in range(STEPS)}) == STEPS
    want = ref.train(init, batches, cfg)
    gaps = _gaps(got, want)
    assert _agrees(gaps), gaps
    # Something moved: a non-zero first gradient in every leaf of conv_out.
    assert float(want["first_grad"]["conv_out.weight"].abs().max()) > 0


@pytest.mark.parametrize("change", ["raw_loss_weight", "log_l1", "constant_lr"])
def test_the_reference_is_not_vacuous(port_run, change):
    """With a term of the recipe left out of the reference, it and the port
    disagree beyond the tolerances."""
    cfg, init, got, batches = port_run
    cfg = copy.deepcopy(cfg)
    if change == "raw_loss_weight":
        cfg["raw_loss_weight"] = 0.0
    elif change == "log_l1":
        cfg["loss"]["log_l1"] = 0.0
    else:
        cfg["lr_decay_steps"] = 0
    gaps = _gaps(got, ref.train(init, batches, cfg))
    assert not _agrees(gaps), gaps

