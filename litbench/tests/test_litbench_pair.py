"""The unet4-rgb-pair-train cell on the CPU, at a small size: the harness
finds it, and a run driven past the harness's look for a card comes out
`correct` without a fault and not `correct` with each fault the cell can
have. On a card, the same faults and the control at the cell's own size:

    python -m pytest -m cuda litbench/tests/test_litbench_pair.py -q -s
"""

import copy
import dataclasses
import json
import time

import pytest
import torch

from litbench import core

from .conftest import bench

CELL = "unet4-rgb-pair-train"
SEEDS = (2 ** 31 + 107, 2 ** 31 + 109, 2 ** 31 + 111)


@pytest.fixture
def tiny_pair():
    """The cell with a size-2 net of 4 features, 2 pairs of 32x32 crops, 4
    scenes of 48x48 a stage and 4 steps a loss read; identity_p 0.5, so
    that the checked items hold identity pairs at this batch."""
    cell = core.Cell(bench(), CELL)
    cfg, params = copy.deepcopy(cell.config), copy.deepcopy(cell.workload["params"])
    cfg.update(unet_size=2, initial_features=4, crop_size=32, batch_size=2, steps_per_read=4,
               identity_p=0.5)
    cfg["net"].update(unet_size=2, initial_features=4)
    params.update(scenes=4, size=48)
    return cell, cfg, params


def _run(cell, cfg, params, seed, device, seconds, **kw) -> dict:
    out = cell.generator().run(cfg, params, seed, seconds, False, time.perf_counter(),
                               device=device, **kw)
    return core.result_line(cell, out, False, {})


def _k_differentiated(self, a, b, ref):
    """Trainer.pair_loss with the gradient let through k."""
    from litbox_tpu_torch.nn.loss import hdr_loss

    a, b, ref = self._tensor(a), self._tensor(b), self._tensor(ref)
    pred = self._net(torch.cat([a, b]))
    out_a, out_b = pred[: a.shape[0]], pred[a.shape[0]:]
    d_a, d_b = out_a - a, out_b - b
    dbar = (d_a + d_b) * 0.5
    num = ((d_a - d_b) * (b - a)).sum((1, 2, 3)) * 0.25
    k = torch.clamp(num / torch.clamp((dbar * dbar).sum((1, 2, 3)), min=1e-12), 0.0, 1.0)
    loss = hdr_loss((a + b) * 0.5 + k[:, None, None, None] * dbar, ref, self.cfg.loss)
    return loss + self.cfg.raw_loss_weight * hdr_loss((out_a + out_b) * 0.5, ref, self.cfg.loss)


def _draws_without(field: str):
    """device_data.sample_batch_pair_from that ignores one of the draws."""
    from litbox_tpu_torch.nn import device_data

    real = device_data.sample_batch_pair_from

    def sample(data_a, data_b, data_ref, d, crop, rgb):
        d = dataclasses.replace(d, **{field: torch.zeros_like(getattr(d, field))})
        return real(data_a, data_b, data_ref, d, crop, rgb)
    return sample


def plant(fault: str, monkeypatch, checked_steps: int) -> None:
    """Break the program underneath the cell's timed path."""
    from litbox_tpu_torch.nn import device_data, train

    if fault == "identity_ignored":
        monkeypatch.setattr(device_data, "sample_batch_pair_from", _draws_without("flag"))
    elif fault == "not_swapped":
        monkeypatch.setattr(device_data, "sample_batch_pair_from", _draws_without("swap"))
    elif fault == "k_differentiated":
        monkeypatch.setattr(train.Trainer, "pair_loss", _k_differentiated)
    elif fault == "raw_dropped":
        real = train.Trainer.pair_loss

        def pair_loss(self, a, b, ref):
            cfg = self.cfg
            self.cfg = dataclasses.replace(cfg, raw_loss_weight=0.0)
            try:
                return real(self, a, b, ref)
            finally:
                self.cfg = cfg
        monkeypatch.setattr(train.Trainer, "pair_loss", pair_loss)
    elif fault == "schedule_stuck":
        real = train.Optimizer.step

        def step(self, grads):
            real(self, grads)
            self.state["schedule_count"].sub_(1)
        monkeypatch.setattr(train.Optimizer, "step", step)
    elif fault == "window_batch":
        real = device_data.DeviceStages.sample_pair
        calls = []

        def sample_pair(self, *args, **kw):
            a, b, ref = real(self, *args, **kw)
            calls.append(1)
            return (a + 1e-3, b, ref) if len(calls) > checked_steps else (a, b, ref)
        monkeypatch.setattr(device_data.DeviceStages, "sample_pair", sample_pair)
    elif fault != "none":
        raise ValueError(fault)


FAULTS = ["none", "identity_ignored", "not_swapped", "k_differentiated", "raw_dropped",
          "schedule_stuck", "window_batch"]


@pytest.mark.parametrize("fault", FAULTS)
def test_pair_faults(fault, tiny_pair, monkeypatch):
    """The seed gives crops whose k lies inside (0, 1): where every k is
    clamped, a k that passes its gradient passes none."""
    cell, cfg, params = tiny_pair
    plant(fault, monkeypatch, params["checked_steps"])
    line = _run(cell, cfg, params, 2 ** 31 + 11, "cpu", 0.3)
    assert line["correct"] == (fault == "none"), line["checks"]


def test_the_harness_finds_the_cell():
    cell = core.Cell(bench(), CELL)
    assert cell.config["name"] == cell.entry["config"] == "unet4-rgb-pair"
    assert cell.generator().run is not None
    assert {m["name"] for m in cell.end_to_end} == {"train_crops_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "train_mfu", "idle_share.train", "issue_ms.train", "sample_ms.pair"}
    # The recipe's published sizes, as runs/denoiser_r5/model_best.npz.json saves them.
    c = cell.config
    assert (c["unet_size"], c["initial_features"], c["batch_size"], c["crop_size"]) == (4, 16, 16,
                                                                                       192)
    assert c["net"]["out_channels"] == 3 and c["global_residual"] and c["pair_composition"]
    assert c["reduced"] == []


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(seed, card):
    cell = core.Cell(bench(), CELL)
    line = _run(cell, cell.config, cell.workload["params"], seed, card, 2.0, control=True)
    print(json.dumps({"control": CELL, "seed": seed, "checks": line["checks"]}))
    assert not line["correct"], line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", FAULTS[1:])
def test_fault_readings(fault, card, monkeypatch):
    """Each fault planted in the program at the cell's own size."""
    cell = core.Cell(bench(), CELL)
    plant(fault, monkeypatch, cell.workload["params"]["checked_steps"])
    line = _run(cell, cell.config, cell.workload["params"], SEEDS[0], card, 2.0)
    print(json.dumps({"fault": fault, "checks": line["checks"]}))
    assert not line["correct"], line["checks"]
