"""A run driven past the harness's look for a card (on the CPU, at a small
size), with the timed path broken underneath: `correct` has to come out
false for each fault the cell can have, and true without one."""

import time

import pytest
import torch

from litbench import core


def _correct(cell, cfg, params, seed=2 ** 31 + 11, **kw) -> tuple[bool, dict]:
    out = cell.generator().run(cfg, params, seed, 0.3, False, time.perf_counter(),
                            device="cpu", **kw)
    device = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    line = core.result_line(cell, out, False, device)
    return line["correct"], line["checks"]


def _fed_wrong(real, good_calls):
    """Trainer.select_random_channel whose batches after the first
    `good_calls` are altered: a window step fed something the corpus does
    not hold."""
    calls = []

    def select(batch, rng, device="cuda"):
        inputs, targets = real(batch, rng, device)
        calls.append(1)
        return (inputs + 1e-3, targets) if len(calls) > good_calls else (inputs, targets)
    return staticmethod(select)


@pytest.mark.parametrize("fault", ["none", "unchanged", "altered", "half", "window_feed"])
def test_train_faults(fault, tiny_train, monkeypatch):
    from litbox_tpu_torch.nn import train

    if fault == "unchanged":
        monkeypatch.setattr(train.Optimizer, "step", lambda self, grads: None)
    elif fault == "altered":
        real = train.Trainer.train_batch
        monkeypatch.setattr(train.Trainer, "train_batch",
                            lambda self, i, t: real(self, i, t) * (1 + 1e-4))
    elif fault == "half":
        real = train.Trainer.loss
        monkeypatch.setattr(train.Trainer, "loss",
                            lambda self, i, t: real(self, i[: len(i) // 2], t[: len(t) // 2]))
    elif fault == "window_feed":
        monkeypatch.setattr(train.Trainer, "select_random_channel",
                            _fed_wrong(train.Trainer.select_random_channel,
                                       tiny_train[2]["checked_steps"]))
    correct, checks = _correct(*tiny_train)
    assert correct == (fault == "none"), checks


def test_train_control_fails_on_the_card(tiny_train, card):
    cell, cfg, params = tiny_train
    out = cell.generator().run(cfg, params, 2 ** 31 + 13, 0.3, False, time.perf_counter(),
                            device=card, control=True)
    assert not core.result_line(cell, out, False, {})["correct"], out["checks"]
