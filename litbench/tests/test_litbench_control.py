"""The control of the training cell on the card, at the cell's own size:
the reference computed one precision below the configuration's (float32
with TF32 on, through cuDNN) in place of the program's outputs has to come
out not correct.

    python -m pytest -m cuda litbench/tests/test_litbench_control.py -q -s
"""

import json
import time

import pytest

from litbench import core

from .conftest import bench

SEEDS = (2 ** 31 + 101, 2 ** 31 + 103, 2 ** 31 + 105)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(seed, card):
    cell = core.Cell(bench(), "unet5-train")
    out = cell.generator().run(cell.config, cell.workload["params"], seed, 2.0, False,
                            time.perf_counter(), device=card, control=True)
    line = core.result_line(cell, out, False, {})
    print(json.dumps({"control": "unet5-train", "seed": seed, "checks": line["checks"]}))
    assert not line["correct"], line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", ["half", "altered"])
def test_train_fault_readings(fault, seed, card, monkeypatch):
    """The training cell's faults planted in the program at the cell's own
    size: half the batch left out (the mean over the rest), and the loss
    altered where it is produced. The unchanged state reads 1 by the
    update's measure and needs no run."""
    from litbox_tpu_torch.nn import train

    if fault == "half":
        real = train.Trainer.loss
        monkeypatch.setattr(train.Trainer, "loss",
                            lambda self, i, t: real(self, i[: len(i) // 2], t[: len(t) // 2]))
    else:
        real = train.Trainer.train_batch
        monkeypatch.setattr(train.Trainer, "train_batch",
                            lambda self, i, t: real(self, i, t) * (1 + 1e-4))
    cell = core.Cell(bench(), "unet5-train")
    out = cell.generator().run(cell.config, cell.workload["params"], seed, 2.0, False,
                            time.perf_counter(), device=card)
    line = core.result_line(cell, out, False, {})
    print(json.dumps({"fault": fault, "seed": seed, "checks": line["checks"]}))
    assert not line["correct"], line["checks"]
