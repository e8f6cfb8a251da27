"""Fixtures of the harness's tests: the cell's configuration cut to a size
a CPU runs in seconds, and the card fixture of the tests that need one."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from litbench import core  # noqa: E402


def bench() -> dict:
    return core.load_json(os.path.join(ROOT, "BENCHMARK.json"))


@pytest.fixture
def tiny_train():
    """unet5-train with a size-2 net of 4 features on 32x32 crops."""
    cell = core.Cell(bench(), "unet5-train")
    cfg, params = copy.deepcopy(cell.config), copy.deepcopy(cell.workload["params"])
    cfg.update(unet_size=2, initial_features=4, crop_size=32)
    cfg["net"].update(unet_size=2, initial_features=4)
    params.update(size=32)
    return cell, cfg, params


@pytest.fixture
def card():
    """Skips the test where no CUDA card is visible (decided here, when the
    test runs, never while the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
