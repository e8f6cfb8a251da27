"""The kpcn-21-train cell on the CPU, at a small size: the harness finds it
and everything it names, its per-layer readers read a trace and stay
silent on one without their kernels, and a run driven past the harness's
look for a card comes out `correct` without a fault and not `correct` with
each fault the cell can have. On a card, the control and the faults at the
cell's own size:

    python -m pytest -m cuda litbench/tests/test_litbench_kpcn.py -q -s
"""

import copy
import dataclasses
import json
import os
import time

import pytest
import torch

from litbench import core

from .conftest import ROOT, bench

CELL = "kpcn-21-train"
SEEDS = (2 ** 31 + 201, 2 ** 31 + 203, 2 ** 31 + 205)


def _listed(kind: str) -> set:
    """The metrics of `kind` in BENCHMARK.json that the cell reports."""
    return {m["name"] for m in bench()[kind] if CELL in m.get("workloads", [CELL])}


def test_the_harness_finds_the_cell():
    cell = core.Cell(bench(), CELL)
    assert cell.config["name"] == cell.entry["config"] == "kpcn-21"
    assert cell.generator().run is not None
    assert {m["name"] for m in cell.end_to_end} == _listed("end_to_end")
    assert {m["name"] for m in cell.per_layer} == _listed("per_layer")
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]).read)
    # The published sizes, with nothing cut.
    c = cell.config
    assert (c["layers"], c["features"], c["kernel_size"], c["recon_kernel"],
            c["crop_size"]) == (9, 100, 5, 21, 65)
    assert c["reduced"] == [] and c["learn_rate"] == 1e-5
    assert os.path.exists(os.path.join(ROOT, "litbench", "reference", "kpcn.py"))


def _trace(ops: list) -> dict:
    return {"steps": 0, "step_s": 1.0, "step_flop": 1.0, "conv_flop": 67e12 * 0.1,
            "kpn_bytes": 3.35e12 * 0.001, "profile_steps": 2,
            "profile": {"busy_s": 1.0, "window_s": 2.0, "device_ops": ops, "idle_gaps": []}}


def test_the_roofline_readers_read_their_kernels_only():
    """Each roofline reader sums its own kernels' device time over the
    profiled steps, and reads nothing where the profile has none of them."""
    cell = core.Cell(bench(), CELL)
    kpn, conv = cell.reader("kpn_apply_roofline"), cell.reader("conv5_roofline")
    ops = [["void (anonymous namespace)::kpn_forward_kernel(float const*)", 0.001],
           ["void (anonymous namespace)::kpn_backward_kernel(float const*)", 0.003],
           ["void (anonymous namespace)::conv_fwd_kernel<128, 128, 16, 2, 5>()", 0.2],
           ["void (anonymous namespace)::conv_wgrad_kernel<128, 128, 16, 2, 5>()", 0.1],
           ["void (anonymous namespace)::conv_wgrad_reduce_kernel()", 0.1],
           ["void at::native::vectorized_elementwise_kernel<4>()", 5.0]]
    assert kpn.read(_trace(ops)) == pytest.approx(50.0)
    assert conv.read(_trace(ops)) == pytest.approx(50.0)
    assert kpn.read(_trace(ops[2:])) is None and conv.read(_trace(ops[:2])) is None
    assert kpn.read({"steps": 0}) is None and conv.read({"steps": 0}) is None


@pytest.fixture
def tiny_kpcn():
    """The cell with 3 layers of 8 features, a 7x7 reconstruction, 2
    patches of 17^2, 4 scenes of 48^2 a stage and 4 steps a loss read."""
    cell = core.Cell(bench(), CELL)
    cfg, params = copy.deepcopy(cell.config), copy.deepcopy(cell.workload["params"])
    cfg.update(layers=3, features=8, recon_kernel=7, crop_size=17, batch_size=2,
               steps_per_read=4)
    params.update(scenes=4, size=48)
    return cell, cfg, params


def _run(cell, cfg, params, seed, device, seconds, **kw) -> dict:
    out = cell.generator().run(cfg, params, seed, seconds, False, time.perf_counter(),
                               device=device, **kw)
    return core.result_line(cell, out, False, {})


def plant(fault: str, monkeypatch, checked_steps: int) -> None:
    """Break the program underneath the cell's timed path."""
    from litbox_tpu_torch.nn import device_data, kpcn, train
    from litbox_tpu_torch.ops import kpn

    if fault == "not_turned":
        real = device_data.sample_batch_kpcn_from

        def sample(*args):
            *data, d, crop = args
            return real(*data, dataclasses.replace(d, rot=torch.zeros_like(d.rot)), crop)
        monkeypatch.setattr(device_data, "sample_batch_kpcn_from", sample)
    elif fault == "no_variance":
        real = kpcn.features

        def features(*args):
            feats, colour = real(*args)
            feats[:, 3] = 0.0
            return feats, colour
        monkeypatch.setattr(kpcn, "features", features)
    elif fault == "no_softmax":
        def raw(logits, colour):
            n, taps, h, w = logits.shape
            k = kpn.window(logits)
            cols = torch.nn.functional.unfold(colour, k, padding=k // 2)
            cols = cols.reshape(n, 3, taps, h * w)
            return (logits.reshape(n, 1, taps, h * w) * cols).sum(2).reshape(n, 3, h, w)
        monkeypatch.setattr(kpn, "kernel_apply", raw)
    elif fault == "linear_loss":
        monkeypatch.setattr(train, "log1p_l1",
                            lambda pred, ref: torch.mean((pred - ref).abs()))
    elif fault == "window_batch":
        real = device_data.DeviceStages.sample_kpcn
        calls = []

        def sample_kpcn(self, *args, **kw):
            a, b, albedo, trans, ref = real(self, *args, **kw)
            calls.append(1)
            return ((a, b, albedo + 1e-3, trans, ref) if len(calls) > checked_steps
                    else (a, b, albedo, trans, ref))
        monkeypatch.setattr(device_data.DeviceStages, "sample_kpcn", sample_kpcn)
    elif fault != "none":
        raise ValueError(fault)


FAULTS = ["none", "not_turned", "no_variance", "no_softmax", "linear_loss", "window_batch"]


@pytest.mark.parametrize("fault", FAULTS)
def test_kpcn_faults(fault, tiny_kpcn, monkeypatch):
    cell, cfg, params = tiny_kpcn
    plant(fault, monkeypatch, params["checked_steps"])
    line = _run(cell, cfg, params, 2 ** 31 + 13, "cpu", 0.3)
    assert line["correct"] == (fault == "none"), line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(seed, card):
    """The reference one precision below the configuration's (TF32 through
    cuDNN) in place of the program's outputs."""
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
