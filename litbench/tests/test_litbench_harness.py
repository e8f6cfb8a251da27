"""The harness's arithmetic, discovery, result line and imports, on the CPU."""

import ast
import json
import os
import shutil

import pytest
import torch

from litbench import core, yardstick
from litbench.reference import unet

from .conftest import ROOT, bench

SHIPPED = dict(unet_size=4, initial_features=16, padding_mode="reflect",
               global_residual=True, out_channels=3)
TRAIN = dict(unet_size=5, initial_features=32, padding_mode="reflect", out_channels=1)


def test_unet_flop_counts():
    # The shipped single and calibration displays at 480x272 padded to 480x288
    # (chip_smoke.py's `production.display_flop`), and a training step.
    assert yardstick.unet_flop(SHIPPED, 1, 288, 480) == 100_156_538_880
    assert yardstick.unet_flop(SHIPPED, 2, 288, 480) == 200_313_077_760
    forward = yardstick.unet_flop(TRAIN, 4, 256, 256)
    assert forward == 927_092_178_944
    reads = {}
    trace = {"step_flop": 3 * forward, "step_s": 0.26}
    reads["train_mfu"] = core.load_module(os.path.join(ROOT, "litbench/metrics/train_mfu.py"),
                                          "m").read(trace)
    assert reads["train_mfu"] == pytest.approx(100 * 3 * forward / 0.26 / 67e12)


@pytest.mark.parametrize("arch", [SHIPPED, TRAIN])
def test_layout_is_the_ports_state_dict(arch):
    from litbox_tpu_torch.nn.unet import LitboxDenoiserNet

    with torch.device("meta"):
        net = LitboxDenoiserNet(**arch)
    want = [(k, tuple(v.shape)) for k, v in net.state_dict().items()]
    assert [(k, s) for k, s, _ in unet.layout(**arch)] == want


def test_metrics_without_their_readings_return_nothing():
    for name in os.listdir(os.path.join(ROOT, "litbench/metrics")):
        module = core.load_module(os.path.join(ROOT, "litbench/metrics", name), "m")
        assert module.read({}) is None, name


def test_cell_config_and_metric_added_as_files(tmp_path):
    """A later configuration, cell and per-layer metric are new files and new
    entries in BENCHMARK.json; no file that is there changes."""
    base = tmp_path / "litbench"
    shutil.copytree(os.path.join(ROOT, "litbench"), base)
    b = bench()
    before = {p: open(os.path.join(base, p), "rb").read()
              for p in ("workloads/unet5-train.json", "configs/unet5-train.json", "core.py")}
    cfg = json.load(open(base / "configs/unet5-train.json"))
    cfg.update(name="unet4-train", unet_size=4, initial_features=16)
    (base / "configs/unet4-train.json").write_text(json.dumps(cfg))
    wl = json.load(open(base / "workloads/unet5-train.json"))
    wl.update(config="unet4-train", traffic="closed_loop_large_corpus")
    wl["params"].update(scenes=64)
    (base / "workloads/unet4-train-large.json").write_text(json.dumps(wl))
    (base / "metrics/host_syncs.train.py").write_text(
        "def read(trace):\n    return trace.get('host_syncs')\n")
    b["configs"].append({"name": "unet4-train", "source": "x",
                         "file": "litbench/configs/unet4-train.json", "reduced": [],
                         "why": "x"})
    b["workloads"].append({"name": "unet4-train-large", "config": "unet4-train",
                           "traffic": "closed_loop_large_corpus", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "host_syncs.train", "unit": "syncs", "better": "lower",
                           "source": "program_counter", "layer": "host batches",
                           "moves": "train_crops_per_s", "workloads": ["unet4-train-large"]})
    cell = core.Cell(b, "unet4-train-large", base=str(base))
    assert cell.config["name"] == "unet4-train" and cell.workload["params"]["scenes"] == 64
    assert cell.generator().run is not None
    assert [m["name"] for m in cell.per_layer] == ["host_syncs.train"]
    assert {m["name"] for m in cell.end_to_end} == {"setup_s"}
    assert cell.reader("host_syncs.train").read({"host_syncs": 1}) == 1
    for p, data in before.items():
        assert open(os.path.join(base, p), "rb").read() == data


def test_result_line_keys():
    cell = core.Cell(bench(), "unet5-train")
    outcome = {"e2e": {"setup_s": 9.0, "train_crops_per_s": 15.0}, "attempted": 70,
               "failed": 0, "checks": {"loss_gap": core.check(1e-7, 1e-5)},
               "trace": {"data_ms": [3.0, 5.0]}, "breakdown": {"device_ops": [], "idle_gaps": []}}
    device = {"platform": "gpu", "kind": "card", "count": 1, "memory_peak_bytes": 1}
    line = core.result_line(cell, outcome, False, device)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] and set(line["metrics"]) == {"setup_s", "train_crops_per_s"}
    traced = core.result_line(cell, outcome, True, device)
    assert list(traced) == ["correct", "attempted", "failed", "metrics", "device",
                            "breakdown", "checks"]
    assert traced["metrics"] == {"data_ms.train": {"value": 4.0, "unit": "ms"}}
    outcome["checks"]["loss_gap"] = core.check(2e-5, 1e-5)
    assert not core.result_line(cell, outcome, False, device)["correct"]
    outcome["checks"]["loss_gap"] = core.check(float("nan"), 1e-5)
    assert not core.result_line(cell, outcome, False, device)["correct"]


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _modules(sub: str = ""):
    top = os.path.join(ROOT, "litbench", sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_the_jax_stack():
    for path in _modules():
        found = _imports(path) & set(core.FORBIDDEN_MODULES)
        assert not found, (path, found)


def test_the_reference_imports_nothing_of_the_port():
    for path in _modules("reference"):
        assert "litbox_tpu_torch" not in _imports(path), path


def test_a_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    import subprocess
    import sys

    p = subprocess.run([sys.executable, "litbench/run.py", "--workload", "unet5-train",
                        "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == "", (p.returncode, p.stdout)
