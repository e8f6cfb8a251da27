"""The benchmark's harness: finds a cell and everything it names by name,
runs it, and prints its result line.

A cell (an entry of BENCHMARK.json's `workloads`) names a configuration and
a traffic mix. The harness reads:

- `litbench/workloads/<cell>.json`: {"config", "traffic", "generator",
  "params"}: the traffic generator `litbench/traffic/<generator>.py` and its
  parameters;
- `litbench/configs/<config>.json`: the configuration as it is run;
- `litbench/metrics/<metric>.py`: one per-layer metric, a function
  `read(trace: dict) -> float | None` over what the traced run recorded.

A generator module has `run(cfg, params, seed, seconds, trace, t0) -> dict`
with the keys e2e (the end-to-end metrics by name, setup_s among them),
attempted, failed, checks (each compared number beside its limit),
memory_peak_bytes, trace (what the per-layer readers read, or None),
setup_phases (seconds from the start to the end of each set-up phase) and
window (what the window did, for the reader), the last two printed on
standard error, and in a traced run busy_s, window_s and breakdown. The
harness adds nothing that belongs to one cell, so a later cell,
configuration or metric is new files and new entries in BENCHMARK.json.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
from typing import Any

HERE = os.path.dirname(os.path.abspath(__file__))

# Top-level module names that may not be loaded in a run: the JAX stack and
# the JAX package the port was made from. Compared whole, since the port's
# own name begins with the JAX package's.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "litbox_tpu")


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module from a file, by path (metric files have dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One cell with its entry in BENCHMARK.json, its workload file, its
    configuration file, and the metrics it reports."""

    def __init__(self, bench: dict, name: str, base: str = HERE):
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = entries[name]
        self.base = base
        self.workload = load_json(os.path.join(base, "workloads", name + ".json"))
        config = self.entry["config"]
        if self.workload["config"] != config or self.workload["traffic"] != self.entry["traffic"]:
            raise ValueError(f"{name}: workload file and BENCHMARK.json disagree")
        conf = {c["name"]: c for c in bench["configs"]}[config]
        self.config = load_json(os.path.join(base, os.path.relpath(conf["file"], "litbench")))
        self.end_to_end = [m for m in bench["end_to_end"] if _applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if _applies(m, name)]

    def generator(self):
        name = self.workload["generator"]
        return load_module(os.path.join(self.base, "traffic", name + ".py"),
                           "litbench_traffic_" + name)

    def reader(self, metric: str):
        return load_module(os.path.join(self.base, "metrics", metric + ".py"),
                           "litbench_metric_" + metric.replace(".", "_"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_loaded() -> list[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def result_line(cell: Cell, outcome: dict, trace: bool, device: dict) -> dict:
    """The result object, keys in the order the contract lists them, the
    compared numbers last."""
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(outcome["trace"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(outcome["e2e"][m["name"]]),
                                  "unit": m["unit"]}
    checks = outcome["checks"]
    correct = bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    line = {"correct": correct and outcome["failed"] == 0,
            "attempted": int(outcome["attempted"]), "failed": int(outcome["failed"]),
            "metrics": metrics, "device": device}
    if trace and outcome.get("breakdown"):
        line["breakdown"] = outcome["breakdown"]
    line["checks"] = checks
    return line


def main(argv: list[str], root: str, t0: float) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cell = Cell(load_json(os.path.join(root, "BENCHMARK.json")), args.workload)
    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"litbench: {args.workload} needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    outcome = cell.generator().run(cell.config, cell.workload["params"], args.seed,
                                args.seconds, bool(args.trace), t0)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": int(outcome["memory_peak_bytes"])}
    if args.trace:
        device["busy_s"] = outcome["busy_s"]
        device["window_s"] = outcome["window_s"]
    line = result_line(cell, outcome, bool(args.trace), device)

    loaded = forbidden_loaded()
    if loaded:
        print(f"litbench: modules of the JAX stack were loaded: {loaded}", file=sys.stderr)
        return 3
    print(f"setup phases (s since start): {outcome.get('setup_phases')}", file=sys.stderr)
    print(f"window: {outcome.get('window')}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def synchronize(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def peak_memory(device: str) -> int:
    import torch

    return torch.cuda.max_memory_allocated() if device == "cuda" else 0


def check(value: float, limit: float) -> dict:
    """One compared number beside its limit."""
    return {"value": float(value), "limit": float(limit)}
