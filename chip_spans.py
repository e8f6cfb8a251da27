"""What the stage clocks of litbox_tpu_torch/core/spans.py cost, and what
they show of the training step, on a CUDA card:

    python3 chip_spans.py [--steps 12] [--rounds 4]

- level1_host: host microseconds of one span and of the training step's
  pattern (eight spans, two counters, one step record), the least of
  seven repeats over 10^5 spans; level2_host: one span's, with its two
  events, over 10^4 spans;
- steps: the upstream recipe's training step (TrainConfig(): UNet size 5,
  32 features, batch 4, crop 256, float32) as Trainer.fit runs it (a batch
  of a 12-scene EXR corpus from the RAM cache, select_random_channel,
  train_batch), host ms a step over `--steps` steps ended by a synchronize,
  in turns: with the spans replaced by no-ops ("off"), at level 1, at
  level 2 (spans.enable()), `--rounds` times;
- exr_reads: the counter data.exr_reads over the warm-up (the first
  epoch reads the corpus's 60 files) and over the timed steps, which must
  read none: the batches come from the RAM cache, as in the benchmark's
  window (exit 1 otherwise);
- self_ms: at level 1, each span's self time a step (spans.totals(): its
  time less its child spans'), over `--steps` steps;
- device_ms: under level 2, the card's median ms of train.forward,
  train.backward, train.optimizer and the step, with the same steps' host
  medians of the program's spans (host_ms) and how far the card reached
  each span's end after the host left it (lag_ms);
- the card's name and power limit.

One JSON line on standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import tempfile
import time
import timeit

import numpy as np
import torch

from litbox_tpu_torch.core import spans
from litbox_tpu_torch.io.exr import write_exr_rgb
from litbox_tpu_torch.nn.dataset import DenoiserDataset
from litbox_tpu_torch.nn.train import TrainConfig, Trainer

IMAGES = ("input_a", "input_b", "albedo", "transmissibility", "reference")


def level1_host() -> dict:
    """Least-of-seven host microseconds: one span, and one training step's
    eight spans, two counters and record."""
    rec = spans.Recorder()

    def one():
        with rec.span("data.batch"):
            pass

    def step():
        with rec.span("data.batch"):
            pass
        rec.count("data.batch_bytes", 1)
        with rec.span("data.channel"):
            pass
        with rec.span("train.h2d"):
            pass
        rec.count("train.h2d_bytes", 1)
        with rec.step("train.step"):
            for name in ("train.forward", "train.backward", "train.optimizer",
                         "train.loss_read"):
                with rec.span(name):
                    pass

    n = 100_000
    return {"span_us": min(timeit.repeat(one, number=n, repeat=7)) / n * 1e6,
            "train_step_us": min(timeit.repeat(step, number=n // 8, repeat=7)) / (n // 8) * 1e6}


def level2_host() -> float:
    """Least-of-seven host microseconds of one span at level 2."""
    rec = spans.Recorder()
    rec.enable()

    def one():
        with rec.span("data.batch"):
            pass

    n = 10_000
    best = float("inf")
    for _ in range(7):
        best = min(best, timeit.timeit(one, number=n) / n * 1e6)
        rec.timeline()  # the events back to the pool
    return best


class _Off:
    """A span that records nothing: the program without its spans."""

    def __init__(self, name):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _corpus(root: str, scenes: int = 12, size: int = 256) -> DenoiserDataset:
    rng = np.random.default_rng(0)
    paths = {k: [] for k in IMAGES}
    for k in IMAGES:
        for i in range(scenes):
            p = os.path.join(root, f"{k}_{i:03d}.exr")
            write_exr_rgb(p, rng.lognormal(0, 1, (size, size, 3)).astype(np.float32),
                          compression="none")
            paths[k].append(p)
    return DenoiserDataset(*(paths[k] for k in IMAGES), crop_size=size)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--rounds", type=int, default=4)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_spans.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"device": torch.cuda.get_device_name(0), "level1_host": level1_host(),
           "level2_host_span_us": level2_host()}
    with tempfile.TemporaryDirectory() as root:
        dataset = _corpus(root)
        trainer = Trainer(TrainConfig(), device="cuda")
        rng = np.random.default_rng(1)

        def feed():
            while True:
                yield from dataset.batches(4, rng, shuffle=True)

        batches = feed()

        def steps(n: int) -> float:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                trainer.train_batch(*Trainer.select_random_channel(next(batches), rng))
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / n * 1e3

        steps(6)  # the first epoch reads the corpus; warm-up
        warm_reads = spans.counters().get("data.exr_reads", 0)
        on_span, on_step, on_count = spans.span, spans.step, spans.count
        ms = {"off": [], "level1": [], "level2": []}
        for _ in range(args.rounds):
            for mode in ("off", "level1", "level2", "level2", "level1", "off"):
                if mode == "off":
                    spans.span, spans.step, spans.count = _Off, _Off, lambda name, n: None
                try:
                    if mode == "level2":
                        spans.enable()
                    ms[mode].append(steps(args.steps))
                finally:
                    spans.disable()
                    spans.span, spans.step, spans.count = on_span, on_step, on_count
        out["step_ms"] = ms
        out["step_ms_median"] = {k: statistics.median(v) for k, v in ms.items()}
        out["exr_reads"] = {"warm_up": warm_reads,
                            "timed": spans.counters().get("data.exr_reads", 0) - warm_reads}

        spans.reset()
        steps(args.steps)
        out["self_ms"] = {name: self_ns * 1e-6 / args.steps
                          for name, (_, _, self_ns) in spans.totals().items()}

        spans.reset()
        spans.enable()
        steps(args.steps)
        spans.timeline()
        spans.disable()
        records = [r for r in spans.step_records() if r.kind == "train.step"][1:]
        names = ("train.forward", "train.backward", "train.optimizer", "train.step")
        out["device_ms"] = {
            n: statistics.median((r.find(n).device_end_ns - r.find(n).device_start_ns) * 1e-6
                                 for r in records) for n in names}
        out["host_ms"] = {n: statistics.median(r.host_ms(n) for r in records)
                          for n in names + ("data.batch", "data.channel", "train.h2d",
                                            "train.loss_read")}
        out["lag_ms"] = {n: statistics.median((r.find(n).device_end_ns - r.find(n).end_ns) * 1e-6
                                              for r in records) for n in names}
        out["steps_read"] = len(records)
    out["smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps(out), flush=True)
    if out["exr_reads"]["timed"]:
        raise SystemExit(f"the timed steps read {out['exr_reads']['timed']} EXR files")


if __name__ == "__main__":
    main()
