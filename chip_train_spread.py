"""How far the card's TrainConfig() gradients stray from the CPU's between
runs of the same code: the `train` phase's mono gate in chip_smoke.py (one
step's gradients on the card and on the CPU, from the weights that 40 card
steps left, within TRAIN_GRAD_TOL of the largest CPU gradient).

    python3 chip_train_spread.py [--trials N] [--repeats R] [--corpora K]
                                 [--modes default,deterministic]
                                 [--kernels-first | --phases-first]
                                 [--precision]

Writes chip_smoke.py's training corpus once (its `_corpus`, on the card),
then, for each mode and each of N trials: a fresh Trainer (TrainConfig(),
seed 0, TF32 off) takes chip_smoke.TRAIN_STEPS steps on the card, and on
its weights and the gate's probe batch the gradients are taken R times on
the card and once on the CPU. Mode `default` leaves cuDNN as the train
phase does (nondeterministic algorithms allowed, benchmark off); mode
`deterministic` sets torch.backends.cudnn.deterministic (the Trainer's
steps, off cuDNN under nn.train.step_convolutions, read it no more). --kernels-first
runs chip_smoke.py's `kernels` phase before anything else, as the full
smoke run does; --phases-first runs every phase that the full run runs
before `train` (kernels, frame, pipeline, fused_resolve, production,
simulation, hybrid), in its order.

Prints one JSON line a trial (and appends it to
chiprun_out/train_spread.jsonl): the gate's ratio (card vs CPU max |diff|
over the max |CPU gradient|) for each card repeat, the parameter that
holds the largest difference, the card's own spread over its repeats at
fixed weights (of the same scale), and the largest |difference| of the
trained weights from the mode's first trial. --corpora K writes the corpus
K times (the trials run on each). --precision also takes the gradients in
float64 on the CPU, at the same weights and batch, and gives each of
these its distance from them, of the same scale: the card in float32 as
the gate takes it (Trainer.gradients: PyTorch's own convolutions), the
card in float32 on cuDNN's convolutions, and again with
cudnn.conv.fp32_precision "ieee", the card in float64 and the CPU in
float32; with each, the parameter that holds the largest difference; and
the time of one such loss and backward on the card, through the Trainer
and through cuDNN (a copy of the net included). Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as smoke
from litbox_tpu_torch.nn import train
from litbox_tpu_torch.nn.dataset import build_curriculum

OUT = Path(__file__).resolve().parent / "chiprun_out" / "train_spread.jsonl"


def _emit(record: dict) -> None:
    line = json.dumps(record)
    print(line, flush=True)
    with OUT.open("a") as f:
        f.write(line + "\n")


def _grads(trainer, device: str, x, y, dtype: torch.dtype, cudnn: bool = False) -> dict:
    """The gate's gradients (smoke._twin_grads: Trainer.gradients) in
    `dtype`, or with `cudnn` the loss and its backward on cuDNN's
    convolutions; returned in float64 on the CPU."""
    twin = copy.copy(trainer)
    twin.model = copy.deepcopy(trainer.model).to(device=device, dtype=dtype)
    twin.params = dict(twin.model.named_parameters())
    twin.device = torch.device(device)
    twin._tensor = lambda a: torch.as_tensor(a).to(device=device, dtype=dtype)
    if cudnn:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=torch.backends.cudnn.deterministic,
                                        allow_tf32=False):
            twin.loss(x, y).backward()
    else:
        twin.gradients(twin.loss, x, y)
    return {k: p.grad.detach().to("cpu", torch.float64) for k, p in twin.params.items()}


def _fp32_precision() -> dict:
    """The fp32_precision settings of PyTorch's newer API, where it has them."""
    out = {}
    for name, obj in (("backends", torch.backends), ("cuda.matmul", torch.backends.cuda.matmul),
                      ("cudnn", torch.backends.cudnn),
                      ("cudnn.conv", getattr(torch.backends.cudnn, "conv", None))):
        try:
            out[name] = getattr(obj, "fp32_precision", None)
        except Exception as e:  # noqa: BLE001 - recorded, not raised
            out[name] = f"{type(e).__name__}: {e}"
    return out


def _distance(a: dict, ref: dict) -> dict:
    scale = max(float(g.abs().max()) for g in ref.values())
    errs = {k: float((a[k] - g).abs().max()) for k, g in ref.items()}
    worst = max(errs, key=errs.get)
    return dict(ratio=errs[worst] / scale, worst_param=worst)


def _ieee_conv_grads(trainer, x, y) -> dict | str:
    """The card's float32 gradients with cuDNN's convolutions set to IEEE
    float32 through the newer API (cudnn.conv.fp32_precision), restored
    after; the error's text where that API refuses."""
    conv = torch.backends.cudnn.conv
    try:
        saved = conv.fp32_precision
        conv.fp32_precision = "ieee"
    except Exception as e:  # noqa: BLE001 - recorded, not raised
        return f"{type(e).__name__}: {e}"
    try:
        return _grads(trainer, "cuda", x, y, torch.float32, cudnn=True)
    finally:
        conv.fp32_precision = saved


def _precision(trainer, x, y) -> dict:
    """Each way of taking the gate's gradients against the CPU's float64."""
    ref = _grads(trainer, "cpu", x, y, torch.float64)
    ms = {}
    for cudnn in (True, False):  # one loss and backward on the card, the second of two
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _grads(trainer, "cuda", x, y, torch.float32, cudnn)
            torch.cuda.synchronize()
        ms["cudnn" if cudnn else "trainer"] = (time.perf_counter() - t0) * 1e3
    ways = dict(card_f32=("cuda", torch.float32, False),
                card_f32_cudnn=("cuda", torch.float32, True),
                card_f64=("cuda", torch.float64, False),
                cpu_f32=("cpu", torch.float32, False))
    out = {name: _distance(_grads(trainer, dev, x, y, dtype, cudnn), ref)
           for name, (dev, dtype, cudnn) in ways.items()}
    ieee = _ieee_conv_grads(trainer, x, y)
    out["card_f32_cudnn_conv_ieee"] = ieee if isinstance(ieee, str) else _distance(ieee, ref)
    return dict(out, card_f32_step_ms=ms)


def _trial(curriculum, x, y, repeats: int, first: dict | None,
           precision: bool) -> tuple[dict, dict]:
    cfg = train.TrainConfig()
    trainer = train.Trainer(cfg)
    with contextlib.redirect_stdout(io.StringIO()):
        trainer.fit(curriculum, log_every=0.0, max_steps=smoke.TRAIN_STEPS)
    weights = {k: p.detach().cpu().clone() for k, p in trainer.model.named_parameters()}
    cards = [smoke._twin_grads(trainer, "cuda", x, y)[1] for _ in range(repeats)]
    cpu_loss, cpu = smoke._twin_grads(trainer, "cpu", x, y)
    scale = max(float(g.abs().max()) for g in cpu.values())
    errs = [{k: float((card[k] - g).abs().max()) for k, g in cpu.items()} for card in cards]
    worst = max(errs[0], key=errs[0].get)
    spread = max(float((card[k] - cards[0][k]).abs().max())
                 for card in cards[1:] for k in cpu) if repeats > 1 else None
    drift = None if first is None else max(float((weights[k] - first[k]).abs().max())
                                           for k in weights)
    vs_f64 = _precision(trainer, x, y) if precision else None
    return dict(gate_ratio=[max(e.values()) / scale for e in errs], tol=smoke.TRAIN_GRAD_TOL,
                vs_cpu_f64=vs_f64, probe_max=float(x.abs().max()),
                max_abs_cpu_grad=scale, worst_param=worst, cpu_loss=cpu_loss,
                card_repeat_spread_ratio=None if spread is None else spread / scale,
                weights_max_abs_diff_vs_first_trial=drift), weights


def _run_before(before: str) -> None:
    """chip_smoke.main's phases ahead of `train`: the kernels phase alone,
    or every one of them."""
    smoke.install_recorders()
    smoke.kernels_phase()
    if before == "kernels":
        return
    smoke._recording[0] = "path"
    smoke.frame_phase()
    _, last = smoke.pipeline_phase(with_f64=False)
    smoke.fused_resolve_phase(*last)
    del last
    for run in (smoke.production_phase, smoke.simulation_phase, smoke.hybrid_phase):
        torch.cuda.empty_cache()
        run()
    torch.cuda.empty_cache()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_train_spread: no CUDA device")
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--modes", default="default,deterministic")
    ap.add_argument("--corpora", type=int, default=1)
    ap.add_argument("--precision", action="store_true")
    order = ap.add_mutually_exclusive_group()
    order.add_argument("--kernels-first", action="store_true")
    order.add_argument("--phases-first", action="store_true")
    args = ap.parse_args()
    before = "phases" if args.phases_first else "kernels" if args.kernels_first else None
    OUT.parent.mkdir(exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    _emit(dict(device=smi, torch=torch.__version__, cuda=torch.version.cuda,
               cudnn=torch.backends.cudnn.version(), before=before))
    smoke.cuda_lib.build()
    smoke.cuda_lib.library()
    if before:
        _run_before(before)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    _emit(dict(fp32_precision=_fp32_precision(), cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
               matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32))
    root = smoke.CORPUS_DIR
    cfg = train.TrainConfig()
    for c in range(args.corpora):
        shutil.rmtree(root, ignore_errors=True)
        root.mkdir(parents=True)
        try:  # the datasets read the corpus as they go
            failures = []
            smoke._corpus(root, failures)
            if failures:
                raise AssertionError("; ".join(failures))
            curriculum = build_curriculum(
                *(str(root / f"{g}_*.exr") for g in ("Output_Reference", "Albedo", "Trans",
                                                     "Input0_Radiance_A", "Input0_Radiance_B")),
                crop_size=cfg.crop_size)
            # chip_smoke._mono's probe batch
            batch = next(curriculum[0][1].batches(cfg.batch_size, np.random.default_rng(7)))
            x, y = train.Trainer.select_random_channel(batch, np.random.default_rng(8), "cpu")
            for mode in args.modes.split(","):
                torch.backends.cudnn.deterministic = mode == "deterministic"
                first = None
                for i in range(args.trials):
                    record, weights = _trial(curriculum, x, y, args.repeats, first,
                                             args.precision)
                    first = first or weights
                    _emit(dict(corpus=c, mode=mode, trial=i, before=before, **record))
        finally:
            shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
