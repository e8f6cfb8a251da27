"""Smoke run of litbox_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from litbox_tpu_torch/csrc (one nvcc call)
and, at first use, the EXR decoder (litbox_tpu_torch/native, one g++ call),
and runs thirteen phases, each printed with its wall seconds:

- kernels: each kernel (K1 scan, K2 shear, K3 shear_reduce, K4 fused
  rotate-and-sum) held against its plain PyTorch version at the shapes of
  bench.py's frame, of the pipeline below, of the realtime 1080p
  profile's per-frame resolve and (K1-K3) of the simulation phase at 256^2
  (the exact collimated field's one bin at S=1024 and 384, K2 and K3 on
  interleaved rows; the paired engine's two-tracer scan and the realtime
  configuration's group of 16 at S=384; the demo phase's full resolve at
  S=256; the parallel phase's bin-sharded resolves, K2 and K3 on
  interleaved rows of D/n bins at S=640, and at S=384 with more than one
  card), each timed (CUDA events, median of 7) beside
  the bound, its share and a library yardstick where one exists (K1 also
  beside an empty kernel launched on its grid, and from a flushed L2 where
  its bytes fit the 50 MB L2); K2 and K3 at the
  per-frame resolve's shape from a flushed L2, K3 held equal to the
  in-order sum of K2's outputs bit for bit, and K4 also with LARGE_DELTA,
  two calls held equal bit for bit, beside its own counts of the windows
  it took by its tap path and of the bytes its staged copies read.
- frame: bench.py's frame at 256^2 (rotated fields with 128 bins, 10 trace
  frames of 2,000,000 photons with 524,288 bounce chains, one resolve and
  the HDR conversion) with its checks.
- pipeline: engine.pipeline.make_frame_fn at the realtime profile's sim
  size (480x272, S=640, D=128) with PipelineConfig's defaults (1,000,000
  photons, 2 bounces, the mono UNet of size 5 with 32 features and weights
  from a fixed seed, UE5 tone map): 10 frames, the time of each stage,
  photons/s, peak memory, and checks of the output, of the analytic direct
  energy, of the last resolve against the plain path and of the card's
  denoiser against the CPU.
- fused_resolve: the pipeline's last sources resolved through K1 + K4 and
  through resolve_raw (K1 -> K2 -> K3), with all bins and with 1/4 of them.
- production: the shipped realtime frame (engine.realtime, the JAX package's
  runs/bench_1080p.py --pair-fast on REALTIME_1080P) at 480x272, S=640,
  D=128 on bench_1080p.py's scene, with the shipped net's shape (RGB, size
  4, 16 features) and bf16 weights from a fixed seed: 1 warm frame, 32
  timed frames (ms per displayed frame, photons/s, peak memory), 16 frames
  with CUDA events between the stages, 8 frames beside a float32 display of
  the same frames (the bf16 display held within BF16_DISPLAY_TOL of it),
  8 frames under torch's sync debug mode (none may make the host wait),
  resolve_raw against K1 + K4 at the group shape, and the frame's checks.
- simulation: engine.Simulation, the README's quickstart (README.md:133-141)
  at 256^2 with 65,536 photons a tracer, in six configurations: reference
  (engine "rbt", 32 steps, a convergence measure every 8) and paired
  ("rbt-paired"): ms a step, photons/s, the first output read, host syncs
  over 9 steps of a second run, peak memory; collimated (a laser and a
  directional light added): the per-scene precompute's ms and
  collimated_direct_raw held against the same composition through the
  plain versions on the card, the exact field's HDR in vacuum, 8 steps;
  realtime (jitter ladder, 16 display groups, a display read a step);
  ai (AIAccelerator, blend "auto", the mono UNet of size 5 with 32
  features and float32 weights from a fixed seed carried by
  convert.unet_from_flax): ms an on_step; oracle (the plain march): ms a
  frame. K1-K3 must be launched by reference and by collimated, and a
  Simulation on the card must refuse a CPU scene.
- hybrid: Strategy.HYBRID and the deterministic multi-bounce cascade, with
  TF32 off: reference (the README quickstart with the hybrid strategy on
  'rbt', forward refresh 1, 32 steps: ms a step, the first output read,
  peak memory, host syncs over 9 steps gated at 3 + 1, the backward frame
  count); realtime (REALTIME_1080P's sim size 480x272 on
  runs/prof_backward_r5.py's cloudy scene, Mode.REALTIME, 16 steps: ms a
  step, the count of forward resolves, and backward_gather_rbt at S=640 by
  CUDA events beside its bound, held against the same call on CPU copies to
  1e-4 of its maximum); oracle (the faithful march, 2 frames: ms a frame);
  dom (the cloudy scene at 256^2 with 3 bounces, dom_bounce on both
  integrators, refresh 8, 16 steps: ms of one cascade refresh by CUDA
  events, the cascade held against its composition through the plain K1-K3
  on the card to 1e-5, linearity to 1e-5, the output's mass within 5% of
  the same steps with Monte-Carlo bounces). K1-K3 must be launched by
  reference and by dom, and each output must lie on the card.
- train: denoiser training with TF32 off, in three configurations. corpus:
  8 scenes at 256^2 (the README scene with light positions, colors and one
  or two medium rects from a seed) through Simulation on "rbt-paired":
  tracers A and B after 4 steps, the reference after 64, albedo and
  transmissibility from the GBuffer, written as ZIP float EXRs into
  _smoke/ of the checkout and read back through read_image_linear: every
  file bit for bit, the native decoder built, used for every file and equal
  to the Python codec; K1-K3 launched; ms to generate, write, build the
  decoder (g++, first use) and read.
  mono: TrainConfig()'s defaults (size 5, 32 features, crop 256, batch 4)
  through build_curriculum and Trainer.fit for 40 steps: ms a step (host
  clock), crops/s, TFLOP/s from unet_flop beside the float32 peak, peak
  memory, the first and last loss; one step's gradients on the card within
  1e-3 of their maximum of the same step on the CPU, save and load giving
  the same eval_fn output bit for bit, AIAccelerator.from_checkpoint
  running an on_step on a 256^2 Simulation. pair: the round-5 recipe
  (runs/train_denoiser_r5.py SMOKE off, LITBOX_TRAIN_STEPS=40) on
  DeviceStages of the corpus with sample_pair (identity_p 0.15) for 40
  steps: ms a step, peak memory, no host sync in the loop (torch's sync
  debug mode), finite losses, the learning rate at steps 0, the end of
  warm-up and the end, the checkpoint (optimizer included) round-tripping,
  from_checkpoint with blend "auto" running an on_step.
- data: data.TrainingFactory with runs/gen_dataset_r2.py's recipe (:17-31:
  256², input profiles (5, 8192), (1, 65536), (1, 262144), convergence at
  262,144 photons to 6e-4 within 250 frames, seed 1042, MC direct inputs,
  jittered bins, 512² substrates) cut to 4 of its 160 scenes, into
  _smoke/data/ (removed at the end): ms a scene split into set-up
  (substrates timed apart), input profiles and the convergence loop, frames
  to convergence, photons/s of the loops, host syncs over one convergence
  loop (the first kept sample's again, under torch's sync debug mode), the
  discarded ids. Gates: a scene kept, each kept sample complete with 3 profiles,
  every EXR finite and read by the native decoder, K1-K3 launched, a
  resumed factory returning the same ids and writing no file (sizes and
  mtimes), consolidate_sessions numbering the kept samples 0..n-1,
  nn.dataset.build_curriculum loading the session (Final on
  Input2_Radiance_A/B) into batches of (n, 256, 256, 3), and one of the
  run's substrates made on the card within SUBSTRATE_TOL of the CPU's (at
  most SUBSTRATE_FLIPS texels whose shape test flips).
- demo: demo.abduction's render_sequence (8 frames, 128², 16,384 photons,
  3 sim frames) and play_sequence (the canonical 20 inputs, 128², 8,192
  photons, 2 sim frames) at their defaults: ms a frame, the final score;
  every frame finite in [0, 1], the HDR and the composite on the card until
  the PNG copy, play_sequence's state equal to the same script on an
  AbductionGame alone, K1-K3 launched (as in the JAX package, only each
  sequence's first frame is simulated: ROADMAP C7). Then diag.picker on
  the README quickstart at 256² (4 steps) with the simulation phase's
  AIAccelerator: ms a view, all 12 views finite, dump_all writing 12 PNGs.
- parallel: litbox_tpu_torch/parallel/ on a world of every visible card
  with NCCL (one rank a card, rank 0 in this process, the others spawned
  by parallel/world.py; no fallback to gloo), printing world_size and
  backend, in four configurations at full width: oracle
  (sharded_trace_frame on the README scene at 256², 65,536 photons a
  rank, one frame); rbt (tests/test_parallel.py's realistic shape: 256²,
  S=384, D=128, 65,536 photons a rank, 2 bounces, 4 frames, then
  sharded_rbt_resolve, held to the mean over the ranks of resolve_raw
  within 1e-6 of its maximum, and sharded_rbt_resolve_bins, held to it
  within RESOLVE_TOL); bins (the shipped frame's scene, S=640, D=128,
  131,072 + 16,384 photons a row, 3 bounces, BRDF on: the first frame +
  bins_resolve held to the unsharded rbt_trace_frame + resolve_raw on the
  generator row 0 derives within 2e-4 relative and 1e-6 absolute, no
  all-to-all overflow, then 4 timed frames); train
  (build_sharded_train_step at its defaults, 3 steps with TF32 off, the
  first loss within 1e-4 of an unsharded step of the port's net). ms a
  frame or a step, peak memory above each configuration's start (the
  fields, sources or net included); K1-K3 must be launched by the sharded
  calls (the references beside them are not counted).
- rotfused_split: the four variants of K4's cost split (V1-V4,
  litbox_tpu_torch/prof/rotfused.py, runs/prof_rotfused.py's kernels) and
  K4 itself (also with a 1.2 rad delta, LARGE_DELTA), timed at
  (384, 640, 640) and at the frame's group shape (24, 640, 640) beside
  their byte bounds, then each held against its plain version, V4 and K4
  beside the bytes their copies read as the kernels count them (a counting
  launch, its output equal to the plain launch's bit for bit), and V2 held
  equal to V1 bit for bit
  (both add the images in order); V1 and V2 beside torch.sum, with their
  library_ratio (kernel ms / library ms).
- microops: the five data movements of runs/prof_microops.py (transpose,
  double transpose, row roll, column roll, flip;
  litbox_tpu_torch/prof/microops.py) at the script's (64, 640, 640), the
  pipeline's resolve (384, 640, 640) and the frame's group (24, 640, 640),
  from a flushed L2, beside their byte bounds and the library call that
  computes the same function (torch.roll for the rolls, with a uniform
  shift) and the ratio of the two times (library_ratio), each held
  against its plain version bit for bit; then
  resolve_raw's steps timed one by one at the pipeline's and the group's
  shape, its rot90/cat and transpose copies beside the B5 kernels.

Every kernel counter is set to 0 just before a path is driven and read just
after; a kernel of the path that was not launched, or any failed check,
raises, so the exit code is not 0. Each K1-K3 launch's shape and static
arguments are recorded, in the kernels phase where the kernel is held
against its plain version and on the paths from frame to parallel; a
path launch at a shape the kernels phase did not hold raises too (the
`kernel_signatures` line). The lines before the last carry one JSON
line per phase, the kernels line and the card's name and power limit; the
last line is the device record.

With --resolve-f64, the pipeline phase also measures how far its last
resolve, the card's and the plain one, and the scan alone lie from float64
(the `resolve_vs_float64` entry of its line, read by no check); by default
that entry is null.

Needs one CUDA device, nvcc, g++ with zlib and nvidia-smi; imports torch,
numpy and litbox_tpu_torch only.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from litbox_tpu_torch import convert, native, parallel
from litbox_tpu_torch.core import luts
from litbox_tpu_torch.core.types import REALTIME_1080P, SimulationProfile
from litbox_tpu_torch.data import factory as data_factory
from litbox_tpu_torch.data import sessions, substrate
from litbox_tpu_torch.demo import abduction, game
from litbox_tpu_torch.diag import picker
from litbox_tpu_torch.engine import Mode, Simulation, Strategy, pipeline, realtime
from litbox_tpu_torch.io import read_exr_rgb, read_image_linear, write_exr_rgb
from litbox_tpu_torch.nn import train
from litbox_tpu_torch.nn.dataset import build_curriculum
from litbox_tpu_torch.nn.device_data import DeviceStages, stack_stage
from litbox_tpu_torch.nn.loss import HdrLossConfig, hdr_loss
from litbox_tpu_torch.nn.unet import LitboxDenoiserNet, TransformConfig, init_weights
from litbox_tpu_torch.ops import attnscan, cuda_lib, rotate
from litbox_tpu_torch.parallel import train_sharded as parallel_train
from litbox_tpu_torch.parallel import world as par_world
from litbox_tpu_torch.prof import microops, rotfused
from litbox_tpu_torch.scene import SceneBuilder, rasterize
from litbox_tpu_torch.sim import rbt, tracers
from litbox_tpu_torch.sim.backward import (backward_bin_for_frame, backward_gather,
                                           backward_gather_rbt)
from litbox_tpu_torch.sim.dom import dom_bounce_sources
from litbox_tpu_torch.sim.oracle import to_hdr

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
L2_BYTES = 50e6            # H100 SXM L2 cache

# bench.py's frame (bench.py:36-98).
RAYS_PER_FRAME = 2_000_000
BOUNCE_RAYS = 524_288
FRAMES = 10
BOUNCES = 2
RESOLUTION = 256
N_BINS = 128

KERNELS = {
    "attenuation_scan_rows": dict(
        source="litbox_tpu_torch/csrc/attnscan.cu",
        replaces="litbox_tpu/ops/attnscan.py:97", tol=1e-5),
    "shear": dict(source="litbox_tpu_torch/csrc/rotate.cu",
                  replaces="litbox_tpu/ops/rotate.py:163", tol=1e-5),
    # Sequential sum over 128 images in the kernel, pairwise in the plain
    # version: up to 128 float32 roundings apart.
    "shear_reduce": dict(source="litbox_tpu_torch/csrc/rotate.cu",
                         replaces="litbox_tpu/ops/rotate.py:210", tol=2e-5),
    # Up to 128 images summed in order in the kernel, pairwise in the plain
    # version, as for shear_reduce.
    "rotate_planar_sum_fused": dict(source="litbox_tpu_torch/csrc/rotfused.cu",
                                    replaces="litbox_tpu/ops/rotate.py:458",
                                    tol=2e-5),
}
# K4's cost split: up to 384 images summed in order in the kernels, in
# PyTorch's order in the plain versions.
SPLIT = ("copy_accum", "transpose2_accum", "shear1_accum", "shear3_accum")
for _name in SPLIT:
    KERNELS[_name] = dict(source="litbox_tpu_torch/csrc/prof_rotfused.cu",
                          replaces="runs/prof_rotfused.py:38", tol=2e-5)
# runs/prof_microops.py's data movements, each at its pallas_call's line:
# pure movement (and a doubling), so kernel and plain agree bit for bit.
MICROOPS = {"transpose": 55, "transpose2": 72, "roll_rows": 95, "roll_cols": 119,
            "flip2": 145}
for _name, _line in MICROOPS.items():
    KERNELS[_name] = dict(source="litbox_tpu_torch/csrc/prof_microops.cu",
                          replaces=f"runs/prof_microops.py:{_line}", tol=0.0)
COUNTERS = {"attenuation_scan_rows": attnscan.attenuation_scan_rows,
            "shear": rotate.shear, "shear_reduce": rotate.shear_reduce,
            "rotate_planar_sum_fused": rotate.rotate_planar_sum_fused,
            **{name: getattr(rotfused, name) for name in SPLIT},
            **{name: getattr(microops, name) for name in MICROOPS}}
# Operations per image and output texel of the fused rotation: 7 two-tap
# lerps (3 each) and 7 shift evaluations (4 each), csrc/rotfused.cu.
ROT3_OPS = 49
# A traced delta of 1.2 rad: residuals up to pi/4 + 1.2, whose windows exceed
# K4's stages, so most images take the kernel's general (tap) path.
LARGE_DELTA = 1.2
UNET_SEED = 5
# The card's resolve against the plain resolve on CPU copies, relative to
# its maximum: both are float32 roundings of one sum (1.25e-6 at S=640 on
# the pipeline's sources, most of it K1's chunked scan, PERF.md).
RESOLVE_TOL = 1e-5


# The kernels each path must launch: resolve_raw runs K1 -> K2 -> K3, the
# fused resolve K1 -> K4.
RESOLVE_KERNELS = ("attenuation_scan_rows", "shear", "shear_reduce")
FUSED_KERNELS = ("attenuation_scan_rows", "rotate_planar_sum_fused")


def reset_counts() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def host_syncs(fn) -> list:
    """Where fn() makes the host wait for the card: torch's sync debug mode
    warns at each synchronizing call; returns, for each, the innermost line
    of the port (or of this script) on the stack, as file:line."""
    sites = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1]
                if "litbox_tpu_torch" in f.filename or f.filename.endswith("chip_smoke.py")]
        where = ours[-1] if ours else traceback.FrameSummary(filename, lineno, "")
        sites.append(f"{os.path.relpath(where.filename)}:{where.lineno}")

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sites


def unlaunched(launches: dict, names) -> list:
    return [n for n in names if launches[n] == 0]


# The static shape and arguments of each K1-K3 launch on the card, as the
# wrapper passes them to the kernel library (the group index left out: it
# moves the same code over other bins), by where it ran: "checked" where the
# kernels phase holds the kernel against its plain version, "path" on a main
# path. main() raises unless every path signature was checked.
SIGNATURE_ARGS = {  # C entry point: (kernel, the ints that make the key)
    "litbox_attnscan_rows": ("attenuation_scan_rows", (7, 8, 9, 11, 12)),
    "litbox_shear": ("shear", tuple(range(3, 9))),
    "litbox_shear_reduce": ("shear_reduce", tuple(range(3, 12))),
}
SIGNATURES = {"checked": set(), "path": set()}
_recording = [None]


class _RecordingLibrary:
    """The kernel library, with K1-K3's entry points adding their launch's
    signature to the set being recorded before they launch."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, entry):
        fn = getattr(self._lib, entry)
        if entry not in SIGNATURE_ARGS:
            return fn
        kernel, positions = SIGNATURE_ARGS[entry]

        def launch(*args):
            if _recording[0] is not None:
                SIGNATURES[_recording[0]].add((kernel, tuple(args[i] for i in positions)))
            return fn(*args)
        return launch


def install_recorders() -> None:
    """Route the wrappers' `cuda_lib.library()` through _RecordingLibrary."""
    recorded = _RecordingLibrary(cuda_lib.library())
    cuda_lib.library = lambda: recorded


@contextlib.contextmanager
def recording(into: str):
    saved, _recording[0] = _recording[0], into
    try:
        yield
    finally:
        _recording[0] = saved


def unchecked_signatures() -> list:
    return sorted(SIGNATURES["path"] - SIGNATURES["checked"])


def phase(name: str, t0: float, **info) -> None:
    print(f"phase {name} {time.perf_counter() - t0:.3f}s "
          + " ".join(f"{k}={v}" for k, v in info.items()), flush=True)


_CYCLES_PER_MS = None


def _sleep_ms(ms: float) -> None:
    """Queue a spin of about `ms` milliseconds on the current stream
    (torch.cuda._sleep counts clock cycles; the rate is measured once)."""
    global _CYCLES_PER_MS
    if _CYCLES_PER_MS is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(1 << 24)
        end.record()
        end.synchronize()
        _CYCLES_PER_MS = (1 << 24) / start.elapsed_time(end)
    torch.cuda._sleep(int(ms * _CYCLES_PER_MS))


def time_ms(fn, reps: int = 7, warmup: int = 2, cold: bool = False) -> float:
    """Median of `reps` CUDA-event timings of fn() after `warmup` calls:
    device time only. Before each timed call the stream is held busy for
    twice fn's host time (measured on the last warm-up call) plus 0.5 ms, so
    that fn's launches are queued before the start event runs and the host's
    work between them does not land inside the events. Inputs above the
    50 MB L2 cache are read from device memory on every call; with `cold`,
    a 128 MB buffer is written before each timed call (outside the events),
    so that smaller inputs are too."""
    flush = torch.empty(32 << 20, device="cuda") if cold else None
    for _ in range(warmup):
        torch.cuda.synchronize()
        h = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - h) * 1e3
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        _sleep_ms(2 * host_ms + 0.5)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least time for the work on this card: bytes over the memory rate or
    operations over the float32 rate, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got, ref) -> dict:
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    scale = max(float(r.abs().max()) for r in ref)
    rel = err / max(scale, 1e-30)
    tol = KERNELS[name]["tol"]
    if not all(torch.isfinite(g).all() for g in got) or rel > tol:
        raise AssertionError(f"{name}: kernel vs plain max_abs_err {err} "
                             f"(relative to max|plain| {rel}) exceeds {tol}")
    return dict(max_abs_err=err, max_rel_err=rel)


def check_scan(gen, d, s, n_groups, group, tracers) -> dict:
    t = torch.rand((d, s, s), generator=gen, device="cuda") * 0.7 + 0.3
    srcs = [torch.rand((tracers * d, s, s), generator=gen, device="cuda")
            for _ in range(3)]
    args = dict(group=group, n_groups=n_groups, src_offset=(tracers - 1) * d)
    run = lambda: attnscan.attenuation_scan_rows(t, *srcs, **args)
    plain = lambda: attnscan.attenuation_scan_rows_plain(t, *srcs, **args)
    with recording("checked"):
        got = run()
    out = compare("attenuation_scan_rows", got, plain())
    cells = d // n_groups * s * s
    b, by = bound(7 * 4 * cells, 10 * cells)
    # Bytes that fit the L2 are read from a flushed cache, as a scene's one
    # collimated scan reads them. An empty kernel on K1's grid and blocks for
    # this shape, timed the same way: the launch latency under K1's time.
    cold = 7 * 4 * cells < L2_BYTES
    lib, stream = cuda_lib.library(), cuda_lib.stream_handle(t.device)
    empty = lambda: cuda_lib.check(lib.litbox_attnscan_empty(d // n_groups, s, s, stream),
                                   "attnscan_empty")
    ms = time_ms(run, cold=cold)
    out.update(shape=f"t({d},{s},{s}) src 3x({tracers * d},{s},{s}) "
                     f"group {group}/{n_groups} src_offset {args['src_offset']}"
                     f"{' L2 flushed' if cold else ''}",
               ms=ms, plain_ms=time_ms(plain, cold=cold), bound_ms=b, bound_by=by,
               share=b / ms, empty_launch_ms=time_ms(empty, cold=cold), library_ms=None)
    return out


def tap_bytes(coef, s, row_lo, row_hi, row_div=1, elem_scale=1) -> float:
    """Bytes of the input rows [row_lo, row_hi) of (N, R, S * elem_scale)
    images of S texels a row that a shear's taps reach: row r of image d is
    shifted by j = floor(coef[d] * (r // row_div + 0.5 - S/2)) texels, so its
    taps read texels [max(0, j), min(S, S + j + 1)), elem_scale floats each.
    The rest of the row is never read (the kernels zero-fill it without a
    load)."""
    r = torch.div(torch.arange(row_lo, row_hi, device=coef.device), row_div,
                  rounding_mode="floor").float()
    j = torch.floor(coef[:, None] * ((r + 0.5) - s / 2.0)).clamp(-s - 2, s + 2).long()
    reached = (torch.clamp(s + j + 1, max=s) - torch.clamp(j, min=0)).clamp(min=0)
    return 4.0 * elem_scale * float(reached.sum())


def check_shear(gen, n, s, cold=False) -> dict:
    img = torch.rand((n, s, s), generator=gen, device="cuda")
    coef = (torch.rand((n,), generator=gen, device="cuda") - 0.5) * 1.4
    run = lambda: rotate.shear(img, coef, 1, 1, s)
    plain = lambda: rotate.shear_plain(img, coef, 1, 1, s)
    with recording("checked"):
        got = run()
    out = compare("shear", got, plain())
    # Yardstick: grid_sample doing the same row shift (zero padding,
    # align_corners=True so x = lane + shift in pixel units).
    rows = torch.arange(s, device="cuda", dtype=torch.float32)
    shift = coef[:, None] * ((rows + 0.5) - s / 2.0)             # (n, s)
    x = rows[None, None, :] + shift[:, :, None]                  # (n, s, s)
    y = rows[None, :, None].expand(n, s, s)
    grid = torch.stack([2 * x / (s - 1) - 1, 2 * y / (s - 1) - 1], -1)
    library = lambda: torch.nn.functional.grid_sample(
        img[:, None], grid, mode="bilinear", padding_mode="zeros",
        align_corners=True)
    lib_err = float((library()[:, 0] - plain()).abs().max())
    b, by = bound(tap_bytes(coef, s, 0, s) + 4 * n * s * s, 4 * n * s * s)
    out.update(shape=f"({n},{s},{s}){' L2 flushed' if cold else ''}",
               ms=time_ms(run, cold=cold), plain_ms=time_ms(plain, cold=cold),
               bound_ms=b, bound_by=by, bound_full_rows_ms=bound(8 * n * s * s, 0)[0],
               library_ms=time_ms(library, cold=cold),
               library="torch.nn.functional.grid_sample",
               library_max_abs_err=lib_err)
    return out


def check_shear_reduce(gen, n, s, row_lo, row_hi, cold=False) -> dict:
    img = torch.rand((n, s, s), generator=gen, device="cuda")
    coef = (torch.rand((n,), generator=gen, device="cuda") - 0.5) * 0.9
    args = (1, 1, s, rotate.ALPHA_BOUND, row_lo, row_hi, 3)
    run = lambda: rotate.shear_reduce(img, coef, *args)
    plain = lambda: rotate.shear_reduce_plain(img, coef, *args)
    with recording("checked"):
        got = run()
    out = compare("shear_reduce", got, plain())
    # K3 rounds each tap as K2 rounds its output and adds in image order, so
    # it equals the in-order sum of K2's outputs bit for bit.
    rows = row_hi - row_lo
    each = rotate.shear(img, coef, 1, 1, s)[:, row_lo:row_hi].reshape(3, n // 3, rows, s)
    total = each[:, 0].clone()
    for k in range(1, n // 3):
        total += each[:, k]
    if not torch.equal(got, total):
        raise AssertionError("shear_reduce differs from the in-order sum of shear: "
                             f"max_abs_err {float((got - total).abs().max())}")
    del each, total
    # The read floor: one torch.sum over the same rows reads the bytes K3
    # reads (a yardstick of this card's rate, not the same function).
    needed = img[:, row_lo:row_hi]
    floor_ms = time_ms(lambda: torch.sum(needed, 0), cold=cold)
    b, by = bound(tap_bytes(coef, s, row_lo, row_hi) + 4 * 3 * rows * s, 4 * n * rows * s)
    out.update(shape=f"({n},{s},{s}) rows [{row_lo},{row_hi}) groups 3"
                     f"{' L2 flushed' if cold else ''}",
               ms=time_ms(run, cold=cold), plain_ms=time_ms(plain, cold=cold),
               bound_ms=b, bound_by=by,
               bound_full_rows_ms=bound(4 * (n * rows * s + 3 * rows * s), 0)[0],
               equals_shear_sum=True, read_floor_ms=floor_ms, library_ms=None)
    return out


def check_shear_interleaved(gen, s, row_div, elem_scale, n=1) -> dict:
    """K2 on n channel-interleaved images, as rotate_bins runs it on the
    exact collimated field (one) and on the cascade's D bins: the x shear
    (n, S, 3S) at elem_scale 3 or the y shear (n, 3S, S) at row_div 3. No
    single PyTorch call shears this layout, so library_ms is null."""
    rows, width = s * row_div, s * elem_scale
    img = torch.rand((n, rows, width), generator=gen, device="cuda")
    coef = (torch.rand((n,), generator=gen, device="cuda") - 0.5) * 1.4
    run = lambda: rotate.shear(img, coef, row_div, elem_scale, s)
    plain = lambda: rotate.shear_plain(img, coef, row_div, elem_scale, s)
    with recording("checked"):
        got = run()
    out = compare("shear", got, plain())
    b, by = bound(tap_bytes(coef, s, 0, rows, row_div, elem_scale) + 4 * n * rows * width,
                  4 * n * rows * width)
    out.update(shape=f"({n},{rows},{width}) row_div {row_div} elem_scale {elem_scale}",
               ms=time_ms(run, cold=True), plain_ms=time_ms(plain, cold=True),
               bound_ms=b, bound_by=by, library_ms=None)
    return out


def check_shear_reduce_interleaved(gen, s, row_lo, row_hi, n=1) -> dict:
    """K3 on n channel-interleaved (n, S, 3S) images at elem_scale 3, rows
    [row_lo, row_hi): rotate_bins' fused last shear on one bin (the exact
    collimated field) or on the cascade's D bins, summed in order."""
    img = torch.rand((n, s, 3 * s), generator=gen, device="cuda")
    coef = (torch.rand((n,), generator=gen, device="cuda") - 0.5) * 0.9
    args = (1, 3, s, rotate.ALPHA_BOUND, row_lo, row_hi, 1)
    run = lambda: rotate.shear_reduce(img, coef, *args)
    plain = lambda: rotate.shear_reduce_plain(img, coef, *args)
    with recording("checked"):
        got = run()
    out = compare("shear_reduce", got, plain())
    rows = row_hi - row_lo
    b, by = bound(tap_bytes(coef, s, row_lo, row_hi, 1, 3) + 4 * rows * 3 * s,
                  4 * n * rows * 3 * s)
    out.update(shape=f"({n},{s},{3 * s}) rows [{row_lo},{row_hi}) elem_scale 3",
               ms=time_ms(run, cold=True), plain_ms=time_ms(plain, cold=True),
               bound_ms=b, bound_by=by, library_ms=None)
    return out


def rot3_counts(chans, base, delta, expect) -> dict:
    """K4's own counts of its work on these inputs (the kernel's counting
    instance, csrc/rotfused.cu), whose output must equal `expect` bit for
    bit: the share of (image, tile) windows it took by the tap path and the
    bytes its staged windows' copies read per output texel and image."""
    counts = torch.zeros(4, dtype=torch.int64, device="cuda")
    if not torch.equal(rotate.rotate_planar_sum_fused(chans, base, delta, counts), expect):
        raise AssertionError("rotate_planar_sum_fused: the counting launch differs")
    windows, staged, texels, copied = counts.tolist()
    return dict(counted_general_share=1 - staged / windows,
                counted_bytes_per_staged_texel=copied / texels if texels else None)


def check_rotfused(gen, s, stride, delta) -> dict:
    """K4 on 3 channels of the bins 0, stride, 2*stride, ... of N_BINS."""
    base = tuple(-i * 2 * np.pi / N_BINS for i in range(0, N_BINS, stride))
    d = len(base)
    chans = tuple(torch.rand((d, s, s), generator=gen, device="cuda") for _ in range(3))
    if isinstance(delta, float) and delta:
        delta = torch.tensor(delta, device="cuda")  # traced, as the jitter phase
    run = lambda: rotate.rotate_planar_sum_fused(chans, base, delta)
    plain = lambda: rotate.rotate_planar_sum_fused_plain(chans, base, delta)
    ref = plain()
    out = compare("rotate_planar_sum_fused", run(), ref)
    # Yardstick: affine_grid + grid_sample rotating every image by its angle
    # (bilinear, zero padding), summed per channel. Another discretization
    # of the same rotation, so its deviation is reported, not held.
    x = torch.stack(chans).reshape(3 * d, 1, s, s)
    ang = torch.tensor(base, device="cuda") + delta

    def library():
        c, sn, z = torch.cos(ang), torch.sin(ang), torch.zeros_like(ang)
        theta = torch.stack([torch.stack([c, -sn, z], -1),
                             torch.stack([sn, c, z], -1)], 1).repeat(3, 1, 1)
        grid = F.affine_grid(theta, (3 * d, 1, s, s), align_corners=False)
        return F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=False).reshape(3, d, s, s).sum(1)

    lib = library()
    runs = len(rotate._quadrant_groups(base))
    b, by = bound(4 * (3 * d * s * s + 3 * runs * s * s), ROT3_OPS * 3 * d * s * s)
    got = run()
    if not torch.equal(got, run()):
        raise AssertionError("rotate_planar_sum_fused: two calls differ")
    counted = rot3_counts(chans, base, delta, got)
    out.update(shape=f"3x({d},{s},{s}) runs {runs} delta "
                     f"{float(delta):.6f}{' (tensor)' if torch.is_tensor(delta) else ''}",
               equals_plain_bits=bool(torch.equal(got, ref)), repeat_equal_bits=True,
               **counted, ms=time_ms(run), plain_ms=time_ms(plain), bound_ms=b,
               bound_by=by,
               library_ms=time_ms(library),
               library="F.affine_grid + F.grid_sample, summed",
               library_max_dev_rel=float((lib - ref).abs().max() / ref.abs().max()),
               library_mean_dev_rel=float((lib - ref).abs().mean() / ref.abs().mean()))
    del chans, x, lib, ref
    return out


def kernels_phase() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    d = N_BINS
    # bench.py's resolve: S=384, 3*D images, rows 64..320. The pipeline's
    # resolve (make_frame_fn at REALTIME_1080P's sim size 480x272): S=640,
    # all bins from a one-tracer source, 3*D images, rows 128..512. The
    # realtime profile's per-frame resolve: one group of 16 from a two-tracer
    # source, 3*8 images, rows 128..512; K2 and K3 there from a flushed L2,
    # since their inputs (39 MB, 24 MB) fit the 50 MB L2.
    # K4: bench.py's and the realtime resolve shapes, with delta 0 and a
    # traced delta of -0.3 bins, the realtime shape at 1/4 of the bins, and
    # with LARGE_DELTA (residuals past the stages' reach: the general path).
    jitter = -0.3 * 2 * np.pi / d
    # The simulation phase at 256^2: the exact collimated field's one bin,
    # S=1024 for a directional light and S=384 for a laser, K2 and K3 on
    # rotate_bins' channel-interleaved rows, from a flushed L2; the paired
    # engine's scan of a two-tracer source at S=384; the realtime
    # configuration's group of 16 at S=384, K2 and K3 from a flushed L2.
    # At S=640 also a full scan of a two-tracer source's second tracer
    # (src_offset D) and the fused_resolve phase's resolve of 1/4 of the
    # bins (3*32 images). The hybrid phase's cascade at S=384: K2 and K3 on
    # the D bins' interleaved rows (rotate_back and the forward rotation).
    # The demo phase's Simulation at 128²: the full resolve at S=256 (rows
    # 64..192). The parallel phase's bin-sharded resolves: K1 and
    # rotate_bins' interleaved K2 and K3 on each rank's D/n bins, at S=384
    # (the data-parallel RBT) and S=640 (the bin-sharded RBT); with one card
    # D/n = D, and the S=384 cases are the hybrid phase's.
    # main() raises if a path launches K1-K3 at a shape not held here.
    dl = d // torch.cuda.device_count()
    sharded = dict(
        attenuation_scan_rows=(() if dl == d else (check_scan(gen, dl, 384, 1, 0, 1),
                                                   check_scan(gen, dl, 640, 1, 0, 1))),
        shear=((check_shear_interleaved(gen, 640, 1, 3, n=dl),
                check_shear_interleaved(gen, 640, 3, 1, n=dl))
               + (() if dl == d else (check_shear_interleaved(gen, 384, 1, 3, n=dl),
                                      check_shear_interleaved(gen, 384, 3, 1, n=dl)))),
        shear_reduce=((check_shear_reduce_interleaved(gen, 640, 128, 512, n=dl),)
                      + (() if dl == d else (
                          check_shear_reduce_interleaved(gen, 384, 64, 320, n=dl),))))
    results = {
        "attenuation_scan_rows": (check_scan(gen, d, 384, 1, 0, 1),
                                  check_scan(gen, d, 640, 1, 0, 1),
                                  check_scan(gen, d, 640, 16, 3, 2),
                                  check_scan(gen, d, 640, 16, 3, 1),
                                  check_scan(gen, d, 640, 1, 0, 2),
                                  check_scan(gen, d, 640, 4, 3, 1),
                                  check_scan(gen, 1, 1024, 1, 0, 1),
                                  check_scan(gen, 1, 384, 1, 0, 1),
                                  check_scan(gen, d, 384, 1, 0, 2),
                                  check_scan(gen, d, 384, 16, 3, 1),
                                  check_scan(gen, d, 256, 1, 0, 1)),
        "shear": (check_shear(gen, 3 * d, 384), check_shear(gen, 3 * d, 640),
                  check_shear(gen, 3 * d // 16, 640, cold=True),
                  check_shear_interleaved(gen, 1024, 1, 3),
                  check_shear_interleaved(gen, 1024, 3, 1),
                  check_shear_interleaved(gen, 384, 1, 3),
                  check_shear_interleaved(gen, 384, 3, 1),
                  check_shear(gen, 3 * d // 16, 384, cold=True),
                  check_shear(gen, 3 * d // 4, 640),
                  check_shear_interleaved(gen, 384, 1, 3, n=d),
                  check_shear_interleaved(gen, 384, 3, 1, n=d),
                  check_shear(gen, 3 * d, 256)),
        "shear_reduce": (check_shear_reduce(gen, 3 * d, 384, 64, 320),
                         check_shear_reduce(gen, 3 * d, 640, 128, 512),
                         check_shear_reduce(gen, 3 * d // 16, 640, 128, 512, cold=True),
                         check_shear_reduce_interleaved(gen, 1024, 384, 640),
                         check_shear_reduce_interleaved(gen, 384, 64, 320),
                         check_shear_reduce(gen, 3 * d // 16, 384, 64, 320, cold=True),
                         check_shear_reduce(gen, 3 * d // 4, 640, 128, 512),
                         check_shear_reduce_interleaved(gen, 384, 64, 320, n=d),
                         check_shear_reduce(gen, 3 * d, 256, 64, 192)),
        "rotate_planar_sum_fused": (
            check_rotfused(gen, 384, 1, 0.0), check_rotfused(gen, 640, 1, 0.0),
            check_rotfused(gen, 384, 1, jitter), check_rotfused(gen, 640, 1, jitter),
            check_rotfused(gen, 640, 4, 0.0), check_rotfused(gen, 640, 1, LARGE_DELTA)),
    }
    for name, cases in sharded.items():
        results[name] += cases
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return results


def build_scene(w: int, h: int | None = None, tex: int = 128):
    """bench.py's scene (bench.py:51-66), w x w with a 128^2 cloud, or with
    h and tex=256 runs/bench_1080p.py's (:69-89): a point light in a
    smoothed random cloud sprite, made with numpy from seed 0."""
    h = w if h is None else h
    rng = np.random.default_rng(0)
    cloud = rng.uniform(0.0, 1.0, (tex, tex)).astype(np.float32)
    for _ in range(3):
        cloud = (np.roll(cloud, 1, 0) + np.roll(cloud, -1, 0)
                 + np.roll(cloud, 1, 1) + np.roll(cloud, -1, 1) + cloud) / 5.0
    b = SceneBuilder(texture_size=tex)
    b.add_point_light((w * 0.5, h * 0.55), radius=4.0, color=(1.0, 0.85, 0.6),
                      intensity=2.0, bounces=2)
    b.add_sprite((w / 2, h / 2), (w / 2, h / 2), color=(1, 1, 1, 1),
                 log_density=-1.0, texture=np.stack([cloud] * 3 + [cloud], -1))
    scene = b.build(max_lights=2, max_shapes=2, device="cuda")
    return scene, rasterize(scene, h, w)


TRACE_OPTS = dict(max_bounces=BOUNCES, bounce_photons=BOUNCE_RAYS,
                  mc_direct=True, analytic_direct=False, enable_brdf=False,
                  light_kinds=(1,), hist_direct=True)


def frame_phase() -> dict:
    torch.cuda.reset_peak_memory_stats()
    scene, gb = build_scene(RESOLUTION)
    brdf = torch.from_numpy(luts.brdf_lut()).cuda()
    fields = rbt.precompute_rotated_fields(gb, n_bins=N_BINS)
    trace = lambda src, gen: rbt.rbt_trace_frame(
        fields, src, gb, scene.lights, scene.field_textures, brdf, gen,
        RAYS_PER_FRAME, -1, **TRACE_OPTS)
    trace(rbt.zero_sources(fields), torch.Generator(device="cuda").manual_seed(99))
    torch.cuda.synchronize()

    # The main path, with every launch counter at 0 just before it.
    reset_counts()
    gen = torch.Generator(device="cuda").manual_seed(0)
    src = rbt.zero_sources(fields)
    t0 = time.perf_counter()
    emitted = 0
    for _ in range(FRAMES):
        src, n = trace(src, gen)
        emitted += n
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    raw = rbt.resolve_raw(fields, src, RESOLUTION, RESOLUTION)
    hdr = to_hdr(raw, float(FRAMES), gb)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()

    failures = []
    if missing := unlaunched(launches, RESOLVE_KERNELS):
        failures.append(f"kernels of the path were not launched: {missing}")
    if hdr.shape != (RESOLUTION, RESOLUTION, 3) or not bool(torch.isfinite(hdr).all()):
        failures.append("HDR output is not finite of shape (256, 256, 3)")
    elif float(hdr.min()) < 0:
        failures.append(f"HDR output has negative values (min {float(hdr.min())})")

    # Direct energy of one frame against its closed form, which the stamp
    # histogram makes exact: sum over lights of energy * W * H / (2 pi).
    lights = scene.lights
    keep = (lights.active & (lights.bounces > 0)).double()[:, None]
    expect = (lights.energy.double() * keep).sum(0) * RESOLUTION**2 / (2 * np.pi)
    _, vals, _ = rbt.rbt_frame_deposits(
        fields, gb, lights, scene.field_textures, brdf,
        torch.Generator(device="cuda").manual_seed(1), RAYS_PER_FRAME, -1,
        **dict(TRACE_OPTS, max_bounces=1))
    direct_rel = float(((vals.double().sum(0) - expect) / expect).abs().max())
    if direct_rel > 1e-4:
        failures.append(f"direct energy off its closed form by {direct_rel}")
    total = torch.stack([c.double().sum() for c in src])
    bounce_share = float(1 - expect.sum() * FRAMES / total.sum())
    if not 0 < bounce_share < 1:
        failures.append(f"bounce energy share {bounce_share} outside (0, 1)")

    # The kernel resolve against the plain path on the same fields and
    # sources (the plain versions run on CPU copies).
    cpu_fields = rbt.RotatedFields(**{k: v.cpu() for k, v in vars(fields).items()})
    plain_raw = rbt.resolve_raw(cpu_fields, tuple(c.cpu() for c in src),
                                RESOLUTION, RESOLUTION)
    resolve_err = float((raw.cpu() - plain_raw).abs().max() / plain_raw.abs().max())
    if resolve_err > RESOLVE_TOL:
        failures.append(f"kernel resolve vs plain: {resolve_err} of max > {RESOLVE_TOL}")
    if failures:
        raise AssertionError("; ".join(failures))
    # The resolve above was the first at this shape (allocations, lazily
    # loaded library kernels); time it again warm, after the counts were read.
    warm = time_ms(lambda: to_hdr(rbt.resolve_raw(fields, src, RESOLUTION, RESOLUTION),
                                  float(FRAMES), gb), reps=5, warmup=1)
    return dict(frames=FRAMES, photons_emitted=emitted,
                photons_per_s=emitted / (t1 - t0),
                ms_per_trace_frame=(t1 - t0) / FRAMES * 1e3,
                ms_resolve_and_hdr=(t2 - t1) * 1e3,
                ms_resolve_and_hdr_warm=warm,
                peak_memory_bytes=peak, launches=launches,
                direct_energy_rel_err=direct_rel, bounce_energy_share=bounce_share,
                resolve_vs_plain_rel_err=resolve_err, resolve_tol=RESOLVE_TOL,
                hdr_mean=float(hdr.mean()))


def _smooth(a: np.ndarray, n: int = 3) -> np.ndarray:
    for _ in range(n):
        a = (np.roll(a, 1, 0) + np.roll(a, -1, 0) + np.roll(a, 1, -1)
             + np.roll(a, -1, -1) + a) / 5.0
    return a


def build_pipeline_scene(width: int, height: int, seed: int = 0):
    """A night scene modelled on demo/abduction.build_demo_scene (:69-99) at
    width x height, with textures made with numpy from `seed`: haze, hill and
    cloud sprites, two point lights (the analytic direct path), a spot light
    (the MC scatter direct path), a rect with particle alignment (BRDF) and a
    mirror ellipse, and one light of each remaining kind (laser, ambient,
    field with its texture, directional)."""
    rng = np.random.default_rng(seed)
    w, h = float(width), float(height)
    ys = (np.arange(256) + 0.5) / 256

    def hills(level, amp):
        ridge = level + amp * (_smooth(rng.uniform(-1, 1, 256), 12) * 4)
        mask = (ys[:, None] < ridge[None, :]).astype(np.float32)
        return np.stack([mask] * 4, -1)

    def cloud():
        c = _smooth(rng.uniform(0, 1, (256, 256)), 6).astype(np.float32)
        c = np.clip((c - c.min()) / (c.max() - c.min()), 0, 1)
        return np.stack([c] * 4, -1)

    b = SceneBuilder(texture_size=256, field_texture_size=64)
    b.add_rect((w / 2, h / 2), (w, h), log_density=-2.6)               # night haze
    b.add_point_light((w * 0.82, h * 0.86), radius=5.0, color=(0.75, 0.8, 1.0),
                      intensity=0.9, bounces=2)                          # moon
    b.add_sprite((w / 2, h * 0.16), (w / 2, h * 0.16), color=(0.25, 0.3, 0.2, 1),
                 log_density=-0.15, texture=hills(0.55, 0.35))
    b.add_sprite((w / 2, h * 0.10), (w / 2, h * 0.10), color=(0.15, 0.18, 0.12, 1),
                 log_density=0.0, texture=hills(0.5, 0.45))
    b.add_sprite((w * 0.35, h * 0.55), (w * 0.3, h * 0.12), log_density=-1.0,
                 texture=cloud())
    b.add_sprite((w * 0.7, h * 0.62), (w * 0.25, h * 0.1), log_density=-1.1,
                 texture=cloud())
    b.add_point_light((w * 0.55, h * 0.72), radius=4.0, color=(0.6, 1.0, 0.7),
                      intensity=1.3, bounces=2)                          # UFO body
    b.add_spot_light((w * 0.55, h * 0.70), (w * 0.04, h * 0.015), rotation=0.2,
                     color=(0.7, 1.0, 0.6), intensity=2.2, bounces=2)    # beam
    b.add_rect((w * 0.2, h * 0.35), (w * 0.05, h * 0.02), rotation=0.3,
               color=(0.9, 0.9, 0.95, 1), log_density=0.5, alignment=0.6)
    b.add_ellipse((w * 0.85, h * 0.3), (w * 0.03, h * 0.05),
                  color=(0.8, 0.8, 0.8, 1), log_density=0.5, alignment=1.0)
    b.add_laser_light((w * 0.1, h * 0.9), (3.0, h * 0.2), rotation=-0.6,
                      color=(1.0, 0.2, 0.2), intensity=1.0, bounces=2)
    b.add_ambient_light(color=(0.2, 0.2, 0.35), intensity=0.5, bounces=1)
    b.add_field_light((w * 0.5, h * 0.4), (w * 0.06, h * 0.06), rotation=0.4,
                      intensity=1.2, texture=rng.uniform(0, 1, (64, 64, 4)))
    b.add_directional_light(rotation=0.5, color=(1.0, 0.9, 0.7), intensity=0.6,
                            bounces=2)
    scene = b.build(max_lights=8, max_shapes=8, device="cuda")
    return scene, rasterize(scene, height, width)


def unet_flop(arch: dict, batch: int, height: int, width: int) -> int:
    """Convolution FLOPs (2 per multiply-add) of one pass of the UNet of
    `arch` on (batch, height, width, channels), counted from the layers'
    output shapes on the meta device."""
    with torch.device("meta"):
        net = LitboxDenoiserNet(**arch)
    flop = [0]

    def count(m, _, out):
        if isinstance(m, torch.nn.Conv2d):
            flop[0] += 2 * out.numel() * m.in_channels * m.kernel_size[0] * m.kernel_size[1]

    for m in net.modules():
        m.register_forward_hook(count)
    net(torch.empty((batch, height, width, net.out_channels), device="meta"))
    return flop[0]


def make_pipeline():
    """The pipeline phase's frame function: the realtime profile's sim size
    (480x272, so S=640) with D=128, PipelineConfig's defaults and the mono
    UNet's weights drawn on the card from UNET_SEED. Convolutions and matrix
    products run in full float32 (cuDNN would take TF32 otherwise)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    prof = REALTIME_1080P
    cfg = pipeline.PipelineConfig()
    scene, gb = build_pipeline_scene(prof.sim_width, prof.sim_height)
    brdf = torch.from_numpy(luts.brdf_lut()).cuda()
    fields = rbt.precompute_rotated_fields(gb, n_bins=prof.n_bins)
    torch.manual_seed(UNET_SEED)
    with torch.device("cuda"):
        weights = LitboxDenoiserNet(cfg.unet_size, cfg.initial_features).state_dict()
    frame = pipeline.make_frame_fn(cfg, gb, scene.lights, scene.field_textures,
                                   brdf, fields, model_variables=weights)
    # One frame on its own buffers first: allocations and cuDNN plans.
    frame(rbt.zero_sources(fields), 1.0, torch.Generator(device="cuda").manual_seed(99))
    torch.cuda.synchronize()
    return cfg, scene, gb, fields, weights, frame


def resolve_vs_float64(fields, src, cpu_fields, cpu_src, raw, plain_raw,
                       height: int, width: int) -> dict:
    """Where the card's resolve and the plain resolve part: each against the
    same resolve in float64 (the plain versions on CPU copies; the shear
    coefficients stay float32, as the kernels take them), relative to its
    largest magnitude; and the scan (K1) alone likewise."""
    f64 = rbt.RotatedFields(**{k: v.double() for k, v in vars(cpu_fields).items()})
    src64 = tuple(c.double() for c in cpu_src)
    exact = rbt.resolve_raw(f64, src64, height, width)
    scale = float(exact.abs().max())
    scan64 = attnscan.attenuation_scan_rows_plain(f64.trans, *src64)
    scan_scale = max(float(d.abs().max()) for d in scan64)
    scan_card = [d.cpu() for d in attnscan.attenuation_scan_rows(fields.trans, *src)]
    scan_plain = attnscan.attenuation_scan_rows_plain(cpu_fields.trans, *cpu_src)

    def rel(got, ref, den):
        return max(float((g.double() - r).abs().max()) for g, r in zip(got, ref)) / den

    return dict(kernel=rel([raw], [exact], scale), plain=rel([plain_raw], [exact], scale),
                scan_kernel=rel(scan_card, scan64, scan_scale),
                scan_plain=rel(scan_plain, scan64, scan_scale))


def pipeline_phase(with_f64: bool = False) -> tuple[dict, tuple]:
    """make_frame_fn at the realtime sim size with PipelineConfig's defaults.
    With `with_f64`, the last resolve is also measured against float64 (see
    resolve_vs_float64). Returns the phase's numbers and (fields, sources,
    height, width) of its last frame for the fused-resolve phase."""
    torch.cuda.reset_peak_memory_stats()
    cfg, scene, gb, fields, weights, frame = make_pipeline()
    height, width = gb.height, gb.width

    reset_counts()
    gen = torch.Generator(device="cuda").manual_seed(0)
    src = rbt.zero_sources(fields)
    t0 = time.perf_counter()
    for i in range(FRAMES):
        src, display, hdr = frame(src, float(i + 1), gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()

    # Where a frame's time goes: 3 more frames through the same stages,
    # with CUDA events between them (median per stage), and each stage's
    # peak memory above what was allocated before it.
    stages = frame.stages
    times = {k: [] for k in stages}
    stage_peak = {}
    for i in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
        x = src
        ev[0].record()
        for j, (k, fn) in enumerate(stages.items()):
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            if k == "trace":
                x = src = fn(src, gen)
            elif k == "resolve_hdr":
                x = fn(src, float(FRAMES + i + 1))
            else:
                x = fn(x)
            ev[j + 1].record()
            stage_peak[k] = torch.cuda.max_memory_allocated() - base
        ev[-1].synchronize()
        for j, k in enumerate(stages):
            times[k].append(ev[j].elapsed_time(ev[j + 1]))
    stage_ms = {k: statistics.median(v) for k, v in times.items()}
    # The denoiser with TF32 convolutions, for ROADMAP C1's choice of
    # precision.
    torch.backends.cudnn.allow_tf32 = True
    denoise_tf32_ms = time_ms(lambda: stages["denoise"](hdr), reps=3, warmup=1)
    torch.backends.cudnn.allow_tf32 = False

    failures = []
    if missing := unlaunched(launches, RESOLVE_KERNELS):
        failures.append(f"kernels of the path were not launched: {missing}")
    if display.shape != (height, width, 3) or not bool(torch.isfinite(display).all()):
        failures.append("display is not finite of shape (H, W, 3)")
    elif not (float(display.min()) >= 0 and float(display.max()) <= 1):
        failures.append(f"display outside [0, 1]: [{float(display.min())}, "
                        f"{float(display.max())}]")
    if not bool(torch.isfinite(hdr).all()) or float(hdr.min()) < 0:
        failures.append("HDR is not finite and non-negative")

    # Analytic direct energy against its closed form: each admitted point
    # light deposits energy * W * H / (2 pi) per frame.
    lights = scene.lights
    mask = rbt.analytic_light_mask(lights, -1)
    _, vals = rbt._analytic_point_deposits(lights, mask, fields, float(width * height))
    expect = (lights.energy.double() * mask.double()[:, None]).sum(0) * (
        width * height / (2 * np.pi))
    analytic_rel = float(((vals.double().sum(0) - expect) / expect).abs().max())
    if int(mask.sum()) != 2 or analytic_rel > 1e-4:
        failures.append(f"analytic direct energy off its closed form by "
                        f"{analytic_rel} ({int(mask.sum())} lights)")

    # The last frame's kernel resolve against the plain path on CPU copies
    # of the same fields and sources.
    cpu_fields = rbt.RotatedFields(**{k: v.cpu() for k, v in vars(fields).items()})
    cpu_src = tuple(c.cpu() for c in src)
    plain_raw = rbt.resolve_raw(cpu_fields, cpu_src, height, width)
    raw = rbt.resolve_raw(fields, src, height, width).cpu()
    resolve_err = float((raw - plain_raw).abs().max() / plain_raw.abs().max())
    if resolve_err > RESOLVE_TOL:
        failures.append(f"kernel resolve vs plain: {resolve_err} of max > {RESOLVE_TOL}")
    resolve_f64 = (resolve_vs_float64(fields, src, cpu_fields, cpu_src, raw,
                                      plain_raw, height, width) if with_f64 else None)
    del cpu_fields, cpu_src, plain_raw, raw

    # The card's denoiser against the same weights on the CPU, both float32.
    # Sums of up to 3*3*2048 products in other orders through 27 layers:
    # held to 1e-3 of the output's largest magnitude.
    with torch.device("meta"):
        bare = LitboxDenoiserNet(cfg.unet_size, cfg.initial_features)
    cpu_out = pipeline.denoise_hdr(bare, {k: v.cpu() for k, v in weights.items()},
                                   hdr.cpu(), cfg.transform)
    card_out = stages["denoise"](hdr).cpu()
    denoise_rel = float((card_out - cpu_out).abs().max() / cpu_out.abs().max())
    if not bool(torch.isfinite(card_out).all()) or denoise_rel > 1e-3:
        failures.append(f"card denoise vs CPU: {denoise_rel} of max > 1e-3")
    if failures:
        raise AssertionError("; ".join(failures))
    trace_ms = stage_ms["trace"]
    out = dict(sim_size=[width, height], rot_size=fields.size, n_bins=fields.n_bins,
               n_photons=cfg.n_photons, max_bounces=cfg.max_bounces,
               unet=dict(size=cfg.unet_size, features=cfg.initial_features,
                         seed=UNET_SEED),
               frames=FRAMES, ms_per_frame=(t1 - t0) / FRAMES * 1e3,
               stage_ms=stage_ms, stage_peak_extra_bytes=stage_peak,
               denoise_ms_tf32=denoise_tf32_ms,
               unet_flop=unet_flop(dict(unet_size=cfg.unet_size,
                                        initial_features=cfg.initial_features),
                                   3, -(-height // 32) * 32, -(-width // 32) * 32),
               photons_per_s_trace=cfg.n_photons / (trace_ms * 1e-3),
               photons_per_s_frame=cfg.n_photons * FRAMES / (t1 - t0),
               peak_memory_bytes=peak, launches=launches,
               cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
               matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
               analytic_energy_rel_err=analytic_rel,
               resolve_vs_plain_rel_err=resolve_err, resolve_tol=RESOLVE_TOL,
               resolve_vs_float64=resolve_f64,
               denoise_vs_cpu_rel_err=denoise_rel,
               denoise_tol=1e-3, display_mean=float(display.mean()),
               hdr_mean=float(hdr.mean()))
    return out, (fields, src, height, width)


def fused_resolve_phase(fields, src, height: int, width: int) -> dict:
    """runs/prof_resolve6.py:60-79 on the card: the sources resolved through
    the scan and K4 (then cropped) and through resolve_raw's quadrant-run
    pipeline, with all bins and with 1/n_groups of them, both timed, held
    together as tests/test_pallas_ops.py:113-131 holds them."""
    d, s = fields.n_bins, fields.size
    oy, ox = (s - height) // 2, (s - width) // 2

    def fused(n_groups):
        dep = attnscan.attenuation_scan_rows(fields.trans, *src, group=0,
                                             n_groups=n_groups)
        base = tuple(-i * 2.0 * np.pi / d for i in range(0, d, n_groups))
        out = rotate.rotate_planar_sum_fused(dep, base, 0.0)
        return out[:, oy:oy + height, ox:ox + width].movedim(0, -1)

    def quadrant(n_groups):
        return rbt.resolve_raw(fields, src, height, width, group=0, n_groups=n_groups)

    reset_counts()
    results = {}
    for n_groups in (1, 4):
        a, b = fused(n_groups), quadrant(n_groups)
        results[n_groups] = dict(
            mass_rel=float(abs(a.double().sum() / b.double().sum() - 1)),
            mean_abs_diff_rel=float((a - b).abs().mean() / b.abs().mean()))
    torch.cuda.synchronize()
    launches = read_counts()
    failures = [f"kernels of the path were not launched: {m}"
                for m in [unlaunched(launches, FUSED_KERNELS)] if m]
    for n_groups, r in results.items():
        if r["mass_rel"] > 1e-3 or r["mean_abs_diff_rel"] > 0.02:
            failures.append(f"fused vs quadrant resolve at 1/{n_groups}: {r}")
    if failures:
        raise AssertionError("; ".join(failures))
    for n_groups, r in results.items():
        r.update(fused_ms=time_ms(lambda: fused(n_groups)),
                 quadrant_ms=time_ms(lambda: quadrant(n_groups)))
    return dict(launches=launches, mass_tol=1e-3, mean_abs_diff_tol=0.02,
                all_bins=results[1], quarter_bins=results[4])


PROD_FRAMES = 32       # timed frames of the shipped frame, after 1 warm frame
PROD_STAGE_FRAMES = 16  # frames with CUDA events between the stages
PROD_F32_FRAMES = 8    # frames beside a float32 display of the same frames
PROD_SYNC_FRAMES = 8   # frames under torch's sync debug mode
# The bf16 display's largest and mean deviation from a float32 display of
# the same frame, on the [0, 1] display scale. The JAX package's own bf16
# display lies up to 0.027 (mean 3.4e-4) from its float32 display on
# test_torch_realtime.py's frames; held here at a little over twice that.
BF16_DISPLAY_TOL = dict(max=0.0625, mean=1e-3)
PROD_STAGES = ("deposits", "flush", "resolve", "display_cal", "display_fast",
               "upsample_tonemap")


def _clone_state(state: realtime.PairFrameState) -> realtime.PairFrameState:
    return realtime.PairFrameState(
        src2=tuple(c.clone() for c in state.src2), cache=state.cache.clone(),
        pend_flat=state.pend_flat.clone(), pend_vals=state.pend_vals.clone(),
        k_prev=state.k_prev.clone(), r=state.r.clone(), frame=state.frame)


def make_production():
    """The shipped frame on REALTIME_1080P and bench_1080p.py's scene, with
    the shipped net's shape and weights drawn on the card from UNET_SEED.
    Returns (scene, gbuffer, fields, float32 weights, make) where
    make(weights) builds (init_state, step) with those weights."""
    prof = REALTIME_1080P
    scene, gb = build_scene(prof.sim_width, prof.sim_height, tex=256)
    brdf = torch.from_numpy(luts.brdf_lut()).cuda()
    fields = rbt.precompute_rotated_fields(gb, n_bins=prof.n_bins)
    torch.manual_seed(UNET_SEED)
    with torch.device("cuda"):
        weights32 = LitboxDenoiserNet(**realtime.SHIPPED_NET).state_dict()
    make = lambda w: realtime.make_pair_frame_step(
        gb, scene.lights, scene.field_textures, brdf, fields, w, prof=prof)
    return scene, gb, fields, weights32, make


def production_phase() -> dict:
    """engine.realtime's frame on REALTIME_1080P, as runs/bench_1080p.py
    --pair-fast drives it (:415-438): 1 warm frame, then PROD_FRAMES frames
    with the launch counts read around them."""
    prof = REALTIME_1080P
    torch.cuda.reset_peak_memory_stats()
    scene, gb, fields, weights32, make = make_production()
    height, width = gb.height, gb.width
    init_state, step = make(realtime.display_weights(weights32, prof))
    state = init_state()
    gen = torch.Generator(device="cuda").manual_seed(7)
    step(state, gen)
    torch.cuda.synchronize()
    setup_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    t0 = time.perf_counter()
    for _ in range(PROD_FRAMES):
        pix, k = step(state, gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    display_range = (float(pix.min()), float(pix.max()))
    k_last = float(k)

    # Host synchronisations over PROD_SYNC_FRAMES frames (a flush and a
    # calibration display among them).
    syncs = host_syncs(lambda: [step(state, gen) for _ in range(PROD_SYNC_FRAMES)])

    # Stage times: CUDA events at the step's stage marks.
    stage_ms = {name: [] for name in PROD_STAGES}
    for _ in range(PROD_STAGE_FRAMES):
        events = [("start", torch.cuda.Event(enable_timing=True))]
        events[0][1].record()

        def mark(name, events=events):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((name, ev))

        step(state, gen, mark)
        events[-1][1].synchronize()
        for (_, a), (name, b) in zip(events, events[1:]):
            stage_ms[name].append(a.elapsed_time(b))
    stage_median = {k: statistics.median(v) for k, v in stage_ms.items() if v}
    stage_median["flush_amortized"] = sum(stage_ms["flush"]) / PROD_STAGE_FRAMES

    # The bf16 display against a float32 display of the same frames: both
    # steps from one state, with the same generator state each frame.
    _, step32 = make(weights32)
    state32 = _clone_state(state)
    dev_max, dev_mean = [], []
    for _ in range(PROD_F32_FRAMES):
        rng = gen.get_state()
        pix16, _ = step(state, gen)
        gen.set_state(rng)
        pix32, _ = step32(state32, gen)
        diff = (pix16.float() - pix32).abs()
        dev_max.append(float(diff.max()))
        dev_mean.append(float(diff.mean()))
    del state32

    # resolve_raw against K1 + K4 at the group shape (one tracer, one group).
    d, s_rot, groups = fields.n_bins, fields.size, prof.resolve_groups
    oy, ox = (s_rot - height) // 2, (s_rot - width) // 2
    tracer, group = 1, 3 % groups
    base = tuple(-i * 2.0 * np.pi / d for i in range(group, d, groups))

    def fused():
        dep = attnscan.attenuation_scan_rows(fields.trans, *state.src2, group=group,
                                             n_groups=groups, src_offset=tracer * d)
        out = rotate.rotate_planar_sum_fused(dep, base, 0.0)
        return out[:, oy:oy + height, ox:ox + width].movedim(0, -1)

    def quadrant():
        return rbt.resolve_raw(fields, state.src2, height, width, group=group,
                               n_groups=groups, tracer=tracer)

    a, b = fused(), quadrant()
    group_resolve = dict(
        shape=f"3x({d // groups},{s_rot},{s_rot}) tracer {tracer} group {group}/{groups}",
        resolve_raw_ms=time_ms(quadrant), fused_ms=time_ms(fused),
        mass_rel=float(abs(a.double().sum() / b.double().sum() - 1)),
        mean_abs_diff_rel=float((a - b).abs().mean() / b.abs().mean()))

    failures = []
    if missing := unlaunched(launches, RESOLVE_KERNELS):
        failures.append(f"kernels of the path were not launched: {missing}")
    frames = state.frame
    iters = float(frames)
    hdr = [to_hdr(state.cache[t].sum(0), iters, gb) for t in (0, 1)]
    if not all(bool(torch.isfinite(x).all()) and float(x.min()) >= 0 for x in hdr):
        failures.append("HDR is not finite and non-negative")
    if pix.shape != (prof.out_height, prof.out_width, 3) or not (
            display_range[0] >= 0 and display_range[1] <= 1):
        failures.append(f"display {tuple(pix.shape)} outside [0, 1]: {display_range}")
    if not 0 <= k_last <= 1:
        failures.append(f"k {k_last} outside [0, 1]")
    energy = [sum(float(c[t * d:(t + 1) * d].double().sum()) for c in state.src2)
              for t in (0, 1)]
    energy_rel = abs(energy[0] - energy[1]) / (0.5 * (energy[0] + energy[1]))
    blocks_differ = float((state.src2[0][:d] - state.src2[0][d:]).abs().max()) > 0
    if not blocks_differ or energy_rel > 0.05:
        failures.append(f"tracer blocks: differ {blocks_differ}, energies {energy}")
    partition = []
    for t in (0, 1):
        full = rbt.resolve_raw(fields, state.src2, height, width, tracer=t)
        parts = sum(rbt.resolve_raw(fields, state.src2, height, width, group=g,
                                    n_groups=groups, tracer=t) for g in range(groups))
        partition.append(float((parts - full).abs().max() / full.abs().max()))
    if max(partition) > 1e-4:
        failures.append(f"group resolves vs full resolve: {partition} of max > 1e-4")
    if syncs:
        failures.append(f"the frame made the host wait for the card at {sorted(set(syncs))}")
    bf16_dev = dict(max=max(dev_max), mean=statistics.mean(dev_mean))
    if any(not bf16_dev[k] <= BF16_DISPLAY_TOL[k] for k in bf16_dev):
        failures.append(f"bf16 display vs float32: {bf16_dev} beyond {BF16_DISPLAY_TOL}")
    if failures:
        raise AssertionError("; ".join(failures))
    per_frame = prof.photons + prof.bounce_photons
    padded = (-(-height // 32) * 32, -(-width // 32) * 32)
    return dict(
        sim_size=[width, height], out_size=[prof.out_width, prof.out_height],
        rot_size=s_rot, n_bins=d, photons=prof.photons, bounce_photons=prof.bounce_photons,
        resolve_groups=groups, flush_k=realtime.FLUSH_K, cal=realtime.CAL,
        net=dict(realtime.SHIPPED_NET, seed=UNET_SEED, dtype="bfloat16"),
        frames=PROD_FRAMES, ms_per_frame=(t1 - t0) / PROD_FRAMES * 1e3,
        photons_per_s=per_frame * PROD_FRAMES / (t1 - t0),
        stage_ms=stage_median, stage_frames=PROD_STAGE_FRAMES,
        peak_memory_bytes=peak, setup_peak_memory_bytes=setup_peak,
        deposit_stream_m=int(state.pend_flat.shape[1]),
        launches=launches, group_resolve=group_resolve,
        host_syncs=dict(frames=PROD_SYNC_FRAMES, count=len(syncs),
                        sites=sorted(set(syncs))),
        display_flop=dict(single=unet_flop(realtime.SHIPPED_NET, 1, *padded),
                          calibration=unet_flop(realtime.SHIPPED_NET, 2, *padded)),
        bf16_vs_f32_display=dict(frames=PROD_F32_FRAMES, tol=BF16_DISPLAY_TOL, **bf16_dev),
        display_range=display_range, k=k_last, tracer_energy=energy,
        tracer_energy_rel=energy_rel, group_partition_rel=partition,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)


# The README's quickstart (README.md:133-141) at full size.
SIM_SIZE = 256
SIM_RAYS = 65536
SIM_FRAMES = 32
SIM_MEASURE = 8
SIM_SYNC_STEPS = 9     # steps under torch's sync debug mode (measures at 1 and 8)
SIM_SHORT_STEPS = 8    # steps of the collimated run
SIM_REALTIME_STEPS = 16
SIM_AI_STEPS = 4
SIM_ORACLE_FRAMES = 2
# collimated_direct_raw against the same composition through the plain
# versions, relative to its maximum: float32 roundings of one scan and three
# shears.
COLLIMATED_TOL = 1e-5
# The README scene's options (README.md:138) and the AIAccelerator's mono
# defaults (litbox_tpu/engine/pipeline.py:110-111).
README_SIM = dict(width=SIM_SIZE, height=SIM_SIZE, mode=Mode.REFERENCE,
                  convergence_threshold=1e-4, rays_per_frame=SIM_RAYS,
                  frame_limit=SIM_FRAMES, measurement_interval=SIM_MEASURE)
AI_NET = dict(unet_size=5, initial_features=32)


def readme_scene(point: bool = True, collimated: bool = False, device: str = "cuda"):
    """The README's scene (a point light and an ellipse), with a laser and a
    directional light added when `collimated`; without `point`, only those
    (vacuum)."""
    b = SceneBuilder()
    if point:
        b.add_point_light((128, 140), radius=4, color=(1, .85, .6), intensity=2, bounces=3)
        b.add_ellipse((160, 115), (40, 25), rotation=0.5, color=(.5, .6, 1, 1),
                      log_density=-1.1)
    if collimated:
        b.add_laser_light((30, 60), (6, 1), rotation=2.2, color=(1.0, 0.3, 0.2),
                          intensity=1.5, bounces=2)
        b.add_directional_light(rotation=0.4, color=(0.7, 0.8, 1.0), intensity=0.5,
                                bounces=2)
    return b.build(device=device)


@contextlib.contextmanager
def plain_kernels():
    """Swap K1-K3's wrappers for their plain versions where the port's
    modules call them, so a composition runs in plain PyTorch on the card
    (and counts no launch)."""
    swaps = [(rbt, "attenuation_scan_rows", attnscan.attenuation_scan_rows_plain),
             (rotate, "shear", rotate.shear_plain),
             (rotate, "shear_reduce", rotate.shear_reduce_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def flax_tree(arch: dict, seed: int) -> dict:
    """A Flax-layout variable tree ({"params", "batch_stats"}) of the JAX
    package's UNet of `arch`, each leaf drawn with numpy from `seed` (conv
    kernels N(0, 1/fan_in), BatchNorm scale and var in [0.5, 1.5), biases
    and means in [-0.2, 0.2)): the layout convert.unet_from_flax reads,
    built from the port's module names without JAX."""
    with torch.device("meta"):
        state = LitboxDenoiserNet(**arch).state_dict()
    rng = np.random.default_rng(seed)
    tree = {"params": {}, "batch_stats": {}}
    for key, ref in state.items():
        *mods, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        path = ["Conv_0" if m == "conv" else m for m in mods]
        shape = tuple(ref.shape)
        if leaf == "weight" and len(shape) == 4:
            name, shape = "kernel", (shape[2], shape[3], shape[1], shape[0])
            value = rng.normal(0, np.prod(shape[:-1]) ** -0.5, shape)
        elif leaf in ("weight", "running_var"):
            name = "scale" if leaf == "weight" else "var"
            value = rng.uniform(0.5, 1.5, shape)
        else:
            name = {"bias": "bias", "running_mean": "mean"}[leaf]
            value = rng.uniform(-0.2, 0.2, shape)
        node = tree["batch_stats" if leaf.startswith("running") else "params"]
        for m in path:
            node = node.setdefault(m, {})
        node[name] = value.astype(np.float32)
    return tree


def _timed_steps(sim, n: int) -> tuple[float, float]:
    """(ms of the first step, ms per step of the next n - 1), host clock,
    each span ended by a synchronize; photons/s from the simulation's own
    counters over the later steps."""
    t0 = time.perf_counter()
    sim.step()
    torch.cuda.synchronize()
    sim.update_performance_metrics()
    t1 = time.perf_counter()
    for _ in range(n - 1):
        sim.step()
    torch.cuda.synchronize()
    sim.update_performance_metrics()
    t2 = time.perf_counter()
    return (t1 - t0) * 1e3, (t2 - t1) / max(1, n - 1) * 1e3


def _read_ms(fn):
    """(value, ms) of fn() on the host clock, ended by a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    value = fn()
    torch.cuda.synchronize()
    return value, (time.perf_counter() - t0) * 1e3


def _hdr_ok(name: str, hdr, failures: list, shape=(SIM_SIZE, SIM_SIZE, 3)) -> None:
    if tuple(hdr.shape) != shape or not bool(torch.isfinite(hdr).all()):
        failures.append(f"{name}: HDR is not finite of shape {shape}")
    elif float(hdr.min()) < 0:
        failures.append(f"{name}: HDR has negative values (min {float(hdr.min())})")


def _sync_record(first: list, later: list) -> dict:
    """Host syncs of a run's first step (the per-scene reads) and of the
    steps after it, with each site."""
    return dict(first_step=len(first), later_steps=SIM_SYNC_STEPS - 1,
                later_count=len(later), later_per_step=len(later) / (SIM_SYNC_STEPS - 1),
                first_sites=sorted(set(first)), later_sites=sorted(set(later)))


def _reference_run(engine: str, scene, failures: list) -> dict:
    """The README quickstart with `engine`: SIM_FRAMES steps, the first
    output read, counts and memory; then SIM_SYNC_STEPS steps of a second
    run under torch's sync debug mode."""
    torch.cuda.reset_peak_memory_stats()
    sim = Simulation(engine=engine, **README_SIM)
    sim.set_scene(scene)
    reset_counts()
    first_ms, ms_per_step = _timed_steps(sim, SIM_FRAMES)
    hdr, read_ms = _read_ms(lambda: sim.simulation_output_hdr)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    _hdr_ok(engine, hdr, failures)
    counts = [t.forward_photon_count for t in sim._tracers]
    if counts != [SIM_FRAMES * SIM_RAYS] * 2:
        failures.append(f"{engine}: photon counts {counts}, not {SIM_FRAMES} x {SIM_RAYS}")
    a, b = sim.tracer_a.tracer_output, sim.tracer_b.tracer_output
    energy = [float(a.double().sum()), float(b.double().sum())]
    energy_rel = abs(energy[0] - energy[1]) / (0.5 * sum(energy))
    differ = float((a - b).abs().max()) > 0
    if engine == "rbt-paired" and (not differ or energy_rel > 0.05):
        failures.append(f"{engine}: tracers differ {differ}, energies {energy}")
    sync_sim = Simulation(engine=engine, seed=1, **README_SIM)
    sync_sim.set_scene(scene)
    first = host_syncs(sync_sim.step)
    later = host_syncs(lambda: [sync_sim.step() for _ in range(SIM_SYNC_STEPS - 1)])
    return dict(engine=engine, steps=sim.iterations_since_clear,
                first_step_ms=first_ms, ms_per_step=ms_per_step,
                photons_per_second=sim.photons_per_second,
                first_output_read_ms=read_ms,
                convergence_progress=sim.convergence_progress,
                photon_counts=counts, tracer_energy=energy, tracer_energy_rel=energy_rel,
                tracers_differ=differ, hdr_mean=float(hdr.mean()),
                host_syncs=_sync_record(first, later),
                peak_memory_bytes=peak, launches=launches)


def _collimated_run(failures: list) -> dict:
    """The README scene with a laser and a directional light, exact
    collimated fields on: the per-scene precompute, collimated_direct_raw
    against its plain composition on the card, the vacuum check, then
    SIM_SHORT_STEPS steps and the output."""
    scene = readme_scene(collimated=True)
    gb = rasterize(scene, SIM_SIZE, SIM_SIZE)
    lights = scene.lights
    collimated_direct_raw = lambda: rbt.collimated_direct_raw(gb, lights, SIM_SIZE, SIM_SIZE)
    collimated_direct_raw()  # first call: allocations at S=384 and S=1024
    exact, precompute_ms = _read_ms(collimated_direct_raw)
    with plain_kernels():
        plain = collimated_direct_raw()
    err = float((exact - plain).abs().max())
    rel = err / float(plain.abs().max())
    if not bool(torch.isfinite(exact).all()) or rel > COLLIMATED_TOL:
        failures.append(f"collimated_direct_raw vs plain: {rel} of max > {COLLIMATED_TOL}")
    vacuum = readme_scene(point=False, collimated=True)
    vgb = rasterize(vacuum, SIM_SIZE, SIM_SIZE)
    vraw = rbt.collimated_direct_raw(vgb, vacuum.lights, SIM_SIZE, SIM_SIZE)
    vacuum_hdr = float(to_hdr(vraw, 1.0, vgb).abs().max())
    if not float(vraw.abs().sum()) > 0 or vacuum_hdr >= 1e-4:
        failures.append(f"vacuum: beam energy {float(vraw.abs().sum())}, HDR max {vacuum_hdr}")

    sim = Simulation(**dict(README_SIM, frame_limit=SIM_SHORT_STEPS))
    sim.set_scene(scene)
    reset_counts()
    first_ms, ms_per_step = _timed_steps(sim, SIM_SHORT_STEPS)
    hdr, read_ms = _read_ms(lambda: sim.simulation_output_hdr)
    launches = read_counts()
    _hdr_ok("collimated", hdr, failures)
    if sim.tracer_a.forward._exact_raw is None:
        failures.append("collimated: no exact field was added")
    return dict(precompute_ms=precompute_ms, vs_plain_max_abs_err=err,
                vs_plain_rel_err=rel, tol=COLLIMATED_TOL, vacuum_hdr_max=vacuum_hdr,
                steps=sim.iterations_since_clear, first_step_ms=first_ms,
                ms_per_step=ms_per_step, first_output_read_ms=read_ms,
                exact_energy=float(exact.double().sum()), hdr_mean=float(hdr.mean()),
                launches=launches)


def _realtime_run(scene, failures: list) -> dict:
    """Mode.REALTIME with the jitter ladder and 16 display groups: a
    display_hdr read after each of SIM_REALTIME_STEPS steps."""
    sim = Simulation(width=SIM_SIZE, height=SIM_SIZE, mode=Mode.REALTIME,
                     rays_per_frame=SIM_RAYS)
    sim.set_scene(scene)
    sim._validate_tracers()
    for t in sim._tracers:
        t.forward.jitter_bins = True
        t.forward.resolve_groups = 16
    first = host_syncs(lambda: (sim.step(), sim.display_hdr))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(SIM_REALTIME_STEPS):
        sim.step()
        hdr = sim.display_hdr
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / SIM_REALTIME_STEPS * 1e3
    launches = read_counts()
    later = host_syncs(lambda: [(sim.step(), sim.display_hdr)
                                for _ in range(SIM_SYNC_STEPS - 1)])
    _hdr_ok("realtime", hdr, failures)
    return dict(steps=SIM_REALTIME_STEPS, ms_per_step_with_display=ms,
                hdr_mean=float(hdr.mean()), host_syncs=_sync_record(first, later),
                launches=launches)


def _ai_run(scene, failures: list) -> dict:
    """AIAccelerator(blend="auto") with the mono defaults and float32
    weights from UNET_SEED carried by convert.unet_from_flax, over
    SIM_AI_STEPS reference steps; each on_step timed on the host clock."""
    sim = Simulation(**dict(README_SIM, frame_limit=SIM_AI_STEPS))
    sim.set_scene(scene)
    weights = convert.unet_from_flax(flax_tree(AI_NET, UNET_SEED), **AI_NET)
    acc = pipeline.AIAccelerator(sim, weights, blend="auto", **AI_NET)
    times = []

    def timed(iteration):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc._on_step(iteration)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)

    sim.on_step[sim.on_step.index(acc._on_step)] = timed
    reset_counts()
    while sim.is_running:
        sim.step()
    launches = read_counts()
    # The net's weights are random, so its output may be negative: the
    # simulation's HDR is held non-negative, the denoised one finite.
    _hdr_ok("ai", sim.simulation_output_hdr, failures)
    if not bool(torch.isfinite(acc.hdr_output).all()):
        failures.append("ai: the denoised HDR is not finite")
    k = float(acc.last_blend)
    tm = acc.tonemapped_output
    if not 0 <= k <= 1 or not (0 <= float(tm.min()) and float(tm.max()) <= 1):
        failures.append(f"ai: k {k}, tone map in [{float(tm.min())}, {float(tm.max())}]")
    return dict(net=dict(AI_NET, seed=UNET_SEED, dtype="float32", blend="auto"),
                steps=len(times), ms_per_on_step=times, k=k,
                cudnn_allow_tf32=torch.backends.cudnn.allow_tf32, launches=launches)


def _oracle_run(scene, failures: list) -> dict:
    """engine="oracle" (the plain PyTorch march) at 256^2 for
    SIM_ORACLE_FRAMES frames."""
    sim = Simulation(**dict(README_SIM, engine="oracle", frame_limit=SIM_ORACLE_FRAMES,
                            measurement_interval=0))
    sim.set_scene(scene)
    first_ms, ms_per_step = _timed_steps(sim, SIM_ORACLE_FRAMES)
    hdr, read_ms = _read_ms(lambda: sim.simulation_output_hdr)
    _hdr_ok("oracle", hdr, failures)
    counts = [t.forward_photon_count for t in sim._tracers]
    writes = [t.forward_write_count for t in sim._tracers]
    if counts != [SIM_ORACLE_FRAMES * SIM_RAYS] * 2 or min(writes) <= 0:
        failures.append(f"oracle: photon counts {counts}, writes {writes}")
    return dict(frames=SIM_ORACLE_FRAMES, first_frame_ms=first_ms,
                ms_per_frame=(first_ms + ms_per_step * (SIM_ORACLE_FRAMES - 1))
                / SIM_ORACLE_FRAMES, photon_counts=counts, write_counts=writes,
                hdr_mean=float(hdr.mean()))


def simulation_phase() -> dict:
    """engine.Simulation, the README's entry point, at 256^2 in six
    configurations (reference, paired, collimated, realtime, ai, oracle),
    with the launches of each; K1-K3 must be launched by reference and by
    collimated. Last, a Simulation on the card must refuse a CPU scene."""
    failures = []
    scene = readme_scene()
    runs = {"reference": _reference_run("rbt", scene, failures),
            "paired": _reference_run("rbt-paired", scene, failures),
            "collimated": _collimated_run(failures),
            "realtime": _realtime_run(scene, failures),
            "ai": _ai_run(scene, failures),
            "oracle": _oracle_run(scene, failures)}
    for name in ("reference", "collimated"):
        if missing := unlaunched(runs[name]["launches"], RESOLVE_KERNELS):
            failures.append(f"{name}: kernels of the path were not launched: {missing}")
    refused = Simulation()
    try:
        refused.set_scene(readme_scene(device="cpu"))
        failures.append("a Simulation on the card took a CPU scene")
    except ValueError:
        pass
    if refused._scene is not None or refused._tracers is not None:
        failures.append("the refused Simulation kept the CPU scene")
    if failures:
        raise AssertionError("; ".join(failures))
    launches = {name: sum(r["launches"][name] for r in runs.values() if "launches" in r)
                for name in COUNTERS}
    return dict(size=SIM_SIZE, rays_per_frame=SIM_RAYS, launches=launches, **runs)


# The hybrid strategy and the cascade: the README quickstart with
# Strategy.HYBRID, the realtime profile's sim size, the faithful march and
# the deterministic multi-bounce cascade.
HYB_STEPS = 32
HYB_REALTIME_STEPS = 16
HYB_ORACLE_FRAMES = 2
HYB_DOM_STEPS = 16
HYB_DOM_REFRESH = 8
HYB_DOM_BOUNCES = 3  # two cascade waves
# backward_gather_rbt on the card against the same call on CPU copies,
# relative to its maximum: float32 products summed in other orders.
GATHER_TOL = 1e-4
# The cascade against its composition through the plain K1-K3 on the card,
# relative to its maximum (float32 roundings of one composition), and the
# linearity check.
DOM_TOL = 1e-5
# DOM's accumulated output against the Monte-Carlo bounce chains' in mass.
DOM_MC_MASS = 0.05


def cloudy_scene(w: int, h: int, bounces: int = 2):
    """runs/prof_backward_r5.py's scene (build, :40-55): a point light in a
    cloudy sprite (a normal-free medium) from a smoothed random texture of
    seed 0, the light's bounce count `bounces` (the script's 2 by
    default)."""
    rng = np.random.default_rng(0)
    cloud = rng.uniform(0.0, 1.0, (256, 256)).astype(np.float32)
    for _ in range(3):
        cloud = (np.roll(cloud, 1, 0) + np.roll(cloud, -1, 0)
                 + np.roll(cloud, 1, 1) + np.roll(cloud, -1, 1) + cloud) / 5.0
    b = SceneBuilder(texture_size=256)
    b.add_point_light((w * 0.5, h * 0.55), radius=4.0, color=(1.0, 0.85, 0.6),
                      intensity=2.0, bounces=bounces)
    b.add_sprite((w / 2, h / 2), (w / 2, h / 2), color=(1, 1, 1, 1), log_density=-1.0,
                 texture=np.stack([cloud] * 3 + [cloud], -1))
    return b.build(max_lights=2, max_shapes=2, device="cuda")


@contextlib.contextmanager
def counting_resolves(counter: dict):
    """Count the tracers' full forward resolves (resolve_raw calls)."""
    real = tracers.resolve_raw

    def counted(*args, **kwargs):
        counter["n"] += 1
        return real(*args, **kwargs)

    tracers.resolve_raw = counted
    try:
        yield
    finally:
        tracers.resolve_raw = real


def _on_card(name: str, t, failures: list) -> None:
    """The CPU-side check that a phase did not fall back to the CPU."""
    if t.device.type != "cuda":
        failures.append(f"{name}: the output lies on {t.device}, not the card")


def _hybrid_reference(scene, failures: list) -> dict:
    """The README quickstart with Strategy.HYBRID on 'rbt' in REFERENCE
    (forward refresh 1): HYB_STEPS steps, the first output read, peak
    memory; then SIM_SYNC_STEPS steps of a second run under torch's sync
    debug mode, gated at the forward-only reference's 3 + 1."""
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    sim = Simulation(strategy=Strategy.HYBRID, **dict(README_SIM, frame_limit=HYB_STEPS))
    sim.set_scene(scene)
    reset_counts()
    first_ms, ms_per_step = _timed_steps(sim, HYB_STEPS)
    hdr, read_ms = _read_ms(lambda: sim.simulation_output_hdr)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    _hdr_ok("hybrid reference", hdr, failures)
    _on_card("hybrid reference", hdr, failures)
    frames = [t.backward.frame_count for t in sim._tracers]
    if frames != [HYB_STEPS] * 2:
        failures.append(f"hybrid reference: backward frame counts {frames}, not {HYB_STEPS}")
    if any(t.forward_refresh_interval != 1 for t in sim._tracers):
        failures.append("hybrid reference: the forward refresh is not 1")
    sync_sim = Simulation(strategy=Strategy.HYBRID, seed=1, **README_SIM)
    sync_sim.set_scene(scene)
    first = host_syncs(sync_sim.step)
    later = host_syncs(lambda: [sync_sim.step() for _ in range(SIM_SYNC_STEPS - 1)])
    if len(first) > 3 or len(later) > 1:
        failures.append(f"hybrid reference: {len(first)} host syncs at the first step and "
                        f"{len(later)} after, over the forward-only 3 + 1")
    return dict(steps=sim.iterations_since_clear, first_step_ms=first_ms,
                ms_per_step=ms_per_step, first_output_read_ms=read_ms,
                backward_frames=frames, hdr_mean=float(hdr.mean()),
                host_syncs=_sync_record(first, later), peak_memory_bytes=peak,
                allocated_before_bytes=before, launches=launches)


def _gather_rbt_record(sim, failures: list) -> dict:
    """backward_gather_rbt at the realtime size on the last frame's fields and
    forward HDR: device ms (CUDA events, median of 7), its bound, the pair
    tensor's bytes, peak memory, and the card's result against the same call
    on CPU copies."""
    t = sim.tracer_a
    fields, gb, hdr = t.backward.rbt_fields, t.gbuffer, t._cached_forward_hdr
    s, d = fields.size, fields.n_bins
    b = backward_bin_for_frame(5, d)
    run = lambda: backward_gather_rbt(fields, gb, hdr, b)
    got = run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = time_ms(run)
    peak = torch.cuda.max_memory_allocated() - base
    cpu = lambda x: {k: v.cpu() for k, v in vars(x).items()}
    ref = backward_gather_rbt(type(fields)(**cpu(fields)), type(gb)(**cpu(gb)), hdr.cpu(), b)
    err = float((got.cpu() - ref).abs().max())
    rel = err / float(ref.abs().max())
    if not bool(torch.isfinite(got).all()) or rel > GATHER_TOL:
        failures.append(f"backward_gather_rbt card vs CPU: {rel} of max > {GATHER_TOL}")
    _on_card("backward_gather_rbt", got, failures)
    block, nb = 128, s // 128
    h, w = gb.height, gb.width
    # Least work: read the bin's C row field, the forward HDR, albedo and
    # transmissibility once, write the output once; within-block pairs
    # (an exp and 6 flops a pair and channel), then one (S, 128) x (128, 3S)
    # product a later block.
    n_bytes = 4 * (s * s + h * w * (3 + 4 + 1 + 3))
    n_ops = s * nb * block * block * (1 + 2 * 3) + (nb - 1) * s * block * 3 * s * 2
    bnd, by = bound(n_bytes, n_ops)
    return dict(shape=f"S={s} block {block} frame {h}x{w}", ms=ms, bound_ms=bnd,
                bound_by=by, pair_tensor_bytes=4 * s * nb * block * block,
                pair_tensor_ms_at_hbm=2 * 4 * s * nb * block * block / HBM_BYTES_PER_S * 1e3,
                peak_extra_bytes=peak, vs_cpu_max_abs_err=err, vs_cpu_rel_err=rel,
                tol=GATHER_TOL)


def _hybrid_realtime(failures: list) -> dict:
    """REALTIME_1080P's sim size (480x272, S=640, D=128) on the cloudy scene
    with Strategy.HYBRID in Mode.REALTIME (forward refresh 4):
    HYB_REALTIME_STEPS steps, the count of full forward resolves, and
    backward_gather_rbt at this shape."""
    w, h = REALTIME_1080P.sim_width, REALTIME_1080P.sim_height
    scene = cloudy_scene(w, h)
    sim = Simulation(width=w, height=h, strategy=Strategy.HYBRID, mode=Mode.REALTIME,
                     rays_per_frame=SIM_RAYS)
    sim.set_scene(scene)
    sim.step()
    torch.cuda.synchronize()
    reset_counts()
    resolves = {"n": 0}
    with counting_resolves(resolves):
        t0 = time.perf_counter()
        for _ in range(HYB_REALTIME_STEPS):
            sim.step()
        hdr = sim.display_hdr
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / HYB_REALTIME_STEPS * 1e3
    launches = read_counts()
    _hdr_ok("hybrid realtime", hdr, failures, shape=(h, w, 3))
    _on_card("hybrid realtime", hdr, failures)
    refresh = [t.forward_refresh_interval for t in sim._tracers]
    if refresh != [4, 4]:
        failures.append(f"hybrid realtime: forward refresh {refresh}, not 4")
    # Simulation clears every tracer at each REALTIME step (Simulation.cs:370),
    # so each step's backward frame is its first and resolves the forward HDR:
    # the JAX package's schedule, two resolves a step.
    if resolves["n"] != 2 * HYB_REALTIME_STEPS:
        failures.append(f"hybrid realtime: {resolves['n']} forward resolves, "
                        f"not {2 * HYB_REALTIME_STEPS}")
    if missing := unlaunched(launches, RESOLVE_KERNELS):
        failures.append(f"hybrid realtime: kernels of the path were not launched: {missing}")
    return dict(size=f"{w}x{h}", steps=HYB_REALTIME_STEPS, ms_per_step=ms,
                forward_resolves=resolves["n"], forward_refresh=refresh,
                hdr_mean=float(hdr.mean()), launches=launches,
                backward_gather_rbt=_gather_rbt_record(sim, failures))


def _hybrid_oracle(scene, failures: list) -> dict:
    """engine='oracle' with Strategy.HYBRID: the plain march forward and the
    faithful backward march, HYB_ORACLE_FRAMES frames at 256^2."""
    sim = Simulation(strategy=Strategy.HYBRID, **dict(
        README_SIM, engine="oracle", frame_limit=HYB_ORACLE_FRAMES, measurement_interval=0))
    sim.set_scene(scene)
    first_ms, ms_per_step = _timed_steps(sim, HYB_ORACLE_FRAMES)
    hdr = sim.simulation_output_hdr
    _hdr_ok("hybrid oracle", hdr, failures)
    _on_card("hybrid oracle", hdr, failures)
    if any(t.backward.rbt_fields is not None for t in sim._tracers):
        failures.append("hybrid oracle: the backward gather took RBT fields")
    if [t.backward.frame_count for t in sim._tracers] != [HYB_ORACLE_FRAMES] * 2:
        failures.append("hybrid oracle: backward frame counts")
    # One backward march alone, on the last forward HDR (host clock).
    t = sim.tracer_a
    gen = torch.Generator(device="cuda").manual_seed(2)
    interval = max(0.01, t.backward.integration_interval * SIM_SIZE)
    march, march_ms = _read_ms(lambda: backward_gather(
        t.gbuffer, t._cached_forward_hdr, tracers._teardrop_on(hdr.device), gen, interval))
    _on_card("backward_gather", march, failures)
    return dict(frames=HYB_ORACLE_FRAMES, first_frame_ms=first_ms,
                ms_per_frame=(first_ms + ms_per_step * (HYB_ORACLE_FRAMES - 1))
                / HYB_ORACLE_FRAMES, march_steps=int(2 ** 0.5 * SIM_SIZE) + 4,
                march_ms=march_ms, hdr_mean=float(hdr.mean()))


def _dom_sim(scene, dom: bool):
    sim = Simulation(**dict(README_SIM, frame_limit=HYB_DOM_STEPS,
                            measurement_interval=HYB_DOM_REFRESH))
    sim.set_scene(scene)
    sim._validate_tracers()
    for t in sim._tracers:
        t.forward.dom_bounce = dom
        t.forward.dom_refresh = HYB_DOM_REFRESH
    return sim


def _hybrid_dom(failures: list) -> dict:
    """The cloudy scene at 256^2 with 3 bounces (two cascade waves) on 'rbt'
    in REFERENCE with dom_bounce on both integrators (refresh 8):
    HYB_DOM_STEPS steps; one cascade refresh timed by CUDA events; the
    cascade against its composition through the plain K1-K3 on the card;
    linearity; the output's mass against the same steps with Monte-Carlo
    bounces."""
    scene = cloudy_scene(SIM_SIZE, SIM_SIZE, bounces=HYB_DOM_BOUNCES)
    sim = _dom_sim(scene, True)
    reset_counts()
    first_ms, ms_per_step = _timed_steps(sim, HYB_DOM_STEPS)
    hdr = sim.simulation_output_hdr
    torch.cuda.synchronize()
    launches = read_counts()
    _hdr_ok("dom", hdr, failures)
    _on_card("dom", hdr, failures)
    fwd = sim.tracer_a.forward
    if not fwd._dom_active() or fwd._dom_waves != HYB_DOM_BOUNCES - 1:
        failures.append(f"dom: the cascade is not on ({fwd._dom_ok}, {fwd._dom_waves} waves)")
    if missing := unlaunched(launches, RESOLVE_KERNELS):
        failures.append(f"dom: kernels of the path were not launched: {missing}")

    fields, gb, src = fwd._fields, fwd.gbuffer, fwd._src
    cascade = lambda: dom_bounce_sources(fields, gb, src, n_waves=fwd._dom_waves)
    refresh = lambda: rbt.resolve_raw(fields, cascade(), gb.height, gb.width)
    got = cascade()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    refresh_ms = time_ms(refresh)
    peak = torch.cuda.max_memory_allocated() - base
    with plain_kernels():
        plain = cascade()
    err = max(float((g - p).abs().max()) for g, p in zip(got, plain))
    rel = err / max(float(p.abs().max()) for p in plain)
    if rel > DOM_TOL or not all(bool(torch.isfinite(g).all()) for g in got):
        failures.append(f"dom: cascade vs plain composition {rel} of max > {DOM_TOL}")
    doubled = dom_bounce_sources(fields, gb, tuple(2.0 * c for c in src),
                                 n_waves=fwd._dom_waves)
    lin = max(float((x - 2.0 * y).abs().max()) for x, y in zip(doubled, got))
    lin_rel = lin / max(2.0 * float(y.abs().max()) for y in got)
    if lin_rel > DOM_TOL:
        failures.append(f"dom: twice the sources give {lin_rel} of max off twice the output")
    del doubled, plain

    mc = _dom_sim(scene, False)
    mc_first, mc_ms = _timed_steps(mc, HYB_DOM_STEPS)
    mc_hdr = mc.simulation_output_hdr
    mass = float(hdr.double().sum()) / float(mc_hdr.double().sum())
    if abs(mass - 1) > DOM_MC_MASS:
        failures.append(f"dom: output mass {mass} of the Monte-Carlo bounces'")
    return dict(steps=HYB_DOM_STEPS, waves=fwd._dom_waves, refresh=HYB_DOM_REFRESH,
                first_step_ms=first_ms, ms_per_step=ms_per_step,
                cascade_refresh_ms=refresh_ms, cascade_refresh_peak_extra_bytes=peak,
                vs_plain_max_abs_err=err, vs_plain_rel_err=rel, tol=DOM_TOL,
                linearity_rel_err=lin_rel, mass_vs_mc=mass,
                mc_ms_per_step=mc_ms, hdr_mean=float(hdr.mean()), launches=launches)


def hybrid_phase() -> dict:
    """The hybrid strategy and the cascade in four configurations
    (reference, realtime, oracle, dom), with TF32 off for the backward
    gather's float32 products; K1-K3 must be launched by reference and by
    dom."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures = []
    scene = readme_scene()
    runs = {"reference": _hybrid_reference(scene, failures),
            "realtime": _hybrid_realtime(failures),
            "oracle": _hybrid_oracle(scene, failures),
            "dom": _hybrid_dom(failures)}
    for name in ("reference", "dom"):
        if missing := unlaunched(runs[name]["launches"], RESOLVE_KERNELS):
            failures.append(f"{name}: kernels of the path were not launched: {missing}")
    tf32 = dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                cudnn=torch.backends.cudnn.allow_tf32)
    if any(tf32.values()):
        failures.append(f"hybrid: TF32 was turned on during the phase: {tf32}")
    if failures:
        raise AssertionError("; ".join(failures))
    launches = {name: sum(r["launches"][name] for r in runs.values() if "launches" in r)
                for name in COUNTERS}
    return dict(size=SIM_SIZE, rays_per_frame=SIM_RAYS, allow_tf32=tf32,
                launches=launches, **runs)


# Denoiser training: a corpus made on the card, the reference's mono recipe
# (TrainConfig()'s defaults) and the round-5 production pair recipe
# (runs/train_denoiser_r5.py:95-128 with SMOKE off and LITBOX_TRAIN_STEPS=40).
CORPUS_SCENES = 8
CORPUS_NOISY_STEPS = 4
CORPUS_REF_STEPS = 64
TRAIN_STEPS = 40
TRAIN_GRAD_TOL = 1e-3  # card vs CPU gradients, of the largest magnitude
R5_LR = 1.5e-5
CORPUS_DIR = Path(__file__).resolve().parent / "_smoke"


def corpus_scene(i: int):
    """The README scene with light positions and colors drawn from seed i,
    and one or two medium rects."""
    rng = np.random.default_rng(1000 + i)
    b = SceneBuilder()
    b.add_point_light(tuple(rng.uniform(48, 208, 2)), radius=4,
                      color=tuple(rng.uniform(0.4, 1.0, 3)), intensity=2, bounces=3)
    b.add_ellipse((160, 115), (40, 25), rotation=0.5, color=(.5, .6, 1, 1), log_density=-1.1)
    for _ in range(int(rng.integers(1, 3))):
        b.add_rect(tuple(rng.uniform(40, 216, 2)), tuple(rng.uniform(20, 90, 2)),
                   rotation=float(rng.uniform(0, np.pi)),
                   color=tuple(rng.uniform(0.3, 1.0, 3)) + (1.0,),
                   log_density=float(rng.uniform(-2.0, -0.5)))
    return b.build()


def _rgb_exr(path: Path, rgb) -> np.ndarray:
    arr = rgb.float().cpu().numpy()
    write_exr_rgb(str(path), arr, compression="zip")
    return arr


def _native_reads(paths) -> tuple[list, int]:
    """read_image_linear of each path, and how many the native decoder read."""
    real, decoded = native.read_exr_rgb_native, []

    def counting(path):
        out = real(path)
        decoded.append(out is not None)
        return out

    native.read_exr_rgb_native = counting
    try:
        return [read_image_linear(str(p)) for p in paths], sum(decoded)
    finally:
        native.read_exr_rgb_native = real


def _corpus(root: Path, failures: list) -> dict:
    """CORPUS_SCENES scenes at 256²: tracers A and B of rbt-paired after
    CORPUS_NOISY_STEPS steps, the reference after CORPUS_REF_STEPS, albedo
    and transmissibility from the GBuffer, written with write_exr (ZIP,
    float) and read back through read_image_linear (the native decoder)."""
    reset_counts()
    written = {}
    gen_ms = write_ms = 0.0
    for i in range(CORPUS_SCENES):
        t0 = time.perf_counter()
        sim = Simulation(engine="rbt-paired", seed=i,
                         **dict(README_SIM, frame_limit=CORPUS_REF_STEPS, measurement_interval=0))
        sim.set_scene(corpus_scene(i))
        for _ in range(CORPUS_NOISY_STEPS):
            sim.step()
        a, b = sim.tracer_a.tracer_output.clone(), sim.tracer_b.tracer_output.clone()
        while sim.iterations_since_clear < CORPUS_REF_STEPS:
            sim.step()
        ref = sim.simulation_output_hdr
        gb = sim.gbuffer
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        images = {f"Input0_Radiance_A_{i:03d}": a, f"Input0_Radiance_B_{i:03d}": b,
                  f"Output_Reference_{i:03d}": ref, f"Albedo_{i:03d}": gb.albedo[..., :3],
                  f"Trans_{i:03d}": gb.transmissibility[..., None].expand(-1, -1, 3)}
        for name, img in images.items():
            if img.device.type != "cuda" or not bool(torch.isfinite(img).all()):
                failures.append(f"corpus: {name} is not finite on the card")
            written[name] = _rgb_exr(root / f"{name}.exr", img)
        gen_ms += (t1 - t0) * 1e3
        write_ms += (time.perf_counter() - t1) * 1e3
    launches = read_counts()
    if missing := unlaunched(launches, RESOLVE_KERNELS):
        failures.append(f"corpus: kernels of the path were not launched: {missing}")
    t0 = time.perf_counter()
    native.get_lib()  # the decoder's g++ build at first use, timed apart
    build_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    decoded, native_reads = _native_reads([root / f"{name}.exr" for name in written])
    back = dict(zip(written, decoded))
    read_ms = (time.perf_counter() - t0) * 1e3
    if native_reads != len(written):
        failures.append(f"corpus: the native decoder read {native_reads} of {len(written)}")
    if not native.library_path().exists():
        failures.append("corpus: the native decoder was not built")
    exact = all(np.array_equal(back[k], v) for k, v in written.items())
    codec = all(np.array_equal(back[k], read_exr_rgb(str(root / f"{k}.exr"))) for k in written)
    if not (exact and codec):
        failures.append(f"corpus: read back bit for bit {exact}, native = Python codec {codec}")
    return dict(scenes=CORPUS_SCENES, size=SIM_SIZE, files=len(written),
                noisy_steps=CORPUS_NOISY_STEPS, reference_steps=CORPUS_REF_STEPS,
                generate_ms=gen_ms, write_ms=write_ms, decoder_build_ms=build_ms,
                read_ms=read_ms,
                bytes=sum((root / f"{k}.exr").stat().st_size for k in written),
                native_reads=native_reads, bit_exact=exact, native_equals_python=codec,
                launches=launches)


def _twin_grads(trainer, device: str, inputs, targets) -> tuple[float, dict]:
    """The loss and gradients of one step of `trainer`'s recipe from its
    current weights on `device`, taken as its steps take them
    (Trainer.gradients); a copy of the net, so the trainer's own running
    statistics do not move."""
    twin = copy.copy(trainer)
    twin.model = copy.deepcopy(trainer.model).to(device)
    twin.params = dict(twin.model.named_parameters())
    twin.device = torch.device(device)
    loss = twin.gradients(twin.loss, inputs.to(device), targets.to(device))
    return float(loss), {k: p.grad.cpu() for k, p in twin.params.items()}


def _losses_ok(name: str, losses, failures: list) -> None:
    if not all(np.isfinite(x) for x in losses):
        failures.append(f"{name}: a loss is not finite: {losses}")


def _on_card_step(name: str, root: Path, ckpt: str, failures: list, **kw) -> dict:
    """AIAccelerator.from_checkpoint on a 256² Simulation: one on_step."""
    sim = Simulation(**dict(README_SIM, frame_limit=1))
    sim.set_scene(readme_scene())
    acc = pipeline.AIAccelerator.from_checkpoint(sim, ckpt, **kw)
    t0 = time.perf_counter()
    sim.step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    out = acc.hdr_output
    if out is None or out.device.type != "cuda" or not bool(torch.isfinite(out).all()):
        failures.append(f"{name}: AIAccelerator.from_checkpoint gave no finite output on the card")
    return dict(step_with_on_step_ms=ms, out_channels=acc.model.out_channels,
                last_blend=None if acc.last_blend is None else float(acc.last_blend))


def _mono(root: Path, failures: list) -> dict:
    """TrainConfig()'s defaults through build_curriculum and Trainer.fit."""
    cfg = train.TrainConfig()
    curriculum = build_curriculum(str(root / "Output_Reference_*.exr"), str(root / "Albedo_*.exr"),
                                  str(root / "Trans_*.exr"), str(root / "Input0_Radiance_A_*.exr"),
                                  str(root / "Input0_Radiance_B_*.exr"), crop_size=cfg.crop_size)
    torch.cuda.reset_peak_memory_stats()
    trainer = train.Trainer(cfg)
    if trainer.device.type != "cuda" or any(p.device.type != "cuda"
                                             for p in trainer.params.values()):
        failures.append("mono: the Trainer is not on the card")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        log = trainer.fit(curriculum, log_every=0.0, max_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated()
    losses = [e["loss"] for e in log]
    _losses_ok("mono", losses, failures)
    if trainer.global_step != TRAIN_STEPS or len(losses) != TRAIN_STEPS:
        failures.append(f"mono: {trainer.global_step} steps, {len(losses)} losses")
    arch = dict(unet_size=cfg.unet_size, initial_features=cfg.initial_features)
    flop = 3 * unet_flop(arch, cfg.batch_size, cfg.crop_size, cfg.crop_size)
    # One step's gradients on the card and on the CPU, same weights and batch.
    batch = next(curriculum[0][1].batches(cfg.batch_size, np.random.default_rng(7)))
    x, y = train.Trainer.select_random_channel(batch, np.random.default_rng(8), "cpu")
    t1 = time.perf_counter()
    card_loss, card_grads = _twin_grads(trainer, "cuda", x, y)
    cpu_loss, cpu_grads = _twin_grads(trainer, "cpu", x, y)
    cpu_ms = (time.perf_counter() - t1) * 1e3
    scale = max(float(g.abs().max()) for g in cpu_grads.values())
    grad_err = max(float((card_grads[k] - g).abs().max()) for k, g in cpu_grads.items())
    if not grad_err <= TRAIN_GRAD_TOL * scale:
        failures.append(f"mono: card vs CPU gradients {grad_err} of max {scale}")
    # save -> load into a fresh Trainer: the same eval_fn output bit for bit.
    ckpt = str(root / "mono" / "model.npz")
    t1 = time.perf_counter()
    trainer.save(ckpt, include_optimizer=False)
    fresh = train.Trainer(train.load_train_config(ckpt))
    fresh.load(ckpt)
    io_ms = (time.perf_counter() - t1) * 1e3
    probe = x.cuda()
    same = torch.equal(trainer.eval_fn()(probe), fresh.eval_fn()(probe))
    if not same:
        failures.append("mono: eval_fn differs after save and load")
    del fresh, card_grads, cpu_grads
    accel = _on_card_step("mono", root, ckpt, failures)
    return dict(config="TrainConfig()", unet_size=cfg.unet_size,
                initial_features=cfg.initial_features, crop=cfg.crop_size,
                batch=cfg.batch_size, steps=TRAIN_STEPS, ms_per_step=ms,
                crops_per_second=cfg.batch_size / (ms / 1e3),
                params=sum(p.numel() for p in trainer.params.values()),
                flop_per_step=flop, tflop_per_s=flop / (ms / 1e3) / 1e12,
                fp32_peak_share=flop / (ms / 1e3) / FP32_OPS_PER_S,
                fp32_peak="67 TFLOP/s, H100 SXM float32 outside the tensor cores "
                          "(NVIDIA data sheet)",
                peak_memory_bytes=peak, loss_first=losses[0], loss_last=losses[-1],
                grad_vs_cpu=dict(max_abs_err=grad_err, max_abs=scale, tol=TRAIN_GRAD_TOL,
                                 card_loss=card_loss, cpu_loss=cpu_loss, both_ms=cpu_ms),
                save_load_ms=io_ms, eval_equal_after_load=same, from_checkpoint=accel)


def _r5_config(steps: int) -> "train.TrainConfig":
    """runs/train_denoiser_r5.py:95-128 with SMOKE off and
    LITBOX_TRAIN_STEPS=steps (no warm start: the card has no runs/)."""
    return train.TrainConfig(
        unet_size=4, initial_features=16, crop_size=192, learn_rate=R5_LR, epochs=1,
        lr_decay_steps=steps, lr_min=R5_LR * 0.02, warmup_steps=min(200, steps // 20),
        batch_size=16, global_residual=True, rgb=True, padding_mode="reflect",
        pair_composition=True, raw_loss_weight=0.5,
        loss=HdrLossConfig(normalize_weights=True, log_l1=0.25, rel_l2=1.0, compress="log1p"),
        transform=TransformConfig(use_log_space=True, normalize_input=True))


def _pair(root: Path, failures: list) -> dict:
    """The round-5 recipe on DeviceStages from the corpus: sample_pair with
    identity_p 0.15 and train_batch_pair_async for TRAIN_STEPS steps."""
    cfg = _r5_config(TRAIN_STEPS)
    ids = [f"{i:03d}" for i in range(CORPUS_SCENES)]
    scales = [0.18 / max(float(read_image_linear(str(root / f"Output_Reference_{i}.exr")).mean()),
                         1e-6) for i in ids]
    stage = stack_stage(*[[str(root / f"{p}_{i}.exr") for i in ids] for p in
                          ("Input0_Radiance_A", "Input0_Radiance_B", "Output_Reference")], scales)
    torch.cuda.reset_peak_memory_stats()
    dev = DeviceStages({"Final": stage})
    trainer = train.Trainer(cfg)
    if dev.data["Final"][0].device.type != "cuda" or trainer.device.type != "cuda":
        failures.append("pair: the stages or the Trainer are not on the card")
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed + 1)
    losses = []

    def steps():
        for _ in range(TRAIN_STEPS):
            a, b, ref = dev.sample_pair("Final", gen, cfg.batch_size, cfg.crop_size, True,
                                        identity_p=0.15)
            losses.append(trainer.train_batch_pair_async(a, b, ref))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    syncs = host_syncs(steps)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated()
    if syncs:
        failures.append(f"pair: the step loop made the host wait at {sorted(set(syncs))}")
    if any(x.device.type != "cuda" for x in losses):
        failures.append("pair: a loss is not on the card")
    losses = [float(x) for x in losses]
    _losses_ok("pair", losses, failures)
    # The schedule: lr*0.1 at count 0, the peak at the end of warm-up, lr_min
    # at the end, and the schedule's count advanced once a step.
    lr = trainer.optimizer.lr
    want = {0: R5_LR * 0.1, cfg.warmup_steps: R5_LR, TRAIN_STEPS: R5_LR * 0.02}
    got = {c: float(lr(torch.tensor(c, dtype=torch.int32, device="cuda"))) for c in want}
    count = int(trainer.optimizer.state["schedule_count"])
    if count != TRAIN_STEPS or any(abs(got[c] - v) > 1e-6 * R5_LR for c, v in want.items()):
        failures.append(f"pair: schedule count {count}, lr {got} against {want}")
    arch = dict(unet_size=cfg.unet_size, initial_features=cfg.initial_features,
                out_channels=3, global_residual=True)
    flop = 3 * unet_flop(arch, 2 * cfg.batch_size, cfg.crop_size, cfg.crop_size)
    ckpt = str(root / "pair" / "model.npz")
    trainer.save(ckpt)
    fresh = train.Trainer(train.load_train_config(ckpt))
    fresh.load(ckpt)
    probe = dev.data["Final"][0][:2, :cfg.crop_size, :cfg.crop_size]
    same = (torch.equal(trainer.eval_fn()(probe), fresh.eval_fn()(probe))
            and all(torch.equal(fresh.optimizer.state[m][k], v)
                    for m in ("mu", "nu") for k, v in trainer.optimizer.state[m].items())
            and int(fresh.optimizer.state["schedule_count"]) == TRAIN_STEPS)
    if not same:
        failures.append("pair: the checkpoint does not round-trip")
    accel = _on_card_step("pair", root, ckpt, failures, blend="auto")
    return dict(config="runs/train_denoiser_r5.py SMOKE off, LITBOX_TRAIN_STEPS=40",
                unet_size=cfg.unet_size, initial_features=cfg.initial_features,
                crop=cfg.crop_size, batch=cfg.batch_size, steps=TRAIN_STEPS, ms_per_step=ms,
                crops_per_second=2 * cfg.batch_size / (ms / 1e3), flop_per_step=flop,
                tflop_per_s=flop / (ms / 1e3) / 1e12,
                fp32_peak_share=flop / (ms / 1e3) / FP32_OPS_PER_S,
                peak_memory_bytes=peak, loss_first=losses[0], loss_last=losses[-1],
                host_syncs_in_loop=len(syncs), lr_at=got, checkpoint_round_trip=same,
                from_checkpoint=accel)


def train_phase() -> dict:
    """corpus, mono and pair, with TF32 off; the corpus and checkpoints live
    in a directory of the checkout, removed at the end."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures = []
    shutil.rmtree(CORPUS_DIR, ignore_errors=True)
    CORPUS_DIR.mkdir(parents=True)
    try:
        corpus = _corpus(CORPUS_DIR, failures)
        mono = _mono(CORPUS_DIR, failures)
        torch.cuda.empty_cache()
        pair = _pair(CORPUS_DIR, failures)
    finally:
        shutil.rmtree(CORPUS_DIR, ignore_errors=True)
    tf32 = dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                cudnn=torch.backends.cudnn.allow_tf32)
    if any(tf32.values()):
        failures.append(f"train: TF32 was turned on during the phase: {tf32}")
    if failures:
        raise AssertionError("; ".join(failures))
    return dict(allow_tf32=tf32, corpus=corpus, mono=mono, pair=pair,
                launches=corpus["launches"])


# Dataset generation (the data phase): runs/gen_dataset_r2.py's recipe
# (:17-31), which made the shipped denoiser's training set, cut to 4 of its
# 160 scenes; then the Abduction demo and the buffer picker (the demo phase).
DATA_DIR = CORPUS_DIR / "data"
DATA_SAMPLES = 4
DATA_RECIPE = dict(
    samples_to_generate=DATA_SAMPLES, width=256, height=256,
    input_profiles=(SimulationProfile(5, 8192, 0.1, 4), SimulationProfile(1, 65536, 0.1, 4),
                    SimulationProfile(1, 262144, 0.1, 4)),
    convergence_profile=SimulationProfile(-1, 262144, 0.01, 4), convergence_threshold=6e-4,
    max_convergence_frames=250, seed=1042, mc_direct_inputs=True, jitter_bins=True,
    substrate_texture_size=512)
# A substrate on the card against the same params on the CPU: elementwise
# float32 in one order, pow and sqrt within ulps; a texel whose shape test
# flips (its local coordinate within an ulp of an edge) is allowed up to
# SUBSTRATE_FLIPS times and excluded with its edge-blur neighbourhood.
SUBSTRATE_TOL = 1e-5
SUBSTRATE_FLIPS = 2


class _FactoryClock:
    """Spans of TrainingFactory.generate on the host clock, each ended by a
    synchronize: the substrates (data.factory.generate_random), each
    load_profile to the next mark (an input profile's frames and writes, or
    the convergence loop and its writes) and each scene's log line, with the
    convergence loop's frames read there."""

    def __init__(self):
        self.substrate_ms, self.marks, self._sim = [], [], None

    def mark(self, label: str) -> None:
        torch.cuda.synchronize()
        frames = None
        if label == "end" and self._sim is not None:
            frames, self._sim = self._sim.iterations_since_clear, None
        self.marks.append((label, time.perf_counter(), frames))

    @contextlib.contextmanager
    def installed(self):
        clock, real = self, data_factory.generate_random

        def substrates(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*args, **kw)
            torch.cuda.synchronize()
            clock.substrate_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        class Timed(Simulation):
            def load_profile(self, profile):
                converging = profile.frame_limit == -1
                clock.mark("convergence" if converging else "input")
                if converging:
                    clock._sim = self
                super().load_profile(profile)

        saved = data_factory.Simulation
        data_factory.generate_random, data_factory.Simulation = substrates, Timed
        try:
            yield
        finally:
            data_factory.generate_random, data_factory.Simulation = real, saved

    def scenes(self) -> list:
        """Per scene: set-up (substrates, builder, Simulation), each input
        profile, the convergence loop, and its frames."""
        out, start, spans = [], self.marks[0][1], {}
        for i, (label, t, frames) in enumerate(self.marks[1:], 1):
            if label == "end":
                out.append(dict(spans, frames=frames, total_ms=(t - start) * 1e3))
                start, spans = t, {}
                continue
            spans.setdefault("setup_ms", (t - start) * 1e3)
            spans.setdefault(f"{label}_ms", []).append((self.marks[i + 1][1] - t) * 1e3)
        return out


def _files(path: Path) -> dict:
    return {p.name: (p.stat().st_size, p.stat().st_mtime_ns) for p in sorted(path.iterdir())}


def _convergence_syncs(desc: dict, sample_id: int) -> dict:
    """Host syncs over one convergence loop of the recipe, as the factory
    runs it (the integrators' flags, the profile, the threshold and a
    measure every 100 frames), on a sample's scene."""
    w, h = DATA_RECIPE["width"], DATA_RECIPE["height"]
    scene, _ = data_factory.build_scene_from_description(
        desc, w, h, substrate_texture_size=DATA_RECIPE["substrate_texture_size"])
    sim = Simulation(width=w, height=h, mode=Mode.REFERENCE, seed=sample_id)
    sim.set_scene(scene)
    sim._validate_tracers()
    profile = DATA_RECIPE["convergence_profile"]
    for t in sim._tracers:
        t.forward.analytic_direct, t.forward.jitter_bins = True, True
        t.forward.bounce_rays = profile.rays_per_frame // 4
    sim.load_profile(profile)
    sim.convergence_threshold, sim.measurement_interval = DATA_RECIPE["convergence_threshold"], 100

    def loop():
        while sim.is_running and sim.iterations_since_clear < DATA_RECIPE["max_convergence_frames"]:
            sim.step()

    sites = host_syncs(loop)
    frames = sim.iterations_since_clear
    return dict(sample=sample_id, frames=frames, count=len(sites), per_frame=len(sites) / frames,
                sites=sorted(set(sites)))


def _substrate_on_card(seed: int, failures: list) -> dict:
    """One of the run's substrates (version 2, 512²) made on the card and on
    the CPU from the same params."""
    size = DATA_RECIPE["substrate_texture_size"]
    p = substrate.generate_random_params(seed, 2, size)
    card, card_ms = _read_ms(lambda: substrate.generate_texture(p, "cuda"))
    t0 = time.perf_counter()
    cpu = substrate.generate_texture(p, "cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    _, _, xy = substrate._grid(size, "cpu")
    flips = (substrate._inside(p, xy.cuda()).cpu() != substrate._inside(p, xy))
    keep = torch.ones((size, size), dtype=torch.bool)
    ys, xs = torch.meshgrid(torch.arange(size), torch.arange(size), indexing="ij")
    for fy, fx in torch.nonzero(flips).tolist():
        keep &= torch.hypot((ys - fy).float(), (xs - fx).float()) > p.edge_blur + 2
    err = float((card.cpu() - cpu)[keep].abs().max())
    if int(flips.sum()) > SUBSTRATE_FLIPS or not err <= SUBSTRATE_TOL:
        failures.append(f"substrate {seed}: card vs CPU {err} (tol {SUBSTRATE_TOL}), "
                        f"{int(flips.sum())} shape flips (at most {SUBSTRATE_FLIPS})")
    return dict(seed=seed, version=2, size=size, max_abs_err=err, tol=SUBSTRATE_TOL,
                shape_flips=int(flips.sum()), card_ms=card_ms, cpu_ms=cpu_ms)


def data_phase() -> dict:
    """TrainingFactory with DATA_RECIPE into _smoke/data/ (removed at the
    end): the files of each kept sample, a resumed factory that writes
    nothing, consolidate_sessions, build_curriculum on the session, and one
    substrate on the card against the CPU."""
    failures = []
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    DATA_DIR.mkdir(parents=True)
    clock, logs = _FactoryClock(), []

    def log(message):
        logs.append(message)
        if message.startswith(("Completed", "Discarding")):
            clock.mark("end")

    try:
        fac = data_factory.TrainingFactory(output_folder=str(DATA_DIR), **DATA_RECIPE)
        reset_counts()
        with clock.installed():
            clock.mark("start")
            kept = fac.generate(log=log)
        launches = read_counts()
        session = Path(fac.dataset_path)
        discarded = sorted(set(range(DATA_SAMPLES)) - set(kept))
        if not kept:
            raise AssertionError(f"data: every scene was discarded: {logs}")
        n_inputs = len(DATA_RECIPE["input_profiles"])
        if incomplete := [i for i in kept if not sessions.is_complete(str(session), i, n_inputs)]:
            failures.append(f"data: samples {incomplete} are incomplete")
        if missing := unlaunched(launches, RESOLVE_KERNELS):
            failures.append(f"data: kernels of the path were not launched: {missing}")
        exrs = sorted(session.glob("*.exr"))
        images, native_reads = _native_reads(exrs)
        if native_reads != len(exrs) or not all(np.isfinite(x).all() for x in images):
            failures.append(f"data: {native_reads} of {len(exrs)} EXRs read natively, "
                            "or one is not finite")

        before = _files(session)
        t0 = time.perf_counter()
        resumed = data_factory.TrainingFactory(
            output_folder=str(DATA_DIR), continue_previous_session=True, **DATA_RECIPE)
        again = resumed.generate(log=lambda _: None)
        resume_ms = (time.perf_counter() - t0) * 1e3
        if again != kept or _files(session) != before or resumed.dataset_path != str(session):
            failures.append(f"data: the resumed factory returned {again} (kept {kept}) or "
                            "wrote a file")

        dest = Path(sessions.consolidate_sessions(str(DATA_DIR), n_input_profiles=n_inputs))
        consolidated = sessions.list_sample_ids(str(dest))
        if consolidated != list(range(len(kept))):
            failures.append(f"data: consolidated ids {consolidated} for {len(kept)} kept")

        stages = build_curriculum(*(str(session / g) for g in (
            "Output_Reference_*.exr", "Albedo_*.png", "Transmissibility_*.exr",
            "Input2_Radiance_A_*.exr", "Input2_Radiance_B_*.exr")),
            crop_size=DATA_RECIPE["width"])
        batch = next(stages[-1][1].batches(len(kept), np.random.default_rng(0)))
        shapes = {k: list(v.shape) for k, v in batch.items()}
        want = [len(kept), DATA_RECIPE["height"], DATA_RECIPE["width"], 3]
        if [s for s, _ in stages] != ["Final"] or any(s != want for s in shapes.values()):
            failures.append(f"data: curriculum stages {[s for s, _ in stages]}, batch {shapes}")

        with open(session / f"Scene_{kept[0]:05d}.json") as f:
            desc = json.load(f)
        syncs = _convergence_syncs(desc, kept[0])
        card = _substrate_on_card(desc["substrateSeedsV2"][0], failures)
    finally:
        shutil.rmtree(DATA_DIR, ignore_errors=True)
        with contextlib.suppress(OSError):
            CORPUS_DIR.rmdir()
    if failures:
        raise AssertionError("; ".join(failures))
    scenes = clock.scenes()
    conv = [s for s in scenes if "convergence_ms" in s]
    conv_s = sum(s["convergence_ms"][0] for s in conv) / 1e3
    conv_frames = sum(s["frames"] for s in conv)
    return dict(recipe="runs/gen_dataset_r2.py:17-31, 4 of 160 scenes", samples=DATA_SAMPLES,
                kept=kept, discarded=discarded, scenes=scenes,
                ms_per_scene=sum(s["total_ms"] for s in scenes) / len(scenes),
                substrate_ms=clock.substrate_ms,
                frames_to_convergence=[s.get("frames") for s in scenes],
                photons_per_second=2 * DATA_RECIPE["convergence_profile"].rays_per_frame
                * conv_frames / conv_s,
                convergence_host_syncs=syncs, exrs=len(exrs), native_reads=native_reads,
                resume_ms=resume_ms, consolidated_ids=consolidated, batch_shapes=shapes,
                substrate_card_vs_cpu=card, launches=launches)


# The Abduction demo at its defaults and the picker on the README
# quickstart.
PICKER_STEPS = 4


@contextlib.contextmanager
def _frame_probe(record: dict):
    """Wrap the demo's relight, tone map and render_frame: the devices of
    the HDR and of the composite, and each frame's range."""
    relight, tone, render = (abduction.relight_layer, abduction.tonemap_uchimura,
                             abduction.render_frame)

    def relight_probe(hdr, *a, **kw):
        record["hdr_devices"].add(hdr.device.type)
        return relight(hdr, *a, **kw)

    def tone_probe(comp, *a, **kw):
        record["composite_devices"].add(comp.device.type)
        return tone(comp, *a, **kw)

    def render_probe(*a, **kw):
        frame = render(*a, **kw)
        record["frames"] += 1
        record["finite"] &= bool(np.isfinite(frame).all())
        record["min"] = min(record["min"], float(frame.min()))
        record["max"] = max(record["max"], float(frame.max()))
        return frame

    abduction.relight_layer, abduction.tonemap_uchimura = relight_probe, tone_probe
    abduction.render_frame = render_probe
    try:
        yield
    finally:
        abduction.relight_layer, abduction.tonemap_uchimura = relight, tone
        abduction.render_frame = render


def _sequence(name: str, fn, failures: list) -> tuple[dict, object]:
    record = dict(hdr_devices=set(), composite_devices=set(), frames=0, finite=True,
                  min=float("inf"), max=float("-inf"))
    reset_counts()
    with _frame_probe(record):
        out, ms = _read_ms(fn)
    launches = read_counts()
    if not record["finite"] or record["min"] < 0 or record["max"] > 1:
        failures.append(f"{name}: a frame is not finite in [0, 1]: {record}")
    if record["hdr_devices"] != {"cuda"} or record["composite_devices"] != {"cuda"}:
        failures.append(f"{name}: the HDR or the composite left the card: {record}")
    if missing := unlaunched(launches, RESOLVE_KERNELS):
        failures.append(f"{name}: kernels of the path were not launched: {missing}")
    return dict(frames=record["frames"], ms_per_frame=ms / max(record["frames"], 1),
                frame_min=record["min"], frame_max=record["max"], launches=launches), out


def _picker_run(root: Path, failures: list) -> dict:
    """diag.picker on the README quickstart at 256² with the simulation
    phase's AIAccelerator: each view timed (host clock, synchronized),
    then dump_all."""
    sim = Simulation(**dict(README_SIM, frame_limit=PICKER_STEPS))
    sim.set_scene(readme_scene())
    weights = convert.unet_from_flax(flax_tree(AI_NET, UNET_SEED), **AI_NET)
    acc = pipeline.AIAccelerator(sim, weights, blend="auto", **AI_NET)
    reset_counts()
    sim.run()
    views = {}
    for which in picker.TextureType:
        img, ms = _read_ms(lambda: picker.pick(sim, which, ai=acc))
        views[which.value] = dict(ms=ms, shape=list(img.shape), max=float(img.max()))
        if img.ndim != 3 or img.shape[-1] != 3 or not np.isfinite(img).all():
            failures.append(f"picker: {which.value} is not a finite (H, W, 3) image")
    launches = read_counts()
    paths = picker.dump_all(sim, str(root / "picker"), ai=acc)
    if len(paths) != len(picker.TextureType) or not all(Path(p).exists() for p in paths):
        failures.append(f"picker: dump_all wrote {len(paths)} files")
    if missing := unlaunched(launches, RESOLVE_KERNELS):
        failures.append(f"picker: kernels of the path were not launched: {missing}")
    return dict(size=SIM_SIZE, steps=PICKER_STEPS, views=views,
                ms_per_view=sum(v["ms"] for v in views.values()) / len(views),
                pngs=len(paths), launches=launches)


def demo_phase() -> dict:
    """render_sequence and play_sequence at their defaults, play_sequence's
    state against the same script on an AbductionGame alone, and the picker;
    files in _smoke/demo/ (removed at the end)."""
    failures = []
    root = CORPUS_DIR / "demo"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        render, paths = _sequence("render_sequence",
                                  lambda: abduction.render_sequence(str(root / "render")),
                                  failures)
        play, out = _sequence("play_sequence",
                              lambda: abduction.play_sequence(str(root / "play")), failures)
        alone = game.AbductionGame()
        script = ([game.GameInput(move_x=1.0)] * 6 + [game.GameInput(tractor=True)] * 8
                  + [game.GameInput(move_x=-0.6, tractor=True)] * 6)
        for inp in script:
            alone.step(0.25, inp)
        frames = out.pop("frames")
        if out != alone.scene_params() or len(frames) != len(script) or len(paths) != 8:
            failures.append("play_sequence: its state differs from the game's alone, or "
                            f"{len(frames)} / {len(paths)} frames")
        pick = _picker_run(root, failures)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        with contextlib.suppress(OSError):
            CORPUS_DIR.rmdir()
    if failures:
        raise AssertionError("; ".join(failures))
    launches = {name: render["launches"][name] + play["launches"][name]
                + pick["launches"][name] for name in COUNTERS}
    return dict(render_sequence=dict(render, width=128, rays=16384, sim_frames=3),
                play_sequence=dict(play, width=128, rays=8192, sim_frames=2,
                                   score=out["score"], state=out["state"], won=out["won"]),
                picker=pick, launches=launches)


# parallel/ on torch.distributed (the parallel phase): its four
# configurations at full width on a world of every visible card (NCCL, no
# fallback), rank 0 in this process, so its launches count here.
PAR_RBT_SIZE = 256      # tests/test_parallel.py::test_sharded_rbt_realistic_shape
PAR_RBT_RAYS = 65536    # photons a rank and frame
PAR_RBT_FRAMES = 4
PAR_BINS_SEED = 11
PAR_BINS_FRAMES = 4     # timed frames after the checked one
PAR_TRAIN = dict(unet_size=5, initial_features=32, batch=4)  # the defaults
PAR_CROP = 64  # the crop of the JAX function's default, which only sizes its init
PAR_TRAIN_STEPS = 3
PAR_EXACT = dict(rtol=2e-4, atol=1e-6)  # tests/test_parallel.py:373 (bins vs unsharded)
PAR_MEAN_TOL = 1e-6     # sharded_rbt_resolve vs the mean of resolve_raw, of the maximum
PAR_LOSS_TOL = 1e-4     # first sharded loss vs an unsharded step, relative


class _PathCounts:
    """Launches of the sharded calls only: the references computed beside
    them (the unsharded frame, resolve_raw) launch K1-K3 too and do not
    count."""

    def __init__(self):
        self.launches = {name: 0 for name in COUNTERS}

    @contextlib.contextmanager
    def path(self):
        before = read_counts()
        try:
            yield
        finally:
            for name, count in read_counts().items():
                self.launches[name] += count - before[name]


def _rel_max(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


def _par_oracle(counted: _PathCounts, failures: list) -> dict:
    """sharded_trace_frame on the README quickstart at 256², the simulation
    phase's oracle budget and the interval and bounces its Simulation takes
    (integration_interval 0.1 of the height, the scene's 3 bounces)."""
    scene = readme_scene()
    gb = rasterize(scene, SIM_SIZE, SIM_SIZE)
    brdf = torch.from_numpy(luts.brdf_lut()).cuda()
    interval = max(1.0, SimulationProfile().integration_interval * SIM_SIZE)
    mesh = parallel.make_mesh()
    gen = torch.Generator(device="cuda").manual_seed(0)
    with counted.path():
        (raw, writes), ms = _read_ms(lambda: parallel.sharded_trace_frame(
            mesh, gb, scene.lights, scene.field_textures, brdf, gen, SIM_RAYS, interval,
            -1, max_bounces=3))
    if tuple(raw.shape) != (1, SIM_SIZE, SIM_SIZE, 3) or not bool(torch.isfinite(raw).all()) \
            or float(raw.sum()) <= 0 or int(writes.min()) <= 0:
        failures.append(f"parallel oracle: raw {tuple(raw.shape)} sum {float(raw.sum())}, "
                        f"writes {writes.tolist()}")
    return dict(ms_per_frame=ms, rays_per_rank=SIM_RAYS, interval=interval,
                writes=writes.tolist())


def _par_rbt(counted: _PathCounts, failures: list) -> dict:
    """sharded_rbt_trace_frame for PAR_RBT_FRAMES frames, then both
    resolves, at test_sharded_rbt_realistic_shape's configuration (256²,
    S=384, D=128, 65,536 photons a rank, 2 bounces, MC direct). The full
    resolve against the mean over the ranks of resolve_raw (PAR_MEAN_TOL),
    the bin resolve against the full one (RESOLVE_TOL)."""
    w = PAR_RBT_SIZE
    b = SceneBuilder()
    b.add_point_light((w / 2, w / 2), radius=2.0, intensity=1.5, bounces=2)
    b.add_rect((w / 2, w / 2), (w, w), log_density=-1.2)
    scene = b.build(max_lights=1, max_shapes=1, device="cuda")
    gb = rasterize(scene, w, w)
    brdf = torch.from_numpy(luts.brdf_lut((16, 5, 3))).cuda()
    fields = rbt.precompute_rotated_fields(gb, n_bins=N_BINS)
    mesh = parallel.make_mesh()
    gen = torch.Generator(device="cuda").manual_seed(1)
    src = parallel.zero_sources_sharded(mesh, fields)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with counted.path():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PAR_RBT_FRAMES):
            src, emitted = parallel.sharded_rbt_trace_frame(
                mesh, fields, src, gb, scene.lights, scene.field_textures, brdf, gen,
                PAR_RBT_RAYS, -1, max_bounces=2, mc_direct=True, analytic_direct=False)
        torch.cuda.synchronize()
        frame_ms = (time.perf_counter() - t0) * 1e3 / PAR_RBT_FRAMES
        full, full_ms = _read_ms(lambda: parallel.sharded_rbt_resolve(mesh, fields, src, w, w))
        bins, bins_ms = _read_ms(lambda: parallel.sharded_rbt_resolve_bins(
            mesh, fields, src, w, w))
    peak = torch.cuda.max_memory_allocated() - base
    mean = rbt.resolve_raw(fields, src, w, w)
    dist.all_reduce(mean, dist.ReduceOp.AVG)
    mean_err, bins_err = _rel_max(full[0], mean), _rel_max(bins, full)
    world_size = dist.get_world_size()
    if emitted.tolist() != [world_size * PAR_RBT_RAYS]:
        failures.append(f"parallel rbt: emitted {emitted.tolist()}")
    if not bool(torch.isfinite(full).all()) or float(full.sum()) <= 0:
        failures.append("parallel rbt: the resolved map is not finite and positive")
    if mean_err > PAR_MEAN_TOL:
        failures.append(f"parallel rbt: sharded_rbt_resolve vs the mean of resolve_raw "
                        f"{mean_err} > {PAR_MEAN_TOL}")
    if bins_err > RESOLVE_TOL:
        failures.append(f"parallel rbt: sharded_rbt_resolve_bins vs sharded_rbt_resolve "
                        f"{bins_err} > {RESOLVE_TOL}")
    return dict(size=w, s=fields.size, n_bins=N_BINS, rays_per_rank=PAR_RBT_RAYS,
                frames=PAR_RBT_FRAMES, ms_per_frame=frame_ms, resolve_ms=full_ms,
                resolve_bins_ms=bins_ms, peak_above_start_bytes=peak,
                resolve_vs_mean_max_rel=mean_err, bins_vs_resolve_max_rel=bins_err)


def _par_bins(counted: _PathCounts, failures: list) -> dict:
    """bins_trace_frame + bins_resolve on the shipped frame's scene
    (480x272, S=640, D=128) at REALTIME_1080P's budget per tracer, 3
    bounces (waves 1 and 2 through the all-to-all), BRDF on: the first
    frame against the port's unsharded frame + resolve_raw on the generator
    row 0 derives (PAR_EXACT), no overflow; then PAR_BINS_FRAMES timed
    frames."""
    prof = REALTIME_1080P
    h, w = prof.sim_height, prof.sim_width
    scene, gb = build_scene(w, h, tex=256)
    brdf = torch.from_numpy(luts.brdf_lut()).cuda()
    fields = rbt.precompute_rotated_fields(gb, n_bins=prof.n_bins)
    photons, bounce = prof.photons // 2, prof.bounce_photons // 2
    opts = dict(max_bounces=4, bounce_photons=bounce, enable_brdf=True)
    mesh = parallel.make_bins_mesh()
    bf = parallel.shard_fields_bins(mesh, fields)
    src = parallel.zero_sources_bins(mesh, bf)
    gen = torch.Generator(device="cuda").manual_seed(PAR_BINS_SEED)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with counted.path():
        (src, emitted, overflow), first_ms = _read_ms(lambda: parallel.bins_trace_frame(
            mesh, bf, src, gb, scene.lights, brdf, gen, photons, 3, **opts))
        raw, resolve_ms = _read_ms(lambda: parallel.bins_resolve(mesh, bf, src, h, w))
    seeded = torch.Generator(device="cuda").manual_seed(PAR_BINS_SEED)
    src_ref, n_ref = rbt.rbt_trace_frame(
        fields, rbt.zero_sources(fields), gb, scene.lights, scene.field_textures, brdf,
        par_world.derive_generator(seeded, 0, 1), photons, 3, mc_direct=True,
        analytic_direct=False, hist_direct=True, **opts)
    ref = rbt.resolve_raw(fields, src_ref, h, w)
    del src_ref
    excess = float(((raw[0] - ref).abs() - (PAR_EXACT["atol"] + PAR_EXACT["rtol"] * ref.abs()))
                   .max())
    max_abs, max_rel = float((raw[0] - ref).abs().max()), _rel_max(raw[0], ref)
    del ref
    if excess > 0:
        failures.append(f"parallel bins: row 0 vs the unsharded frame exceeds {PAR_EXACT} "
                        f"by {excess} (max_abs_err {max_abs})")
    if overflow.tolist() != [0]:
        failures.append(f"parallel bins: all-to-all overflow {overflow.tolist()}")
    if emitted.tolist() != [n_ref]:
        failures.append(f"parallel bins: emitted {emitted.tolist()} vs {n_ref}")
    with counted.path():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PAR_BINS_FRAMES):
            src, _, overflow = parallel.bins_trace_frame(
                mesh, bf, src, gb, scene.lights, brdf, gen, photons, 3, **opts)
        torch.cuda.synchronize()
        frame_ms = (time.perf_counter() - t0) * 1e3 / PAR_BINS_FRAMES
        raw = parallel.bins_resolve(mesh, bf, src, h, w)
    peak = torch.cuda.max_memory_allocated() - base
    if overflow.tolist() != [0] or not bool(torch.isfinite(raw).all()):
        failures.append(f"parallel bins: later frames overflow {overflow.tolist()} or "
                        "a map that is not finite")
    return dict(width=w, height=h, s=fields.size, n_bins=prof.n_bins,
                bins_per_rank=int(bf.trans.shape[0]), photons=photons,
                bounce_photons=bounce, first_frame_ms=first_ms, ms_per_frame=frame_ms,
                resolve_ms=resolve_ms, peak_above_start_bytes=peak,
                vs_unsharded_max_abs_err=max_abs, vs_unsharded_max_rel=max_rel,
                vs_unsharded_excess=excess, overflow=0)


def _par_train(counted: _PathCounts, failures: list) -> dict:
    """build_sharded_train_step at its defaults (size 5, 32 features, crop
    64, batch 4) for PAR_TRAIN_STEPS steps with TF32 off on the batch of
    test_sharded_train_bn_stats_are_global at crop 64: finite losses, the
    first within PAR_LOSS_TOL of an unsharded step of the port's net from
    the same init."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    crop, batch = PAR_CROP, PAR_TRAIN["batch"]
    rng = np.random.default_rng(0)
    inputs = rng.normal(size=(batch, crop, crop, 1)).astype(np.float32)
    targets = rng.normal(size=(batch, crop, crop, 1)).astype(np.float32) ** 2
    mesh = parallel_train.make_train_mesh()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    run, params, stats, opt = parallel_train.build_sharded_train_step(mesh, **PAR_TRAIN)
    losses, ms = [], []
    with counted.path():
        for _ in range(PAR_TRAIN_STEPS):
            (params, stats, opt, loss), step_ms = _read_ms(
                lambda: run(params, stats, opt, inputs, targets))
            losses.append(float(loss))
            ms.append(step_ms)
    peak = torch.cuda.max_memory_allocated() - base
    n_params = sum(p.numel() for p in params.values())
    del run, params, stats, opt
    net = LitboxDenoiserNet(unet_size=PAR_TRAIN["unet_size"],
                            initial_features=PAR_TRAIN["initial_features"]).cuda()
    init_weights(net, torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad():
        ref = float(hdr_loss(net(torch.from_numpy(inputs).cuda(), train=True),
                             torch.from_numpy(targets).cuda(), HdrLossConfig()))
    del net
    rel = abs(losses[0] - ref) / max(abs(ref), 1e-30)
    if not all(np.isfinite(losses)) or rel > PAR_LOSS_TOL:
        failures.append(f"parallel train: losses {losses}, the first vs unsharded {ref} "
                        f"({rel} > {PAR_LOSS_TOL})")
    return dict(PAR_TRAIN, crop=crop, mesh=par_world.mesh_shape(mesh), params_on_rank=n_params,
                losses=losses, unsharded_first_loss=ref, first_loss_rel=rel,
                first_step_ms=ms[0], ms_per_step=statistics.mean(ms[1:]),
                peak_above_start_bytes=peak)


def parallel_rank() -> dict:
    """One rank's four configurations of the parallel phase (every rank
    holds the same checks); raises if one fails."""
    failures = []
    counted = _PathCounts()
    out = dict(oracle=_par_oracle(counted, failures), rbt=_par_rbt(counted, failures))
    torch.cuda.empty_cache()
    out["bins"] = _par_bins(counted, failures)
    torch.cuda.empty_cache()
    out["train"] = _par_train(counted, failures)
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"rank {dist.get_rank()}: " + "; ".join(failures))
    return dict(out, launches=counted.launches)


def parallel_phase() -> dict:
    """litbox_tpu_torch/parallel/ on a world of every visible card with
    NCCL: the data-parallel oracle and RBT, the bin-sharded RBT and the
    sharded training step (parallel_rank). K1-K3 must be launched by the
    sharded calls."""
    n = torch.cuda.device_count()
    reset_counts()
    out = par_world.run(parallel_rank, n, device="cuda", inline_rank0=True, timeout=300)[0]
    if missing := unlaunched(out["launches"], RESOLVE_KERNELS):
        raise AssertionError(f"parallel: kernels of the path were not launched: {missing}")
    return dict(world_size=n, backend=par_world.backend_for("cuda"), **out)


def rotfused_split_phase() -> tuple[dict, dict]:
    """runs/prof_rotfused.py on the card: V1-V4 and K4 on the same images,
    at the script's (384, 640, 640) and at the frame's group shape
    (24, 640, 640), K4 also with LARGE_DELTA, timed from device memory (the
    group shape is under the L2 size, so the cache is flushed before each
    timed call), then each held against its plain version, V4 and K4 beside
    the bytes their copies read per image texel as the kernels count them,
    V3 also with two calls held equal bit for bit.
    Returns (launches, per-kernel cases)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    reset_counts()
    cases = {name: [] for name in SPLIT + ("rotate_planar_sum_fused",)}
    inputs = []
    for n, s in ((3 * N_BINS, 640), (3 * N_BINS // REALTIME_1080P.resolve_groups, 640)):
        img = torch.rand((n, s, s), generator=gen, device="cuda")
        resid = (torch.rand((n,), generator=gen, device="cuda") - 0.5) * (np.pi / 2)
        alpha, beta = -torch.tan(resid / 2), torch.sin(resid)
        d = n // 3
        base = tuple(-i * 2 * np.pi / N_BINS for i in range(0, N_BINS, N_BINS // d))
        chans = tuple(img[c * d:(c + 1) * d] for c in range(3))
        args = {"copy_accum": (img,), "transpose2_accum": (img,),
                "shear1_accum": (img, alpha), "shear3_accum": (img, alpha, beta)}
        runs = len(rotate._quadrant_groups(base))
        plane = 4 * s * s
        # Operations per image and texel: V1/V2 one add; V3 a shift (4) and
        # a lerp (3) and the add; V4 three of those; K4 ROT3_OPS.
        ops = {"copy_accum": 1, "transpose2_accum": 1, "shear1_accum": 8,
               "shear3_accum": 22}
        for name in SPLIT:
            fn = getattr(rotfused, name)
            b, by = bound(plane * (n + 1), ops[name] * n * s * s)
            ms = time_ms(lambda: fn(*args[name]), cold=True)
            cases[name].append(dict(shape=f"({n},{s},{s})", ms=ms, bound_ms=b,
                                    bound_by=by, share=b / ms))
        b, by = bound(plane * (n + 3 * runs), ROT3_OPS * n * s * s)
        # K4 with delta 0 and with LARGE_DELTA as a tensor (the general path).
        for delta in (0.0, torch.tensor(LARGE_DELTA, device="cuda")):
            ms = time_ms(lambda: rotate.rotate_planar_sum_fused(chans, base, delta),
                         cold=True)
            cases["rotate_planar_sum_fused"].append(dict(
                shape=f"3x({d},{s},{s}) runs {runs} delta {float(delta)}",
                bound_ms=b, bound_by=by, share=b / ms, ms=ms))
        inputs.append((img, args, chans, base))
    torch.cuda.synchronize()
    launches = read_counts()
    # Held against the plain versions, with their times and the library
    # yardstick where one PyTorch call computes the same function: V1 and V2
    # both compute the images' sum.
    for i, (img, args, chans, base) in enumerate(inputs):
        sum_ms = time_ms(lambda: torch.sum(img, 0), cold=True)
        for name in SPLIT:
            library = (dict(library_ms=sum_ms, library="torch.sum",
                            library_ratio=cases[name][i]["ms"] / sum_ms)
                       if name in ("copy_accum", "transpose2_accum")
                       else dict(library_ms=None, library=None, library_ratio=None))
            fn, plain = getattr(rotfused, name), getattr(rotfused, name + "_plain")
            c = cases[name][i]
            c.update(compare(name, fn(*args[name]), plain(*args[name])),
                     plain_ms=time_ms(lambda: plain(*args[name]), reps=3, warmup=1),
                     **library)
        # V2 adds the images in V1's order: the two must agree bit for bit.
        v1, v2 = rotfused.copy_accum(img), rotfused.transpose2_accum(img)
        if not torch.equal(v1, v2):
            raise AssertionError(
                f"transpose2_accum differs from copy_accum at {tuple(img.shape)}: "
                f"max_abs_err {float((v1 - v2).abs().max())}")
        cases["transpose2_accum"][i]["equals_copy_accum"] = True
        # V4's count of the bytes its copies read, from a counting launch
        # whose output must equal the plain launch's bit for bit.
        counts = torch.zeros(1, dtype=torch.int64, device="cuda")
        if not torch.equal(rotfused.shear3_accum(*args["shear3_accum"], counts),
                           rotfused.shear3_accum(*args["shear3_accum"])):
            raise AssertionError("shear3_accum: the counting launch differs")
        cases["shear3_accum"][i]["counted_bytes_per_texel"] = counts.item() / img.numel()
        # V3 adds the warps' partials in a fixed order, as V4 does.
        if not torch.equal(rotfused.shear1_accum(*args["shear1_accum"]),
                           rotfused.shear1_accum(*args["shear1_accum"])):
            raise AssertionError("shear1_accum: two calls differ")
        cases["shear1_accum"][i]["repeat_equal_bits"] = True
        for j, delta in enumerate((0.0, torch.tensor(LARGE_DELTA, device="cuda"))):
            plain = lambda: rotate.rotate_planar_sum_fused_plain(chans, base, delta)
            got = rotate.rotate_planar_sum_fused(chans, base, delta)
            cases["rotate_planar_sum_fused"][2 * i + j].update(
                compare("rotate_planar_sum_fused", got, plain()),
                **rot3_counts(chans, base, delta, got),
                plain_ms=time_ms(plain, reps=3, warmup=1), library_ms=None,
                library_ratio=None)
    del inputs
    torch.cuda.empty_cache()
    return launches, cases


# The microops shapes: runs/prof_microops.py's (N, S), the pipeline's resolve
# (3 channels x 128 bins) and the shipped frame's group (3 x 8 bins).
MICRO_SHAPES = ((64, 640), (3 * N_BINS, 640),
                (3 * N_BINS // REALTIME_1080P.resolve_groups, 640))
# The one PyTorch call that computes each non-roll function.
MICRO_LIBRARY = {"transpose": ("x.transpose(1, 2).contiguous()",
                               lambda x: x.transpose(1, 2).contiguous()),
                 "transpose2": ("torch.mul(x, 2.0)", lambda x: torch.mul(x, 2.0)),
                 "flip2": ("torch.flip(x, (1, 2))", lambda x: torch.flip(x, (1, 2)))}
# The rolls with per-image shifts have no one-call equivalent; timed again
# with every shift equal to this, beside torch.roll.
UNIFORM_SHIFT = 213


def _micro_args(name: str, x, shifts) -> tuple:
    return (x, shifts) if name.startswith("roll") else (x,)


def microops_phase() -> tuple[dict, dict]:
    """runs/prof_microops.py on the card: the five data movements timed at
    MICRO_SHAPES from device memory (an L2 flush before each timed call),
    with the script's shifts arange(N), beside their byte bounds; the rolls
    again with a uniform shift beside torch.roll. Then each is held against
    its plain version bit for bit, with those shifts and with shifts from
    -3S past N*S (negative and >= S), and beside its library call. Returns
    (launches, per-kernel cases)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    reset_counts()
    cases = {name: [] for name in MICROOPS}
    inputs = []
    for n, s in MICRO_SHAPES:
        x = torch.rand((n, s, s), generator=gen, device="cuda")
        shifts = torch.arange(n, dtype=torch.int32, device="cuda")
        uniform = torch.full((n,), UNIFORM_SHIFT, dtype=torch.int32, device="cuda")
        for name in MICROOPS:
            fn = getattr(microops, name)
            args = _micro_args(name, x, shifts)
            ms = time_ms(lambda: fn(*args), cold=True)
            # transpose2's doubling: one operation a texel.
            b, by = bound(2 * 4 * n * s * s, n * s * s if name == "transpose2" else 0)
            c = dict(shape=f"({n},{s},{s})", ms=ms, us_per_image=ms * 1e3 / n,
                     bound_ms=b, bound_by=by, bound_share=b / ms)
            if name.startswith("roll"):
                c["uniform_shift"] = dict(
                    shift=UNIFORM_SHIFT, ms=time_ms(lambda: fn(x, uniform), cold=True))
            cases[name].append(c)
        inputs.append((x, shifts, uniform))
    torch.cuda.synchronize()
    launches = read_counts()
    for i, (x, shifts, uniform) in enumerate(inputs):
        n, s = x.shape[0], x.shape[1]
        wild = torch.arange(n, dtype=torch.int32, device="cuda") * 97 - 3 * s
        for name in MICROOPS:
            fn, plain = getattr(microops, name), getattr(microops, name + "_plain")
            args = _micro_args(name, x, shifts)
            c = cases[name][i]
            c.update(compare(name, fn(*args), plain(*args)),
                     plain_ms=time_ms(lambda: plain(*args), reps=3, warmup=1, cold=True))
            if name.startswith("roll"):
                c["wild_shifts"] = dict(
                    lo=int(wild[0]), hi=int(wild[-1]),
                    **compare(name, fn(x, wild), plain(x, wild)))
                dims = 1 if name == "roll_rows" else 2
                library = lambda: torch.roll(x, UNIFORM_SHIFT, dims=dims)
                err = float((fn(x, uniform) - library()).abs().max())
                if err:
                    raise AssertionError(f"{name} vs torch.roll: max_abs_err {err}")
                u = c["uniform_shift"]
                u.update(library=f"torch.roll(x, k, dims={dims})",
                         library_ms=time_ms(library, cold=True), library_max_abs_err=err)
                u["library_ratio"] = u["ms"] / u["library_ms"]
                c.update(library=None, library_ms=None, library_ratio=None)
            else:
                label, lib = MICRO_LIBRARY[name]
                err = float((fn(x) - lib(x)).abs().max())
                if err:
                    raise AssertionError(f"{name} vs {label}: max_abs_err {err}")
                lib_ms = time_ms(lambda: lib(x), cold=True)
                c.update(library=label, library_ms=lib_ms, library_ratio=c["ms"] / lib_ms,
                         library_max_abs_err=err)
    del inputs
    torch.cuda.empty_cache()
    return launches, cases


def resolve_copies(gen, n_groups: int) -> dict:
    """resolve_raw's steps timed one by one (device time, L2 flushed) on
    random fields and one-tracer sources at S=640, D=N_BINS, resolving
    group 3 % n_groups of n_groups: the scan, the quadrant rot90/cat
    (litbox_tpu_torch/ops/rotate.py:219-221), the two shears, the two
    transpose(1, 2).contiguous() (:227, :229), shear_reduce and the final
    crop + movedim (sim/rbt.py:656-657), each copy beside the B5 kernel
    that does the same movement on the same images, and the whole
    resolve_raw (device time, and host time to issue it)."""
    prof, d, s = REALTIME_1080P, N_BINS, 640
    height, width = prof.sim_height, prof.sim_width
    group = 3 % n_groups
    ang = torch.arange(d, dtype=torch.float32, device="cuda") * (-2 * np.pi / d)
    fields = rbt.RotatedFields(
        cos=torch.cos(ang), sin=torch.sin(ang),
        trans=torch.rand((d, s, s), generator=gen, device="cuda") * 0.2 + 0.8,
        cum_log=torch.zeros((d, s, s), device="cuda"),
        cum_coarse=torch.zeros((d, s, s // 16), device="cuda"),
        center=torch.tensor([width / 2.0, height / 2.0], device="cuda"),
        phase=torch.zeros((), device="cuda"))
    src = tuple(torch.rand((d, s, s), generator=gen, device="cuda") for _ in range(3))
    resolve = lambda: rbt.resolve_raw(fields, src, height, width, group=group,
                                      n_groups=n_groups)
    # The steps as rotate_planar_sum issues them (delta 0, rows [lo, hi)).
    scan = lambda: attnscan.attenuation_scan_rows(fields.trans, *src, group=group,
                                                  n_groups=n_groups)
    dep = scan()
    base = tuple(-i * 2.0 * np.pi / d for i in range(group, d, n_groups))
    runs = rotate._quadrant_groups(base)
    cat = lambda: torch.cat([torch.rot90(ch[a:b], k, dims=(1, 2)) if k else ch[a:b]
                             for ch in dep for a, b, k in runs], dim=0)
    pre = cat()
    residual = rotate._residuals(base, 0.0, "cuda")
    alpha = (-torch.tan(residual / 2.0)).repeat(3)
    beta = torch.sin(residual).repeat(3)
    shear_a = lambda: rotate.shear(pre, alpha, 1, 1, s)
    flat = shear_a()
    transpose1 = lambda: flat.transpose(1, 2).contiguous()
    flat_t = transpose1()
    shear_b = lambda: rotate.shear(flat_t, beta, 1, 1, s)
    t = shear_b()
    transpose2 = lambda: t.transpose(1, 2).contiguous()
    flat2 = transpose2()
    oy, ox = (s - height) // 2, (s - width) // 2
    lo, hi = (oy // 64) * 64, min(-(-(oy + height) // 64) * 64, s)
    reduce = lambda: rotate.shear_reduce(flat2, alpha, 1, 1, s, rotate.ALPHA_BOUND,
                                         lo, hi, 3)
    out = reduce()
    crop = lambda: out[:, oy - lo:oy - lo + height, ox:ox + width].movedim(0, -1).contiguous()
    err = float((crop() - resolve()).abs().max())
    if err:
        raise AssertionError(f"resolve_raw's steps vs resolve_raw: max_abs_err {err}")
    step = lambda fn: time_ms(fn, cold=True)
    steps = dict(scan=step(scan), rot90_cat=step(cat), shear_1=step(shear_a),
                 transpose_227=step(transpose1),
                 shear_2=step(shear_b),
                 transpose_229=step(transpose2), shear_reduce=step(reduce),
                 crop_movedim=step(crop))
    copies = ("rot90_cat", "transpose_227", "transpose_229", "crop_movedim")
    resolve_ms = step(resolve)
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        h = time.perf_counter()
        resolve()
        host.append((time.perf_counter() - h) * 1e3)
    torch.cuda.synchronize()
    images = pre.shape[0]
    return dict(
        shape=f"3x({d // n_groups},{s},{s}) group {group}/{n_groups}, out {height}x{width}",
        quadrant_runs=[[b - a, k] for a, b, k in runs],
        step_ms=steps, copies_ms=sum(steps[k] for k in copies),
        steps_sum_ms=sum(steps.values()), resolve_raw_ms=resolve_ms,
        resolve_raw_host_issue_ms=statistics.median(host),
        copy_bound_ms=bound(2 * 4 * images * s * s, 0)[0],
        b5_beside=dict(flip2_ms=step(lambda: microops.flip2(pre)),
                       transpose_ms=step(lambda: microops.transpose(flat)),
                       images=images),
        steps_vs_resolve_raw_max_abs_err=err)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the card only")
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    phase("env", t0, torch=torch.__version__, cuda=torch.version.cuda,
          device=json.dumps(name), nvidia_smi=json.dumps(smi))

    t0 = time.perf_counter()
    _, seconds, log = cuda_lib.build()
    cuda_lib.library()
    for line in log.splitlines():
        if "registers" in line or "error" in line.lower():
            print("  nvcc:", line.strip())
    phase("build", t0, nvcc=("cached" if seconds is None else f"{seconds:.3f}s"))

    install_recorders()
    t0 = time.perf_counter()
    measured = kernels_phase()
    phase("kernels", t0)
    _recording[0] = "path"

    t0 = time.perf_counter()
    frame = frame_phase()
    phase("frame", t0)
    print(json.dumps({"frame": frame}))

    t0 = time.perf_counter()
    pipe, last = pipeline_phase(with_f64="--resolve-f64" in sys.argv[1:])
    phase("pipeline", t0)
    print(json.dumps({"pipeline": pipe}))

    t0 = time.perf_counter()
    fused = fused_resolve_phase(*last)
    phase("fused_resolve", t0)
    print(json.dumps({"fused_resolve": fused}))
    del last
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    prod = production_phase()
    phase("production", t0)
    print(json.dumps({"production": prod}))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    sim = simulation_phase()
    phase("simulation", t0)
    print(json.dumps({"simulation": sim}))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    hyb = hybrid_phase()
    phase("hybrid", t0)
    print(json.dumps({"hybrid": hyb}))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    trn = train_phase()
    phase("train", t0)
    print(json.dumps({"train": trn}))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    data = data_phase()
    phase("data", t0)
    print(json.dumps({"data": data}))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    demo = demo_phase()
    phase("demo", t0)
    print(json.dumps({"demo": demo}))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    par = parallel_phase()
    phase("parallel", t0, world_size=par["world_size"], backend=par["backend"])
    print(json.dumps({"parallel": par}))
    torch.cuda.empty_cache()
    _recording[0] = None
    print(json.dumps({"kernel_signatures": dict(
        checked=len(SIGNATURES["checked"]), path=len(SIGNATURES["path"]),
        unchecked=unchecked_signatures())}))
    if not SIGNATURES["path"]:
        raise AssertionError("no K1-K3 launch was recorded on the paths")
    if unchecked := unchecked_signatures():
        raise AssertionError("K1-K3 were launched on a path at shapes the kernels "
                             f"phase does not hold against their plain versions: {unchecked}")

    t0 = time.perf_counter()
    split_launches, split = rotfused_split_phase()
    phase("rotfused_split", t0)
    print(json.dumps({"rotfused_split": dict(launches=split_launches, cases=split)}))
    for kname, cases in split.items():
        measured[kname] = tuple(measured.get(kname, ())) + tuple(cases)
    if missing := unlaunched(split_launches, SPLIT + ("rotate_planar_sum_fused",)):
        raise AssertionError(f"kernels of the split were not launched: {missing}")

    t0 = time.perf_counter()
    micro_launches, micro = microops_phase()
    gen = torch.Generator(device="cuda").manual_seed(6)
    copies = {"pipeline": resolve_copies(gen, 1),
              "group": resolve_copies(gen, REALTIME_1080P.resolve_groups)}
    torch.cuda.empty_cache()
    phase("microops", t0)
    print(json.dumps({"microops": dict(launches=micro_launches, cases=micro,
                                       resolve_copies=copies)}))
    measured.update(micro)
    if missing := unlaunched(micro_launches, MICROOPS):
        raise AssertionError(f"kernels of the microops were not launched: {missing}")

    # launches: the count on the path that drives each kernel, the shipped
    # frame for K1-K3, the fused resolve for K4, the split for V1-V4 and the
    # microops phase for B5's five; every path's counts beside it.
    paths = {"bench_frame": frame["launches"], "pipeline": pipe["launches"],
             "fused_resolve": fused["launches"], "production": prod["launches"],
             "simulation": sim["launches"], "hybrid": hyb["launches"],
             "train": trn["launches"], "data": data["launches"], "demo": demo["launches"],
             "parallel": par["launches"],
             "rotfused_split": split_launches,
             "microops": micro_launches}
    drives = {"rotate_planar_sum_fused": "fused_resolve",
              **{name: "rotfused_split" for name in SPLIT},
              **{name: "microops" for name in MICROOPS}}
    rows = []
    for kname, cases in measured.items():
        path = drives.get(kname, "production")
        rows.append(dict(name=kname, route="cuda", **{
            k: KERNELS[kname][k] for k in ("source", "replaces")},
            launches=paths[path][kname],
            launches_by_path={p: c[kname] for p, c in paths.items()},
            tol=KERNELS[kname]["tol"], **cases[0], cases=list(cases[1:])))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
