"""Where the time of bench.py's frame, of the make_frame_fn pipeline and of
the shipped realtime frame goes on the card (litbox_tpu_torch).

    python3 chip_profile.py [trace.json]

Uses chip_smoke.py's scene and trace options (bench.py's frame at 256^2,
D=128, 2,000,000 photons, 524,288 bounce chains). Prints three JSON lines:

- "stages": CUDA-event times of the frame's stages, median of 5 after a
  warm-up: the direct stamp histogram, the bounce chains, the injection,
  and the resolve (scan + three shears) with the HDR conversion.
- "profile": torch.profiler over 3 trace frames and one resolve: device
  time by kernel name (top 15), and the device-busy share of the window
  (summed kernel time over the window's wall time; one stream, so kernels
  do not overlap). With a path argument the chrome trace is written there.
- "pipeline_profile": the same for chip_smoke.py's make_frame_fn pipeline
  (480x272, S=640, D=128, 1,000,000 photons, float32 UNet of size 5): three
  trace stages alone, then two whole frames.
- "production_profile": the same for chip_smoke.py's shipped frame
  (engine/realtime.py on REALTIME_1080P, bf16 net of the shipped shape):
  8 frames after 9 warm ones (one flush and one calibration among them),
  then 8 single-pass displays alone.
- "train_profile": the same for chip_smoke.py's two training recipes with
  TF32 off, on random batches of their shapes after 2 warm steps: 3 steps
  of TrainConfig()'s mono net (train_batch_async, batch 4 at 256^2) and 3
  of the round-5 pair recipe (sample_pair on DeviceStages of 8 random
  256^2 scenes, then train_batch_pair_async), each with the device time
  of the convolution kernels (cuDNN's and the GEMMs: names with conv,
  gemm, winograd, fft or cudnn) beside the rest.

Needs one CUDA device; imports torch, numpy and litbox_tpu_torch only.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

import chip_smoke as smoke
from litbox_tpu_torch.core import luts
from litbox_tpu_torch.engine import realtime
from litbox_tpu_torch.engine.pipeline import denoise_hdr
from litbox_tpu_torch.nn import train
from litbox_tpu_torch.nn.device_data import DeviceStages
from litbox_tpu_torch.nn.unet import LitboxDenoiserNet
from litbox_tpu_torch.sim import rbt
from litbox_tpu_torch.sim.oracle import to_hdr


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    scene, gb = smoke.build_scene(smoke.RESOLUTION)
    brdf = torch.from_numpy(luts.brdf_lut()).cuda()
    fields = rbt.precompute_rotated_fields(gb, n_bins=smoke.N_BINS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    src = rbt.zero_sources(fields)
    opts = smoke.TRACE_OPTS
    n = smoke.RAYS_PER_FRAME
    w = smoke.RESOLUTION
    pixels = float(w * w)

    def direct():
        return rbt._mc_point_hist_deposits(scene.lights, fields, n, gen, -1, pixels)

    def bounce():
        return rbt._bounce_chain_deposits(
            fields, gb, scene.lights, scene.field_textures, brdf, gen,
            opts["bounce_photons"], -1, opts["max_bounces"], opts["enable_brdf"],
            opts["light_kinds"], True)

    flat_d, vals_d, _ = direct()
    flat_b, vals_b = bounce()
    flat, vals = torch.cat([flat_d, flat_b]), torch.cat([vals_d, vals_b])
    stages = {
        "direct_hist_ms": smoke.time_ms(direct, reps=5, warmup=1),
        "bounce_chains_ms": smoke.time_ms(bounce, reps=5, warmup=1),
        "inject_ms": smoke.time_ms(lambda: rbt._inject_flat(src, flat, vals),
                                   reps=5, warmup=1),
        "trace_frame_ms": smoke.time_ms(lambda: rbt.rbt_trace_frame(
            fields, src, gb, scene.lights, scene.field_textures, brdf, gen, n,
            -1, **opts), reps=5, warmup=1),
        "resolve_and_hdr_ms": smoke.time_ms(lambda: to_hdr(
            rbt.resolve_raw(fields, src, w, w), 1.0, gb), reps=5, warmup=1),
        "deposits_per_frame": int(flat.numel()),
    }
    print(json.dumps({"stages": stages}))

    def bench_window():
        nonlocal src
        for _ in range(3):
            src, _ = rbt.rbt_trace_frame(fields, src, gb, scene.lights,
                                         scene.field_textures, brdf, gen, n, -1, **opts)
        to_hdr(rbt.resolve_raw(fields, src, w, w), 1.0, gb)

    trace_path = sys.argv[1] if len(sys.argv) > 1 else None
    print(json.dumps({"profile": profile_window(
        "3 trace frames + 1 resolve + HDR", bench_window, trace_path)}))
    del fields, src, flat, vals, flat_d, vals_d, flat_b, vals_b
    torch.cuda.empty_cache()

    # The make_frame_fn pipeline of chip_smoke.py (480x272, S=640, D=128,
    # 1,000,000 photons, mono UNet of size 5 in float32): its trace stage
    # alone, then whole frames.
    _, _, _, pfields, _, frame = smoke.make_pipeline()
    pgen = torch.Generator(device="cuda").manual_seed(0)
    psrc = rbt.zero_sources(pfields)

    def pipeline_traces():
        for _ in range(3):
            frame.stages["trace"](psrc, pgen)

    def pipeline_frames():
        for i in range(2):
            frame(psrc, float(i + 1), pgen)

    print(json.dumps({"pipeline_profile": [
        profile_window("3 pipeline trace stages", pipeline_traces),
        profile_window("2 pipeline frames", pipeline_frames)]}))
    del pfields, psrc, frame
    torch.cuda.empty_cache()

    # The shipped frame: 8 frames, then its single-pass display alone on the
    # last frame's pair mean.
    _, rgb, _, weights32, make = smoke.make_production()
    weights = realtime.display_weights(weights32)
    init_state, step = make(weights)
    state = init_state()
    rgen = torch.Generator(device="cuda").manual_seed(7)
    for _ in range(9):
        step(state, rgen)
    with torch.device("meta"):
        net = LitboxDenoiserNet(**realtime.SHIPPED_NET)
    hdr = to_hdr(state.cache.sum(1).mean(0), float(state.frame), rgb)

    def production_frames():
        for _ in range(8):
            step(state, rgen)

    def displays():
        for _ in range(8):
            denoise_hdr(net, weights, hdr, realtime.SHIPPED_TRANSFORM)

    print(json.dumps({"production_profile": [
        profile_window("8 shipped frames", production_frames),
        profile_window("8 single-pass displays", displays)]}))
    del state, weights, weights32
    torch.cuda.empty_cache()
    print(json.dumps({"train_profile": train_profile()}))


CONV_KEYS = ("conv", "gemm", "winograd", "fft", "cudnn")


def train_profile() -> list:
    """3 steps of each training recipe under torch.profiler, after 2 warm
    steps, TF32 off; each window with its convolution kernels' share."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    mono = train.Trainer(train.TrainConfig())
    x = torch.rand((4, 256, 256, 1), generator=gen, device="cuda")
    y = x * 0.9

    def mono_steps(n=3):
        for _ in range(n):
            mono.train_batch_async(x, y)

    mono_steps(2)
    out = [profile_window("3 mono steps (TrainConfig(), batch 4, 256^2)", mono_steps)]
    del mono
    torch.cuda.empty_cache()
    cfg = smoke._r5_config(smoke.TRAIN_STEPS)
    stage = tuple(torch.rand((8, 256, 256, 3), generator=gen, device="cuda") for _ in range(3))
    stages = DeviceStages({"Final": stage})
    pair = train.Trainer(cfg)

    def pair_steps(n=3):
        for _ in range(n):
            a, b, ref = stages.sample_pair("Final", gen, cfg.batch_size, cfg.crop_size, True,
                                           identity_p=0.15)
            pair.train_batch_pair_async(a, b, ref)

    pair_steps(2)
    out.append(profile_window("3 pair steps (round-5 recipe, 2 x 16 crops of 192^2)",
                              pair_steps))
    for window in out:
        window["convolution_share_of_device"] = (window["convolution_device_ms"]
                                                 / window["device_busy_ms"])
    return out


def profile_window(label: str, body, trace_path: str | None = None) -> dict:
    """torch.profiler over body(): wall time, summed kernel time (one stream,
    so kernels do not overlap), the busy share, the convolution kernels'
    time (names with CONV_KEYS) and the top 15 kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        body()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Device-side events only: the aten ops' own rows repeat their kernels' time.
    kernels = [(evt.self_device_time_total, evt.key, evt.count)
               for evt in prof.key_averages()
               if evt.device_type == torch.autograd.DeviceType.CUDA
               and evt.self_device_time_total > 0]
    kernels.sort(reverse=True)
    busy_us = sum(k[0] for k in kernels)
    if trace_path:
        prof.export_chrome_trace(trace_path)
    conv_us = sum(k[0] for k in kernels if any(c in k[1].lower() for c in CONV_KEYS))
    return {"window": label, "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "convolution_device_ms": conv_us / 1e3,
            "device_busy_share": busy_us / wall_us,
            "kernel_launches": sum(k[2] for k in kernels),
            "top_kernels": [dict(name=k[1][:90], device_ms=k[0] / 1e3, calls=k[2])
                            for k in kernels[:15]]}


if __name__ == "__main__":
    main()
