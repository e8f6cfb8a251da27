"""Where the time of bench.py's frame goes on the card (litbox_tpu_torch).

    python3 chip_profile.py [trace.json]

Uses chip_smoke.py's scene and trace options (bench.py's frame at 256^2,
D=128, 2,000,000 photons, 524,288 bounce chains). Prints two JSON lines:

- "stages": CUDA-event times of the frame's stages, median of 5 after a
  warm-up: the direct stamp histogram, the bounce chains, the injection,
  and the resolve (scan + three shears) with the HDR conversion.
- "profile": torch.profiler over 3 trace frames and one resolve: device
  time by kernel name (top 15), and the device-busy share of the window
  (summed kernel time over the window's wall time; one stream, so kernels
  do not overlap). With a path argument the chrome trace is written there.

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

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            src, _ = rbt.rbt_trace_frame(fields, src, gb, scene.lights,
                                         scene.field_textures, brdf, gen, n, -1, **opts)
        to_hdr(rbt.resolve_raw(fields, src, w, w), 1.0, gb)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Device-side events only: the aten ops' own rows repeat their kernels' time.
    kernels = [(evt.self_device_time_total, evt.key, evt.count)
               for evt in prof.key_averages()
               if evt.device_type == torch.autograd.DeviceType.CUDA
               and evt.self_device_time_total > 0]
    kernels.sort(reverse=True)
    busy_us = sum(k[0] for k in kernels)
    if len(sys.argv) > 1:
        prof.export_chrome_trace(sys.argv[1])
    print(json.dumps({"profile": {
        "window": "3 trace frames + 1 resolve + HDR",
        "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / wall_us,
        "top_kernels": [dict(name=k[1][:90], device_ms=k[0] / 1e3, calls=k[2])
                        for k in kernels[:15]]}}))


if __name__ == "__main__":
    main()
