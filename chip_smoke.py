"""Smoke run of litbox_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from litbox_tpu_torch/csrc (one nvcc call),
holds each kernel against its plain PyTorch version at the shapes of
bench.py's frame and of the realtime 1080p profile, times both, then drives
the main path once: bench.py's scene at 256^2, rotated fields with 128 bins,
10 trace frames of 2,000,000 photons with 524,288 bounce chains, one
resolve and the HDR conversion. It checks the output and that every kernel
was launched by that run. Any failed check raises, so the exit code is not
0. The last line is the device record; the lines before it carry each
phase with its wall seconds, the card's name and power limit, and one JSON
line per phase with its numbers.

Needs one CUDA device, nvcc and nvidia-smi; imports torch, numpy and
litbox_tpu_torch only.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

from litbox_tpu_torch.core import luts
from litbox_tpu_torch.ops import attnscan, cuda_lib, rotate
from litbox_tpu_torch.scene import SceneBuilder, rasterize
from litbox_tpu_torch.sim import rbt
from litbox_tpu_torch.sim.oracle import to_hdr

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores

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
}
COUNTERS = {"attenuation_scan_rows": attnscan.attenuation_scan_rows,
            "shear": rotate.shear, "shear_reduce": rotate.shear_reduce}


def phase(name: str, t0: float, **info) -> None:
    print(f"phase {name} {time.perf_counter() - t0:.3f}s "
          + " ".join(f"{k}={v}" for k, v in info.items()), flush=True)


def time_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median of `reps` CUDA-event timings of fn() after `warmup` calls.
    Every input here is larger than the 50 MB L2 cache, so each call reads
    from device memory."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
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
    out = compare("attenuation_scan_rows", run(), plain())
    cells = d // n_groups * s * s
    b, by = bound(7 * 4 * cells, 10 * cells)
    out.update(shape=f"t({d},{s},{s}) src 3x({tracers * d},{s},{s}) "
                     f"group {group}/{n_groups} src_offset {args['src_offset']}",
               ms=time_ms(run), plain_ms=time_ms(plain), bound_ms=b,
               bound_by=by, library_ms=None)
    return out


def check_shear(gen, n, s) -> dict:
    img = torch.rand((n, s, s), generator=gen, device="cuda")
    coef = (torch.rand((n,), generator=gen, device="cuda") - 0.5) * 1.4
    run = lambda: rotate.shear(img, coef, 1, 1, s)
    plain = lambda: rotate.shear_plain(img, coef, 1, 1, s)
    out = compare("shear", run(), plain())
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
    b, by = bound(2 * 4 * n * s * s, 4 * n * s * s)
    out.update(shape=f"({n},{s},{s})", ms=time_ms(run), plain_ms=time_ms(plain),
               bound_ms=b, bound_by=by, library_ms=time_ms(library),
               library="torch.nn.functional.grid_sample",
               library_max_abs_err=lib_err)
    return out


def check_shear_reduce(gen, n, s, row_lo, row_hi) -> dict:
    img = torch.rand((n, s, s), generator=gen, device="cuda")
    coef = (torch.rand((n,), generator=gen, device="cuda") - 0.5) * 0.9
    args = (1, 1, s, row_lo, row_hi, 3)
    run = lambda: rotate.shear_reduce(img, coef, *args)
    plain = lambda: rotate.shear_reduce_plain(img, coef, *args)
    out = compare("shear_reduce", run(), plain())
    rows = row_hi - row_lo
    b, by = bound(4 * (n * rows * s + 3 * rows * s), 4 * n * rows * s)
    out.update(shape=f"({n},{s},{s}) rows [{row_lo},{row_hi}) groups 3",
               ms=time_ms(run), plain_ms=time_ms(plain), bound_ms=b,
               bound_by=by, library_ms=None)
    return out


def kernels_phase() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    d = N_BINS
    # bench.py's resolve: S=384, 3*D images, rows 64..320. The realtime 1080p
    # profile (core/types.py REALTIME_1080P): S=640, one group of 16 resolved
    # per frame from a two-tracer source, 3*8 images, rows 128..512.
    results = {
        "attenuation_scan_rows": (check_scan(gen, d, 384, 1, 0, 1),
                                  check_scan(gen, d, 640, 16, 3, 2)),
        "shear": (check_shear(gen, 3 * d, 384), check_shear(gen, 3 * d // 16, 640)),
        "shear_reduce": (check_shear_reduce(gen, 3 * d, 384, 64, 320),
                         check_shear_reduce(gen, 3 * d // 16, 640, 128, 512)),
    }
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return results


def build_scene(w: int):
    """bench.py's scene (bench.py:51-66): a point light in a smoothed random
    cloud sprite, made with numpy from seed 0."""
    rng = np.random.default_rng(0)
    cloud = rng.uniform(0.0, 1.0, (128, 128)).astype(np.float32)
    for _ in range(3):
        cloud = (np.roll(cloud, 1, 0) + np.roll(cloud, -1, 0)
                 + np.roll(cloud, 1, 1) + np.roll(cloud, -1, 1) + cloud) / 5.0
    b = SceneBuilder(texture_size=128)
    b.add_point_light((w * 0.5, w * 0.55), radius=4.0, color=(1.0, 0.85, 0.6),
                      intensity=2.0, bounces=2)
    b.add_sprite((w / 2, w / 2), (w / 2, w / 2), color=(1, 1, 1, 1),
                 log_density=-1.0, texture=np.stack([cloud] * 3 + [cloud], -1))
    scene = b.build(max_lights=2, max_shapes=2, device="cuda")
    return scene, rasterize(scene, w, w)


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
    for fn in COUNTERS.values():
        fn.launches = 0
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
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    peak = torch.cuda.max_memory_allocated()

    failures = []
    if any(v == 0 for v in launches.values()):
        failures.append(f"a kernel of the path was not launched: {launches}")
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
    if resolve_err > 1e-4:
        failures.append(f"kernel resolve vs plain: {resolve_err} of max > 1e-4")
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
                resolve_vs_plain_rel_err=resolve_err, resolve_tol=1e-4,
                hdr_mean=float(hdr.mean()))


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

    t0 = time.perf_counter()
    measured = kernels_phase()
    phase("kernels", t0)

    t0 = time.perf_counter()
    frame = frame_phase()
    phase("frame", t0)
    print(json.dumps({"frame": frame}))

    rows = []
    for kname, (bench, realtime) in measured.items():
        rows.append(dict(name=kname, route="cuda", **{
            k: KERNELS[kname][k] for k in ("source", "replaces")},
            launches=frame["launches"][kname], tol=KERNELS[kname]["tol"],
            **bench, realtime=realtime))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
