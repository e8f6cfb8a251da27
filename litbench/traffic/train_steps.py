"""Traffic: denoiser training steps in a closed loop, as Trainer.fit runs
them: DenoiserDataset.batches over a corpus of EXR files (random crop and
quarter turn, shuffled each epoch), Trainer.select_random_channel, then
Trainer.train_batch, which reads the loss each step.

Parameters (the workload file's "params"):
  scenes, size     the corpus: `scenes` scenes of size x size, five images
                   each (input A, input B, albedo, transmissibility,
                   reference), made on the card from the seed and written
                   as EXRs under TMPDIR (removed at exit)
  checked_steps    the first steps, run in set-up through the window's own
                   feed and call, and followed by the reference; their items
                   and the window's last batch are found in the corpus
  profile_steps    steps profiled after the window in a traced run
  limits           the limit of each compared number

The end-to-end metric: train_crops_per_s, the crops trained (batch size x
steps completed) over the window's wall time.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from litbench import core, profiling, yardstick
from litbench.reference import train as ref
from litbench.reference import unet

IMAGES = ("input_a", "input_b", "albedo", "transmissibility", "reference")


def make_corpus(seed: int, scenes: int, size: int, device: str) -> dict:
    """{image: (scenes, size, size, 3) float32 numpy}: smooth log-normal
    radiance for the reference, the two noisy inputs around it, albedo and
    transmissibility in (0, 1), drawn on `device` from `seed`."""
    g = torch.Generator(device=device).manual_seed(seed)
    coarse = torch.randn((scenes * 4, 3, size // 8, size // 8), generator=g, device=device)
    smooth = F.interpolate(coarse, size=(size, size), mode="bicubic", align_corners=False)
    smooth = smooth.reshape(scenes, 4, 3, size, size).permute(1, 0, 3, 4, 2)
    noise = torch.randn((2, scenes, size, size, 3), generator=g, device=device)
    reference = torch.exp(1.5 * smooth[0])
    out = {"reference": reference,
           "input_a": reference * torch.exp(0.7 * noise[0] - 0.245),
           "input_b": reference * torch.exp(0.7 * noise[1] - 0.245),
           "albedo": torch.sigmoid(smooth[1]),
           "transmissibility": torch.sigmoid(smooth[2] + smooth[3])}
    return {k: v.float().cpu().numpy() for k, v in out.items()}


def write_corpus(corpus: dict, root: str) -> dict:
    """One uncompressed float EXR per image and scene (no zlib on the host in
    set-up); returns {image: [paths]}."""
    from litbox_tpu_torch.io.exr import write_exr_rgb

    paths = {k: [] for k in IMAGES}
    for k in IMAGES:
        for i, img in enumerate(corpus[k]):
            path = os.path.join(root, f"{k}_{i:03d}.exr")
            write_exr_rgb(path, img, compression="none")
            paths[k].append(path)
    return paths


def train_config(cfg: dict, seed: int):
    from litbox_tpu_torch.nn.loss import HdrLossConfig
    from litbox_tpu_torch.nn.train import TrainConfig
    from litbox_tpu_torch.nn.unet import TransformConfig

    keys = ("unet_size", "initial_features", "padding_mode", "use_sigmoid",
            "global_residual", "learn_rate", "weight_decay", "grad_clip", "batch_size",
            "crop_size", "rgb")
    tc = TrainConfig(**{k: cfg[k] for k in keys}, seed=seed % 2 ** 63,
                     loss=HdrLossConfig(**cfg["loss"]),
                     transform=TransformConfig(**cfg["transform"]))
    if tc.lr_decay_steps or tc.pair_composition or tc.rgb:
        raise ValueError("the cell runs the mono recipe at a constant learning rate")
    return tc


def run(cfg: dict, params: dict, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda", control: bool = False) -> dict:
    from litbox_tpu_torch.nn.dataset import DenoiserDataset

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tc = train_config(cfg, seed)
    root = tempfile.mkdtemp(prefix="litbench-corpus-")
    phases = {"imports": time.perf_counter() - t0}
    try:
        corpus = make_corpus(seed, params["scenes"], params["size"], device)
        paths = write_corpus(corpus, root)
        phases["corpus"] = time.perf_counter() - t0
        dataset = DenoiserDataset(paths["input_a"], paths["input_b"], paths["albedo"],
                                  paths["transmissibility"], paths["reference"],
                                  crop_size=tc.crop_size)
        out = _steps(cfg, params, tc, dataset, seed, seconds, trace, t0, device, phases)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    trainer, init, checked = out.pop("trainer"), out.pop("init"), out.pop("checked")
    del trainer
    if device == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = compare(checked, init, corpus, cfg, params["limits"], control)
    return out


def _steps(cfg, params, tc, dataset, seed, seconds, trace, t0, device, phases) -> dict:
    from litbox_tpu_torch.nn.train import Trainer

    trainer = Trainer(tc, device=device)
    init = unet.draw(cfg["net"], torch.Generator(device=device).manual_seed(seed), device)
    with torch.no_grad():
        for k, v in trainer.model.state_dict().items():
            v.copy_(init[k])
    rng = np.random.default_rng(seed)
    phases["trainer"] = time.perf_counter() - t0

    def feed():
        while True:
            yield from dataset.batches(tc.batch_size, rng, shuffle=True)

    batches = feed()

    def one_step():
        h0 = time.perf_counter()
        inputs, targets = Trainer.select_random_channel(next(batches), rng, device)
        h1 = time.perf_counter()
        return trainer.train_batch(inputs, targets), inputs, targets, (h1 - h0) * 1e3

    # Set-up: the first steps through the window's own feed and call, kept
    # for the check; the first epoch fills the dataset's image cache.
    checked = {"losses": [], "batches": []}
    for s in range(params["checked_steps"]):
        loss, inputs, targets, _ = one_step()
        checked["losses"].append(loss)
        checked["batches"].append((inputs.clone(), targets.clone()))
        if s == 0:
            # Adam's first moment after one step is 0.1 x the gradient it got.
            checked["first_grad"] = {k: m / 0.1 for k, m in trainer.optimizer.state["mu"].items()}
    checked["delta"] = {k: (p.detach() - init[k]) for k, p in trainer.params.items()}
    core.synchronize(device)

    t_start = time.perf_counter()
    setup_s = t_start - t0
    steps = failed = 0
    data_ms = []
    while True:
        loss, inputs, targets, ms = one_step()
        data_ms.append(ms)
        failed += not np.isfinite(loss)
        steps += 1
        if time.perf_counter() - t_start >= seconds:
            break
    core.synchronize(device)
    wall = time.perf_counter() - t_start
    # The window's last batch, fed from the dataset's image cache, is checked
    # against the corpus too.
    checked["window_batch"] = (inputs, targets)
    out = {"e2e": {"setup_s": setup_s, "train_crops_per_s": steps * tc.batch_size / wall},
           "attempted": steps, "failed": failed, "trace": None,
           "setup_phases": dict(phases, first_steps=setup_s),
           "window": {"steps": steps, "step_ms": 1e3 * wall / steps,
                      "data_ms": sorted(data_ms)[len(data_ms) // 2]}}
    if trace:
        ranges = profiling.Ranges()

        def body():
            for _ in range(params["profile_steps"]):
                ranges.enter("data")
                inputs, targets = Trainer.select_random_channel(next(batches), rng, device)
                ranges.enter("step")
                trainer.train_batch(inputs, targets)
            ranges.close()

        summary = profiling.profile(body)
        out["trace"] = {"steps": steps, "step_s": wall / steps, "data_ms": data_ms,
                        "step_flop": 3 * yardstick.unet_flop(cfg["net"], tc.batch_size,
                                                             tc.crop_size, tc.crop_size),
                        "profile": summary}
        out.update(busy_s=summary["busy_s"], window_s=summary["window_s"],
                   breakdown={"device_ops": summary["device_ops"],
                              "idle_gaps": summary["idle_gaps"]})
    out["memory_peak_bytes"] = core.peak_memory(device)
    out.update(trainer=trainer, init=init, checked=checked)
    return out


def _find(x: torch.Tensor, images: torch.Tensor) -> tuple | None:
    """(scene, quarter turns, channel) of the corpus image that `x` (H, W)
    is, or None."""
    for i in range(images.shape[0]):
        for k in range(4):
            for c in range(3):
                if torch.equal(torch.rot90(images[i, :, :, c], k, dims=(0, 1)), x):
                    return i, k, c
    return None


def rederive(batches: list, corpus: dict) -> tuple[list, int]:
    """Each checked item found again in the benchmark's own corpus: some
    scene's input A and reference, turned by k quarter turns, channel c.
    Returns the batches rebuilt from the corpus (an item that matches
    nothing is kept as the program made it) and how many items did not
    match."""
    a, r = torch.from_numpy(corpus["input_a"]), torch.from_numpy(corpus["reference"])
    out, missing = [], 0
    for inputs, targets in batches:
        xs, ys = [], []
        for x, y in zip(inputs.cpu(), targets.cpu()):
            hit = _find(x[..., 0], a)
            if hit is not None:
                i, k, c = hit
                x = torch.rot90(a[i, :, :, c], k, dims=(0, 1))[..., None]
                yr = torch.rot90(r[i, :, :, c], k, dims=(0, 1))[..., None]
                hit = hit if torch.equal(yr, y) else None
                y = yr
            missing += hit is None
            xs.append(x)
            ys.append(y)
        out.append((torch.stack(xs).to(inputs.device), torch.stack(ys).to(inputs.device)))
    return out, missing


def compare(checked: dict, init: dict, corpus: dict, cfg: dict, limits: dict,
            control: bool = False) -> dict:
    """The first steps' losses, first gradient and parameter change against
    the reference's steps on the same batches from the same parameters; the
    items of those steps and of the window's last found in the corpus."""
    batches, missing = rederive(checked["batches"], corpus)
    missing += rederive([checked["window_batch"]], corpus)[1]
    want = ref.train(init, batches, cfg, "reference")
    got = ref.train(init, batches, cfg, "control") if control else checked
    keep = ref.moving_leaves(want["first_grad"])
    readings = {
        "loss_gap": max(abs(g - w) / abs(w) for g, w in zip(got["losses"], want["losses"])),
        "grad_gap": ref.worst_leaf(got["first_grad"], want["first_grad"]),
        "update_gap": ref.worst_leaf(got["delta"], want["delta"], keep),
        "feed_violations": missing,
    }
    return {k: core.check(v, limits[k]) for k, v in readings.items()}
