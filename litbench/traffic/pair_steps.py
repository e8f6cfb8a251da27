"""Traffic: the round-5 display net's training loop
(runs/train_denoiser_r5.py:232-241), closed: the stages live on the card
as DeviceStages, a stage is drawn for each block of steps, each step draws
its batch of pairs there (DeviceStages.sample_pair) and runs
Trainer.train_batch_pair_async, and the loss is read once a block.
Nothing goes through the host.

Parameters (the workload file's "params"):
  stages           the stages' names
  scenes, size     each stage holds `scenes` scenes of size x size RGB
                   (input A, input B, reference), made on the card from the
                   seed: a smooth log-normal reference scaled to a mean of
                   0.18 (the recipe's scene_scale) and two tracers around
                   it, with a shared smooth error of `common` and a
                   per-pixel one of the stage's `noise` (log units)
  checked_steps    the first steps, run in set-up through the window's own
                   calls (a loss read after each); their batches are kept
                   with the generator's state before each draw
  profile_steps    steps profiled after the window in a traced run
  limits           the limit of each compared number

The configuration gives the net, the loss, the schedule, the batch of pairs
and the crop, identity_p and steps_per_read (a block's steps).

The end-to-end metric: train_crops_per_s, the pairs trained (batch size x
steps completed) over the window's wall time, which ends at the loss read
that closes a block.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from litbench import core, profiling, yardstick
from litbench.reference import pair as ref
from litbench.reference import unet


def make_stages(seed: int, stages: list, scenes: int, size: int, common: float,
                noise: list, device: str) -> dict:
    """{stage: (a, b, ref)} of (scenes, size, size, 3) float32 tensors on
    `device`, drawn from `seed`. The scenes are the same in every stage (as
    the recipe's stages are the same scenes rendered at other budgets), and
    each stage holds its own copy of the references, as the recipe's
    DeviceStages does."""
    g = torch.Generator(device=device).manual_seed(seed)

    def smooth(n):
        coarse = torch.randn((n, 3, size // 8, size // 8), generator=g, device=device)
        return F.interpolate(coarse, size=(size, size), mode="bicubic",
                             align_corners=False).permute(0, 2, 3, 1)

    radiance = torch.exp(1.5 * smooth(scenes))
    radiance = radiance * (0.18 / radiance.mean(dim=(1, 2, 3), keepdim=True))
    out = {}
    for name, sigma in zip(stages, noise):
        bias = common * smooth(scenes)
        tracers = [radiance * torch.exp(bias + sigma * torch.randn(
            radiance.shape, generator=g, device=device) - 0.5 * sigma * sigma)
            for _ in range(2)]
        out[name] = (tracers[0], tracers[1], radiance.clone())
    return out


def train_config(cfg: dict, seed: int):
    from litbox_tpu_torch.nn.loss import HdrLossConfig
    from litbox_tpu_torch.nn.train import TrainConfig
    from litbox_tpu_torch.nn.unet import TransformConfig

    keys = ("unet_size", "initial_features", "padding_mode", "use_sigmoid",
            "global_residual", "learn_rate", "lr_decay_steps", "lr_min", "warmup_steps",
            "weight_decay", "grad_clip", "batch_size", "crop_size", "rgb",
            "pair_composition", "raw_loss_weight")
    tc = TrainConfig(**{k: cfg[k] for k in keys}, seed=seed % 2 ** 63,
                     loss=HdrLossConfig(**cfg["loss"]),
                     transform=TransformConfig(**cfg["transform"]))
    if not (tc.pair_composition and tc.rgb):
        raise ValueError("the cell runs the RGB pair recipe")
    return tc


def run(cfg: dict, params: dict, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda", control: bool = False) -> dict:
    from litbox_tpu_torch.nn.device_data import DeviceStages

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tc = train_config(cfg, seed)
    phases = {"imports": time.perf_counter() - t0}
    stages = DeviceStages(make_stages(seed, params["stages"], params["scenes"], params["size"],
                                      params["common"], params["noise"], device), device)
    core.synchronize(device)
    phases["corpus"] = time.perf_counter() - t0
    out = _steps(cfg, params, tc, stages, seed, seconds, trace, t0, device, phases)
    trainer, init, checked = out.pop("trainer"), out.pop("init"), out.pop("checked")
    del trainer
    if device == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = compare(checked, init, stages.data, cfg, params["limits"], control)
    return out


def _steps(cfg, params, tc, stages, seed, seconds, trace, t0, device, phases) -> dict:
    from litbox_tpu_torch.nn.train import Trainer

    trainer = Trainer(tc, device=device)
    init = unet.draw(cfg["net"], torch.Generator(device=device).manual_seed(seed), device)
    with torch.no_grad():
        for k, v in trainer.model.state_dict().items():
            v.copy_(init[k])
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed((seed + 1) % 2 ** 63)
    phases["trainer"] = time.perf_counter() - t0
    names = params["stages"]

    def stage() -> str:
        return names[int(rng.integers(len(names)))]

    def sample(name: str) -> tuple:
        """A batch of pairs, with the generator's state before its draws."""
        state = gen.get_state()
        return (name, state) + stages.sample_pair(name, gen, tc.batch_size, tc.crop_size,
                                                  True, identity_p=cfg["identity_p"])

    # Set-up: the first block's first steps through the window's own calls,
    # kept for the check.
    checked = {"losses": [], "batches": []}
    name = stage()
    for s in range(params["checked_steps"]):
        batch = sample(name)
        loss = trainer.train_batch_pair_async(*batch[2:])
        checked["losses"].append(float(loss))
        checked["batches"].append(batch[:2] + tuple(x.clone() for x in batch[2:]))
        if s == 0:
            # Adam's first moment after one step is 0.1 x the gradient it got.
            checked["first_grad"] = {k: m / 0.1 for k, m in trainer.optimizer.state["mu"].items()}
    checked["delta"] = {k: (p.detach() - init[k]) for k, p in trainer.params.items()}
    core.synchronize(device)

    t_start = time.perf_counter()
    setup_s = t_start - t0
    steps = failed = reads = 0
    while True:
        name = stage()
        for _ in range(cfg["steps_per_read"]):
            batch = sample(name)
            loss = trainer.train_batch_pair_async(*batch[2:])
        reads += 1
        failed += cfg["steps_per_read"] * (not math.isfinite(float(loss)))
        steps += cfg["steps_per_read"]
        if time.perf_counter() - t_start >= seconds:
            break
    wall = time.perf_counter() - t_start
    checked["window_batch"] = batch
    out = {"e2e": {"setup_s": setup_s, "train_crops_per_s": steps * tc.batch_size / wall},
           "attempted": steps, "failed": failed, "trace": None,
           "setup_phases": dict(phases, first_steps=setup_s),
           "window": {"steps": steps, "loss_reads": reads, "step_ms": 1e3 * wall / steps}}
    if trace:
        ranges = profiling.Ranges()

        def body():
            name = stage()
            for _ in range(params["profile_steps"]):
                ranges.enter("sample")
                batch = sample(name)
                ranges.enter("step")
                trainer.train_batch_pair_async(*batch[2:])
            ranges.close()

        summary = profiling.profile(body)
        out["trace"] = {"steps": steps, "step_s": wall / steps,
                        "step_flop": 3 * yardstick.unet_flop(cfg["net"], 2 * tc.batch_size,
                                                             tc.crop_size, tc.crop_size),
                        "profile": summary}
        out.update(busy_s=summary["busy_s"], window_s=summary["window_s"],
                   breakdown={"device_ops": summary["device_ops"],
                              "idle_gaps": summary["idle_gaps"]})
    out["memory_peak_bytes"] = core.peak_memory(device)
    out.update(trainer=trainer, init=init, checked=checked)
    return out


def rebuild(batches: list, data: dict, cfg: dict) -> tuple[list, int]:
    """Each kept batch rebuilt by the plain sampler from its draws, re-drawn
    by the program's `draw` from the generator's state before them. Returns
    the rebuilt (a, b, ref) batches and how many items the program fed
    otherwise (any of a, b or ref differing in any bit)."""
    from litbox_tpu_torch.nn.device_data import draw

    out, violations = [], 0
    for name, state, *got in batches:
        g = torch.Generator(device=got[0].device)
        g.set_state(state)
        n, crop = got[0].shape[0], got[0].shape[1]
        d = draw(g, data[name][0].shape, n, crop, cfg["identity_p"])
        want = ref.sample_pair(*data[name], d, crop, rgb=True)
        same = torch.ones(n, dtype=torch.bool, device=got[0].device)
        for x, y in zip(got, want):
            same &= (x == y).flatten(1).all(dim=1)
        violations += int((~same).sum())
        out.append(want)
    return out, violations


def distance(got: dict, want: dict) -> float:
    """The distance between two trees of tensors over the size of `want`,
    every leaf of both as one vector, in float64."""
    d2 = sum(float((got[k].double() - w.double()).square().sum()) for k, w in want.items())
    w2 = sum(float(w.double().square().sum()) for w in want.values())
    return (d2 / w2) ** 0.5


def compare(checked: dict, init: dict, data: dict, cfg: dict, limits: dict,
            control: bool = False) -> dict:
    """The checked steps' losses, first gradient and parameter change against
    the reference's steps from the same parameters on the plain sampler's
    batches; the items of those steps and of the window's last batch against
    the plain sampler's, bit for bit.

    The first gradient and the change are each held as one vector
    (`distance`). The leaves' norms one by one (reference.train.worst_leaf)
    spread more on sound runs of this net, whose every leaf moves under the
    coupled decay, and hide a k that passes its gradient: at the cell's
    random weights k is of the order of 1e-3 to 1e-2, and such a k moves
    every leaf a little."""
    batches, violations = rebuild(checked["batches"], data, cfg)
    violations += rebuild([checked["window_batch"]], data, cfg)[1]
    want = ref.train(init, batches, cfg, "reference")
    got = ref.train(init, batches, cfg, "control") if control else checked
    readings = {
        "loss_gap": max(abs(g - w) / abs(w) for g, w in zip(got["losses"], want["losses"])),
        "grad_gap": distance(got["first_grad"], want["first_grad"]),
        "update_gap": distance(got["delta"], want["delta"]),
        "feed_violations": violations,
    }
    return {k: core.check(v, limits[k]) for k, v in readings.items()}
