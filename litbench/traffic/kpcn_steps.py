"""Traffic: KPCN's training loop on litbox's buffers, closed: the stages live
on the card as DeviceStages with each scene's albedo and transmissibility,
a stage is drawn for each block of steps, each step draws its batch of
patches there (DeviceStages.sample_kpcn) and runs
Trainer.train_batch_kpcn_async (the features, the trunk, the
reconstruction, the L1 and the update), and the loss is read once a block.
Nothing goes through the host.

Parameters (the workload file's "params"):
  stages           the stages' names
  scenes, size     each stage holds `scenes` scenes of size x size RGB
                   (input A, input B, reference), made on the card from the
                   seed as pair_steps.make_stages makes them, with a smooth
                   albedo in [0, 1]^3 and transmissibility in [0, 1] a scene
                   (`make_aux`), shared by the stages
  common, noise    the tracers' shared smooth error and each stage's
                   per-pixel one (log units)
  checked_steps    the first steps, run in set-up through the window's own
                   calls (a loss read after each); their batches are kept
                   with the generator's state before each draw
  profile_steps    steps profiled after the window in a traced run, every
                   device operation kept by name
  limits           the limit of each compared number

The configuration gives the net (layers, features, kernel_size,
recon_kernel, in_channels), the patch (crop_size), the batch, the learning
rate and steps_per_read (a block's steps).

The end-to-end metric: train_crops_per_s, the patches trained (batch size x
steps completed) over the window's wall time, which ends at the loss read
that closes a block.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from litbench import core, profiling, yardstick_kpcn
from litbench.reference import kpcn as ref
from litbench.traffic import pair_steps

# The features of one item and channel agree when they lie within this many
# float32 ulps of the channel's largest magnitude in the item: both sides
# evaluate the same elementwise expressions, an implementation may round
# them in its own order, and a wrong pixel, channel or turn moves a feature
# by far more.
FEATURE_ULPS = 4


def make_aux(seed: int, scenes: int, size: int, device: str) -> tuple:
    """(albedo (scenes, size, size, 3), transmissibility (scenes, size,
    size, 1)), smooth fields in [0, 1] drawn from `seed` on `device`."""
    g = torch.Generator(device=device).manual_seed((seed + 2) % 2 ** 63)

    def smooth(c):
        coarse = torch.randn((scenes, c, size // 8, size // 8), generator=g, device=device)
        return F.interpolate(coarse, size=(size, size), mode="bicubic",
                             align_corners=False).permute(0, 2, 3, 1).contiguous()

    return torch.sigmoid(1.5 * smooth(3)), torch.sigmoid(2.0 * smooth(1))


def train_config(cfg: dict, seed: int):
    from litbox_tpu_torch.nn import kpcn
    from litbox_tpu_torch.nn.train import TrainConfig

    if cfg["in_channels"] != kpcn.IN_CHANNELS:
        raise ValueError(f"the port's features have {kpcn.IN_CHANNELS} channels, "
                         f"the configuration {cfg['in_channels']}")
    net = kpcn.KpcnConfig(layers=cfg["layers"], features=cfg["features"],
                          kernel=cfg["kernel_size"], recon=cfg["recon_kernel"])
    return TrainConfig(learn_rate=cfg["learn_rate"], weight_decay=cfg["weight_decay"],
                       grad_clip=cfg["grad_clip"], batch_size=cfg["batch_size"],
                       crop_size=cfg["crop_size"], seed=seed % 2 ** 63, kpcn=net)


def run(cfg: dict, params: dict, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda", control: bool = False) -> dict:
    from litbox_tpu_torch.nn.device_data import DeviceStages

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tc = train_config(cfg, seed)  # a checkout from before KPCN raises here, before any work
    phases = {"imports": time.perf_counter() - t0}
    tracers = pair_steps.make_stages(seed, params["stages"], params["scenes"], params["size"],
                                     params["common"], params["noise"], device)
    albedo, trans = make_aux(seed, params["scenes"], params["size"], device)
    stages = DeviceStages({name: (a, b, r, albedo, trans) for name, (a, b, r) in tracers.items()},
                          device)
    del tracers
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
    init = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed((seed + 1) % 2 ** 63)
    phases["trainer"] = time.perf_counter() - t0
    names = params["stages"]

    def stage() -> str:
        return names[int(rng.integers(len(names)))]

    def sample(name: str) -> tuple:
        """A batch, with the generator's state before its draws."""
        state = gen.get_state()
        return (name, state) + stages.sample_kpcn(name, gen, tc.batch_size, tc.crop_size)

    # Set-up: the first block's first steps through the window's own calls,
    # kept for the check.
    checked = {"losses": [], "batches": []}
    name = stage()
    for s in range(params["checked_steps"]):
        batch = sample(name)
        loss = trainer.train_batch_kpcn_async(*batch[2:])
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
            loss = trainer.train_batch_kpcn_async(*batch[2:])
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
                trainer.train_batch_kpcn_async(*batch[2:])
            ranges.close()

        # Every device operation by name: the per-layer readers sum kernels
        # that a top ten would cut.
        summary = profiling.profile(body, top=100_000)
        shape = (tc.batch_size, tc.crop_size, tc.crop_size)
        out["trace"] = {"steps": steps, "step_s": wall / steps,
                        "step_flop": yardstick_kpcn.step_flop(cfg, *shape),
                        "conv_flop": yardstick_kpcn.launched_flop(cfg, *shape),
                        "kpn_bytes": yardstick_kpcn.kpn_bytes(cfg, *shape),
                        "profile_steps": params["profile_steps"], "profile": summary}
        out.update(busy_s=summary["busy_s"], window_s=summary["window_s"],
                   breakdown={"device_ops": summary["device_ops"][:10],
                              "idle_gaps": summary["idle_gaps"][:10]})
    out["memory_peak_bytes"] = core.peak_memory(device)
    out.update(trainer=trainer, init=init, checked=checked)
    return out


def rebuild(batches: list, data: dict) -> tuple[list, int]:
    """Each kept batch rebuilt by the plain sampler from its draws, re-drawn
    by the program's `draw` from the generator's state before them; the
    items the program fed otherwise (a buffer differing in any bit, or a
    feature the program builds from its batch further than FEATURE_ULPS
    from the reference's from the rebuilt one) are counted."""
    from litbox_tpu_torch.nn import kpcn
    from litbox_tpu_torch.nn.device_data import draw

    out, violations = [], 0
    for name, state, *got in batches:
        g = torch.Generator(device=got[0].device)
        g.set_state(state)
        n, crop = got[0].shape[0], got[0].shape[1]
        want = ref.sample(data[name], draw(g, data[name][0].shape, n, crop, 0.0), crop)
        bad = torch.zeros(n, dtype=torch.bool, device=got[0].device)
        for x, y in zip(got, want):
            bad |= ~(x == y).flatten(1).all(dim=1)
        feats, wanted = kpcn.features(*got[:4])[0], ref.features(*want[:4])[0]
        scale = wanted.abs().amax(dim=(2, 3))
        gap = (feats - wanted).abs().amax(dim=(2, 3))
        bad |= (gap > FEATURE_ULPS * torch.finfo(torch.float32).eps * scale).any(dim=1)
        violations += int(bad.sum())
        out.append(want)
    return out, violations


def compare(checked: dict, init: dict, data: dict, cfg: dict, limits: dict,
            control: bool = False) -> dict:
    """The checked steps' losses, first gradient and parameter change against
    the reference's steps from the same parameters on the plain sampler's
    batches, each of the last two as one vector (pair_steps.distance); the
    items of those steps and of the window's last batch, and their
    features, against the plain sampler's and the reference's."""
    batches, violations = rebuild(checked["batches"], data)
    violations += rebuild([checked["window_batch"]], data)[1]
    want = ref.train(init, batches, cfg, "reference")
    got = ref.train(init, batches, cfg, "control") if control else checked
    readings = {
        "loss_gap": max(abs(g - w) / abs(w) for g, w in zip(got["losses"], want["losses"])),
        "grad_gap": pair_steps.distance(got["first_grad"], want["first_grad"]),
        "update_gap": pair_steps.distance(got["delta"], want["delta"]),
        "feed_violations": violations,
    }
    return {k: core.check(v, limits[k]) for k, v in readings.items()}
