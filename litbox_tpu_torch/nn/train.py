"""Denoiser training loop (counterpart of the JAX package's nn/train.py;
reference: train_litbox_denoiser.py).

Curriculum stages over input sets, Adam with torch-style (coupled) weight
decay 0.01 and lr 1e-5 (train_litbox_denoiser.py:183-186), per-batch random
channel selection, HdrLoss, and wall-clock checkpointing every
`checkpoint_interval` seconds.

The optimizer is the JAX package's optax chain (`Optimizer`, through
`ops.adam`): the global-norm clip (scale by max_norm / norm only when
norm >= max_norm, no epsilon), the coupled decay g + wd * p on every
parameter, BatchNorm's scale and bias included, then Adam (b1 0.9,
b2 0.999, eps 1e-8, eps_root 0) scaled by the learning rate, constant or
`optax.warmup_cosine_decay_schedule` of the update count (`lr_schedule`).
On a card it is one hand-written kernel (`csrc/adam.cu`), on the CPU the
chain as tensor ops. The clip, the schedule and the Adam step stay on the
device, so `train_batch_async` and `train_batch_pair_async` never wait for
it; `train_batch` and `fit` read the loss each step, as the JAX package's
do.

A step's forward and backward run under `ops.conv.step_convolutions`: on a
card, the port's convolution kernels instead of cuDNN's (see there).

A step is the step span `train.step` (core/spans.py) around `train.forward`,
`train.backward`, `train.optimizer` (with the counter
`train.optimizer_launches`: the update kernel's launches) and, where the
loss is read, `train.loss_read`; inside `train.forward`, `pair_loss`
records `train.compose` around what follows the net (the k projection,
the display and both losses); `select_random_channel` records
`data.channel` (drawing the channels and making them, `Batch.channel`) and
the copy to the device `train.h2d`, with its bytes in `train.h2d_bytes`.

`save` writes the JAX package's npz layout: `params:<flax path>`,
`stats:<flax path>`, the optimizer under optax's paths (`opt:2/0/.count`,
`opt:2/0/.mu/...`, `opt:2/0/.nu/...`, `opt:2/1/.count` with a schedule),
and the TrainConfig as `.json` beside it; either package loads and resumes
the other's checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Any, Callable

import numpy as np
import torch

from .. import convert
from ..core import spans
from ..ops import adam, conv
from .dataset import Batch, DenoiserDataset
from .loss import HdrLossConfig, hdr_loss
from .unet import (LitboxDenoiserNet, TransformConfig, init_weights, post_transform,
                   pre_transform)


@dataclasses.dataclass
class TrainConfig:
    unet_size: int = 5
    initial_features: int = 32
    padding_mode: str = "reflect"
    use_sigmoid: bool = False
    global_residual: bool = False
    learn_rate: float = 1e-5
    # Optional cosine decay: learn_rate -> lr_min over lr_decay_steps, then
    # flat at lr_min (0 = constant lr, the reference behavior).
    lr_decay_steps: int = 0
    lr_min: float = 1e-6
    warmup_steps: int = 0
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    batch_size: int = 4
    epochs: int = 20
    crop_size: int = 256
    checkpoint_interval: float = 900.0
    loss: HdrLossConfig = dataclasses.field(default_factory=HdrLossConfig)
    transform: TransformConfig = dataclasses.field(default_factory=TransformConfig)
    seed: int = 0
    # Train the 3-channel RGB variant (the realtime display net).
    rgb: bool = False
    # Composition-in-the-loss: optimize the production display
    # x + k*(d_a+d_b)/2, k the per-crop cross-projection of
    # blend_pair_symmetric with no gradient through it, against the
    # reference, plus raw_loss_weight times the raw pair-mean output loss.
    pair_composition: bool = False
    raw_loss_weight: float = 0.5


def load_train_config(checkpoint_path: str) -> TrainConfig:
    """Reconstruct the TrainConfig saved next to a checkpoint (the .json
    Trainer.save writes)."""
    path = checkpoint_path
    if not path.endswith(".json"):
        path = (path if path.endswith(".npz") else path + ".npz") + ".json"
    with open(path) as f:
        d = json.load(f)
    d["loss"] = HdrLossConfig(**d.get("loss", {}))
    t = d.get("transform", {})
    d["transform"] = TransformConfig(**{k: v for k, v in t.items()})
    return TrainConfig(**d)


def lr_schedule(cfg: TrainConfig) -> Callable[[torch.Tensor], torch.Tensor] | float:
    """The learning rate: cfg.learn_rate, or with lr_decay_steps the
    function of the update count (an int32 tensor; the first update uses
    count 0) that optax.warmup_cosine_decay_schedule is, in float32 on the
    count's device: a linear warm-up from learn_rate * 0.1 (learn_rate
    without warm-up) to learn_rate over warmup_steps, then a cosine to
    lr_min at lr_decay_steps."""
    if not cfg.lr_decay_steps:
        return cfg.learn_rate
    peak = cfg.learn_rate
    init = peak * 0.1 if cfg.warmup_steps else peak
    warm = cfg.warmup_steps
    decay = cfg.lr_decay_steps - warm
    if not decay > 0:
        raise ValueError(f"the cosine decay needs lr_decay_steps > warmup_steps, got {cfg}")
    alpha = 0.0 if peak == 0.0 else cfg.lr_min / peak

    def schedule(count: torch.Tensor) -> torch.Tensor:
        if warm > 0:
            c = torch.clamp(count, 0, warm)
            linear = (init - peak) * (1 - c / warm) + peak
        else:
            linear = torch.full((), init, dtype=torch.float32, device=count.device)
        c = torch.clamp((count - warm).float(), max=float(decay))
        cosine = 0.5 * (1 + torch.cos(math.pi * c / float(decay)))
        return torch.where(count < warm, linear, peak * ((1 - alpha) * cosine + alpha))

    return schedule


class Optimizer:
    """optax.chain(clip_by_global_norm(grad_clip) or identity,
    add_decayed_weights(weight_decay), adam(lr_schedule(cfg))) over a dict
    of parameter tensors, updated in place by `ops.adam.adam_update`: on a
    card one hand-written kernel in two launches (one with grad_clip 0),
    on the CPU the chain as tensor ops. `state` holds optax's leaves: count,
    mu and nu (scale_by_adam) and, with a schedule, the schedule's own
    count, each an int32 0-d tensor or a dict like the parameters; every
    one is updated in place, never replaced."""

    def __init__(self, params: dict[str, torch.Tensor], cfg: TrainConfig):
        self.params = params
        self.cfg = cfg
        self.lr = lr_schedule(cfg)
        dev = next(iter(params.values())).device
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}  # noqa: E731
        self.state = {"count": torch.zeros((), dtype=torch.int32, device=dev),
                      "mu": zeros(), "nu": zeros()}
        if callable(self.lr):
            self.state["schedule_count"] = torch.zeros((), dtype=torch.int32, device=dev)
        self._tables = adam.Tables()

    @torch.no_grad()
    def step(self, grads: dict[str, torch.Tensor]) -> None:
        """One update from `grads` (a dict like the parameters), with no
        read on the host; the counter `train.optimizer_launches` counts the
        kernel's launches."""
        cfg, st = self.cfg, self.state
        names = list(self.params)
        lr = self.lr(st["schedule_count"]) if callable(self.lr) else self.lr
        before = adam.adam_update.launches
        adam.adam_update(list(self.params.values()), [grads[k] for k in names],
                         [st["mu"][k] for k in names], [st["nu"][k] for k in names],
                         st["count"], lr, cfg.grad_clip, cfg.weight_decay,
                         st.get("schedule_count"), self._tables)
        spans.count("train.optimizer_launches", adam.adam_update.launches - before)


class Trainer:
    """The JAX package's Trainer on `device` ("cuda" unless the caller asks
    for the CPU): the net with Flax's initialization drawn on the device
    from a torch.Generator seeded by cfg.seed, the optimizer, the steps,
    fit, checkpoints and eval_fn."""

    def __init__(self, cfg: TrainConfig, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        net = LitboxDenoiserNet(
            unet_size=cfg.unet_size, initial_features=cfg.initial_features,
            padding_mode=cfg.padding_mode, use_sigmoid=cfg.use_sigmoid,
            global_residual=cfg.global_residual, out_channels=3 if cfg.rgb else 1)
        self.model = net.to(self.device)
        init_weights(net, torch.Generator(device=self.device).manual_seed(cfg.seed))
        self.params = dict(self.model.named_parameters())
        self.optimizer = Optimizer(self.params, cfg)
        self.global_step = 0

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _net(self, x: torch.Tensor) -> torch.Tensor:
        """pre_transform -> the net in training mode -> post_transform."""
        xin, stats = pre_transform(x, self.cfg.transform)
        return post_transform(self.model(xin, train=True), stats, self.cfg.transform)

    def loss(self, inputs, targets) -> torch.Tensor:
        """The mono/RGB step's loss (the running statistics move)."""
        return hdr_loss(self._net(self._tensor(inputs)), self._tensor(targets), self.cfg.loss)

    def pair_loss(self, a, b, ref) -> torch.Tensor:
        """The composition step's loss: both tracers through the net as one
        batch of 2B (BatchNorm sees 2B items), the display x + k*dbar with
        k the per-crop cross-projection, clipped to [0, 1] and not
        differentiated, scored against ref, plus raw_loss_weight times the
        loss of the raw pair-mean output."""
        cfg = self.cfg
        a, b, ref = self._tensor(a), self._tensor(b), self._tensor(ref)
        nb = a.shape[0]
        pred = self._net(torch.cat([a, b]))
        with spans.span("train.compose"):
            out_a, out_b = pred[:nb], pred[nb:]
            d_a, d_b = out_a - a, out_b - b
            dbar = (d_a + d_b) * 0.5
            x = (a + b) * 0.5
            axes = tuple(range(1, a.ndim))
            with torch.no_grad():
                num = ((d_a - d_b) * (b - a)).sum(axes) * 0.25
                den = (dbar * dbar).sum(axes)
                k = torch.clamp(num / torch.clamp(den, min=1e-12), 0.0, 1.0)
            disp = x + k.reshape((-1,) + (1,) * (a.ndim - 1)) * dbar
            loss = hdr_loss(disp, ref, cfg.loss)
            if cfg.raw_loss_weight:
                raw = hdr_loss((out_a + out_b) * 0.5, ref, cfg.loss)
                loss = loss + cfg.raw_loss_weight * raw
        return loss

    def gradients(self, loss_fn: Callable[..., torch.Tensor], *args) -> torch.Tensor:
        """loss_fn(*args) and its backward under conv.step_convolutions, with
        each parameter's gradient in its .grad; returns the loss, detached."""
        for p in self.params.values():
            p.grad = None
        with conv.step_convolutions(self.device):
            with spans.span("train.forward"):
                loss = loss_fn(*args)
            with spans.span("train.backward"):
                loss.backward()
        return loss.detach()

    def _update(self, loss_fn: Callable[..., torch.Tensor], *args) -> torch.Tensor:
        """The gradients, then one optimizer update; the gradients stay in
        each parameter's .grad."""
        loss = self.gradients(loss_fn, *args)
        with spans.span("train.optimizer"):
            self.optimizer.step({k: p.grad for k, p in self.params.items()})
        self.global_step += 1
        return loss

    def _step(self, loss_fn: Callable[..., torch.Tensor], *args) -> torch.Tensor:
        """One step, the span `train.step`, with no host read."""
        with spans.step("train.step"):
            return self._update(loss_fn, *args)

    def train_batch_async(self, inputs, targets) -> torch.Tensor:
        """One step; returns the loss as a 0-d tensor on the device, with no
        host read."""
        return self._step(self.loss, inputs, targets)

    def train_batch_pair_async(self, a, b, ref) -> torch.Tensor:
        """Composition-in-the-loss step (pair_composition=True); returns the
        device loss like train_batch_async."""
        if not self.cfg.pair_composition:
            raise ValueError("train_batch_pair_async needs TrainConfig.pair_composition")
        return self._step(self.pair_loss, a, b, ref)

    def train_batch(self, inputs, targets) -> float:
        """One step and the read of its loss, which waits for the device."""
        with spans.step("train.step"):
            loss = self._update(self.loss, inputs, targets)
            with spans.span("train.loss_read"):
                return float(loss)

    @staticmethod
    def select_random_channel(batch: Batch, rng: np.random.Generator,
                              device: str | torch.device = "cuda"):
        """Same random channel for input and target per item
        (train_litbox_denoiser.py:102-113), as tensors on `device`: the
        batch makes just those channels of input A and the reference."""
        with spans.span("data.channel"):
            c = rng.integers(0, 3, batch.size)
            inputs = batch.channel("input_a", c)
            targets = batch.channel("reference", c)
        with spans.span("train.h2d"):
            out = (torch.as_tensor(inputs, device=device),
                   torch.as_tensor(targets, device=device))
        spans.count("train.h2d_bytes", inputs.nbytes + targets.nbytes)
        return out

    def fit(self, curriculum: list[tuple[str, DenoiserDataset]],
            checkpoint_folder: str | None = None,
            on_checkpoint: Callable[[str], None] | None = None,
            log_every: float = 10.0, max_steps: int | None = None) -> list[dict]:
        """Run the full curriculum; returns the loss log
        (CSV-ish stdout parity: train_litbox_denoiser.py:248-251)."""
        rng = np.random.default_rng(self.cfg.seed)
        start = time.time()
        last_print = start
        last_checkpoint = start
        log = []
        for name, dataset in curriculum:
            for epoch in range(self.cfg.epochs):
                for batch in dataset.batches(self.cfg.batch_size, rng, shuffle=True):
                    if self.cfg.rgb:
                        a, ref = batch["input_a"], batch["reference"]
                        with spans.span("train.h2d"):
                            inputs = self._tensor(a)
                            targets = self._tensor(ref)
                        spans.count("train.h2d_bytes", inputs.nbytes + targets.nbytes)
                    else:
                        inputs, targets = self.select_random_channel(batch, rng, self.device)
                    loss = self.train_batch(inputs, targets)
                    now = time.time()
                    if now - last_print >= log_every:
                        entry = dict(elapsed=now - start, curriculum=name,
                                     epoch=epoch, step=self.global_step, loss=loss)
                        print("{elapsed:.2f},{curriculum},{epoch},{step},{loss:.6f}".format(**entry))
                        log.append(entry)
                        last_print = now
                    if (checkpoint_folder
                            and now - last_checkpoint >= self.cfg.checkpoint_interval):
                        cdir = os.path.join(checkpoint_folder, str(int(now - start)))
                        self.save(os.path.join(cdir, "model.msgpack"))
                        if on_checkpoint:
                            on_checkpoint(cdir)
                        last_checkpoint = time.time()
                    if max_steps is not None and self.global_step >= max_steps:
                        return log
        return log

    # ----- checkpointing: the JAX package's npz of flattened Flax paths -----

    def _arrays(self, include_optimizer: bool) -> dict[str, np.ndarray]:
        arrays = {}
        for prefix, tree in convert.unet_to_flax(self.model.state_dict()).items():
            tag = "params:" if prefix == "params" else "stats:"
            arrays.update({tag + k: v for k, v in _flat(tree).items()})
        if include_optimizer:
            st = self.optimizer.state
            arrays["opt:2/0/.count"] = st["count"].cpu().numpy()
            for moment in ("mu", "nu"):
                for key, value in st[moment].items():
                    _, path, kernel = convert.flax_path(key)
                    arr = value.detach().cpu().numpy()
                    arrays[f"opt:2/0/.{moment}/{path}"] = arr.transpose(2, 3, 1, 0) if kernel else arr
            if "schedule_count" in st:
                arrays["opt:2/1/.count"] = st["schedule_count"].cpu().numpy()
        return arrays

    def save(self, path: str, include_optimizer: bool = True):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savez(path, **self._arrays(include_optimizer))
        with open(path + ".json", "w") as f:
            json.dump(dataclasses.asdict(self.cfg), f, default=str)

    def load(self, path: str):
        """Load a checkpoint of either package; leaves the file lacks keep
        their values (as the JAX package's load does). Each value is copied
        into the tensor that holds it, since the optimizer's kernel keeps the
        tensors' pointers."""
        if not path.endswith(".npz") and os.path.exists(path + ".npz"):
            path = path + ".npz"
        arrays = np.load(path)

        def value(key: str, like: torch.Tensor, kernel: bool) -> torch.Tensor:
            arr = arrays[key]
            if kernel:
                arr = arr.transpose(3, 2, 0, 1)
            return torch.as_tensor(np.array(arr), dtype=like.dtype,
                                   device=like.device).reshape(like.shape)

        with torch.no_grad():
            for key, t in self.model.state_dict().items():
                collection, path_, kernel = convert.flax_path(key)
                tag = {"params": "params:", "batch_stats": "stats:"}.get(collection)
                if tag and tag + path_ in arrays.files:
                    t.copy_(value(tag + path_, t, kernel))
            st = self.optimizer.state
            for key, name in (("opt:2/0/.count", "count"), ("opt:2/1/.count", "schedule_count")):
                if name in st and key in arrays.files:
                    st[name].copy_(value(key, st[name], False))
            for moment in ("mu", "nu"):
                for key, t in st[moment].items():
                    _, path_, kernel = convert.flax_path(key)
                    full = f"opt:2/0/.{moment}/{path_}"
                    if full in arrays.files:
                        t.copy_(value(full, t, kernel))

    def eval_fn(self) -> Callable[[Any], torch.Tensor]:
        """The forward in eval mode: x (numpy or a tensor, NHWC) moves to the
        trainer's device; returns a tensor there."""
        model, cfg = self.model, self.cfg

        @torch.no_grad()
        def run(x):
            xin, stats = pre_transform(self._tensor(x), cfg.transform)
            return post_transform(model(xin, train=False), stats, cfg.transform)

        return run


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out
