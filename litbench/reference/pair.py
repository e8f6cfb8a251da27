"""The round-5 display net's training step written out in plain PyTorch, for
the check of the unet4-rgb-pair-train cell (runs/train_denoiser_r5.py:95-128
and :232-241, the TrainConfig saved in runs/denoiser_r5/model_best.npz.json):

- a plain sampler: (a, b, ref) of explicit draws, an item at a time, by
  slicing the crop, `torch.rot90`, the tracer swap and the identity flag;
- the log-space transform with input normalisation around the UNet
  (litbench/reference/unet.Net in training mode);
- the HDR loss with the recipe's terms: log1p compression, weights
  normalised by their batch mean, the relative L2 and the log L1;
- the composition loss: both tracers through the net as one batch, the
  display x + k * dbar with k the per-crop cross-projection, computed
  without gradient and clamped to [0, 1], plus the raw pair-mean term;
- the learning rate, a linear warm-up and a cosine of the update count;
- the global-norm clip, the coupled decay and Adam, as optax chains them.

|x| has the slope 1 at 0, as jnp.abs has in the recipe (torch.abs has 0):
an identity pair's output lies within rounding of its target at some
pixels, and the loss's gradient there depends on that slope.

Departures from the port's arithmetic, none of which the comparison can
resolve at the cell's limits:
- The maxima against a constant are torch.clamp (the whole gradient at a
  tie; the port's halve it, as jnp.maximum does). Ties need a target of 0
  or a prediction of exactly -0.5 or 0, and the targets are positive and
  the predictions 2^y - 1e-6.
- log2 is torch.log2 and 2^x torch.exp2; the port rounds as the JAX
  package does, log(x) / log(2) and exp(x * log(2)): an ulp apart.
- The learning rate is computed in float64 on the host; the port's in
  float32 on the card: 1e-7 of it apart.
- Adam is written out over each tensor; the port's update kernel rounds
  each operation of the chain alone, in its own order.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from litbench.reference import train as ref_train
from litbench.reference import unet

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def sample_pair(data_a, data_b, data_ref, draws, crop: int, rgb: bool = True) -> tuple:
    """(a, b, ref), (batch, crop, crop, 3) or with rgb false the drawn
    channel, from stage tensors (N, H, W, 3) and explicit draws (an object
    with (batch,) tensors idx, top, left, rot, swap, flag, chan): each item's
    crop at (top, left) of scene idx, turned by rot quarter turns
    (torch.rot90 over (H, W)), the tracers swapped where drawn, and both
    replaced by the reference where `flag` (identity) is set."""
    fields = (draws.idx, draws.top, draws.left, draws.rot, draws.swap, draws.flag, draws.chan)
    out = ([], [], [])
    for i, top, left, k, swap, identity, c in zip(*(t.tolist() for t in fields)):
        crops = [torch.rot90(x[i, top:top + crop, left:left + crop], k, dims=(0, 1))
                 for x in (data_a, data_b, data_ref)]
        if not rgb:
            crops = [x[..., c:c + 1] for x in crops]
        a, b, r = crops
        if swap:
            a, b = b, a
        if identity:
            a, b = r, r
        for items, x in zip(out, (a, b, r)):
            items.append(x)
    return tuple(torch.stack(items) for items in out)


def pre_transform(x: torch.Tensor, eps: float) -> tuple:
    """log2(x + eps), then each image normalised by its mean and standard
    deviation over (H, W); returns the result and (mean, std)."""
    x = torch.log2(x + eps)
    mean = x.mean(dim=(1, 2), keepdim=True)
    std = x.var(dim=(1, 2), keepdim=True, correction=0).sqrt()
    return (x - mean) / (std + eps), (mean, std)


def post_transform(y: torch.Tensor, stats: tuple, eps: float) -> torch.Tensor:
    mean, std = stats
    return torch.exp2(torch.clamp(y * (std + eps) + mean, -40.0, 40.0)) - eps


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with the slope 1 at 0."""
    return torch.where(x >= 0, x, -x)


def _sobel(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    c = x.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), k.expand(c, 1, 3, 3), padding=1, groups=c)
    return y.permute(0, 2, 3, 1)


def hdr_loss(pred, target, alpha=1.5, beta=0.4, gamma=0.2, base_weight=0.5, weight_cap=None,
             normalize_weights=False, log_l1=0.0, log_eps=1e-5, compress="none", rel_l2=0.0,
             rel_eps=1.0) -> torch.Tensor:
    """The HDR loss (litbox_loss.py:8-75) with the round-5 terms, NHWC:
    adaptive-weighted L2 + beta Sobel-gradient L1 + gamma L1, on
    log2(1 + x) under compress "log1p"; then rel_l2 times the mean squared
    error relative to target + rel_eps, and log_l1 times the mean L1 of
    log2(x + log_eps), both on the uncompressed values."""
    raw_pred, raw_target = pred, target
    if compress == "log1p":
        pred = torch.log2(1.0 + torch.clamp(pred, min=-0.5))
        target = torch.log2(1.0 + torch.clamp(target, min=0.0))
    elif compress != "none":
        raise ValueError(f"compress {compress!r}")
    weights = (target + base_weight) ** alpha
    if weight_cap is not None:
        weights = torch.clamp(weights, max=weight_cap)
    if normalize_weights:
        weights = weights / torch.clamp(weights.mean(), min=1e-12).detach()
    sx = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]],
                      device=pred.device)
    loss = (torch.mean(weights * (pred - target) ** 2)
            + beta * sum(torch.mean(_abs(_sobel(pred, k) - _sobel(target, k)))
                         for k in (sx, sx.T))
            + gamma * torch.mean(_abs(pred - target)))
    if rel_l2:
        rel = (raw_pred - raw_target) / (torch.clamp(raw_target, min=0.0) + rel_eps)
        loss = loss + rel_l2 * torch.mean(rel * rel)
    if log_l1:
        rel = (torch.log2(torch.clamp(raw_pred, min=0.0) + log_eps)
               - torch.log2(torch.clamp(raw_target, min=0.0) + log_eps))
        loss = loss + log_l1 * torch.mean(_abs(rel))
    return loss


def pair_loss(net: unet.Net, p: dict, a, b, ref, cfg: dict) -> torch.Tensor:
    """The composition loss of one batch of pairs (Trainer.pair_loss's
    arithmetic): the display x + k * dbar, k = <d_a - d_b, b - a> / 4 over
    <dbar, dbar> per crop, clamped to [0, 1], with no gradient, scored
    against ref; plus raw_loss_weight times the loss of (out_a + out_b) / 2."""
    eps = cfg["transform"]["epsilon"]
    nb = a.shape[0]
    x, stats = pre_transform(torch.cat([a, b]), eps)
    pred = post_transform(net(p, x, train=True), stats, eps)
    out_a, out_b = pred[:nb], pred[nb:]
    d_a, d_b = out_a - a, out_b - b
    dbar = (d_a + d_b) * 0.5
    with torch.no_grad():
        num = ((d_a - d_b) * (b - a)).sum(dim=(1, 2, 3)) * 0.25
        den = (dbar * dbar).sum(dim=(1, 2, 3))
        k = torch.clamp(num / torch.clamp(den, min=1e-12), 0.0, 1.0)
    loss = hdr_loss((a + b) * 0.5 + k[:, None, None, None] * dbar, ref, **cfg["loss"])
    if cfg["raw_loss_weight"]:
        loss = loss + cfg["raw_loss_weight"] * hdr_loss((out_a + out_b) * 0.5, ref,
                                                        **cfg["loss"])
    return loss


def learning_rate(count: int, cfg: dict) -> float:
    """The learning rate of update `count` (the first is 0): learn_rate
    without lr_decay_steps; else a linear warm-up from a tenth of learn_rate
    over warmup_steps, then a cosine down to lr_min at lr_decay_steps, flat
    after (optax.warmup_cosine_decay_schedule)."""
    peak = cfg["learn_rate"]
    if not cfg.get("lr_decay_steps"):
        return peak
    warm, decay = cfg["warmup_steps"], cfg["lr_decay_steps"] - cfg["warmup_steps"]
    if count < warm:
        return peak * 0.1 + (peak - peak * 0.1) * count / warm
    cosine = 0.5 * (1.0 + math.cos(math.pi * min(count - warm, decay) / decay))
    alpha = cfg["lr_min"] / peak
    return peak * ((1.0 - alpha) * cosine + alpha)


@torch.no_grad()
def update(leaves: list, state: dict, count: int, cfg: dict) -> None:
    """One update of the leaves from their .grad, in place: the global-norm
    clip (scaled by grad_clip / norm where the norm reaches grad_clip), plus
    weight_decay times the parameter, then Adam at learning_rate(count)."""
    grads = [x.grad for x in leaves]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    if cfg["grad_clip"] and norm >= cfg["grad_clip"]:
        grads = [g * (cfg["grad_clip"] / norm) for g in grads]
    t = count + 1
    lr = learning_rate(count, cfg)
    for x, g in zip(leaves, grads):
        g = g + cfg["weight_decay"] * x
        m, v = state.setdefault(id(x), (torch.zeros_like(x), torch.zeros_like(x)))
        m.mul_(BETA1).add_((1.0 - BETA1) * g)
        v.mul_(BETA2).add_((1.0 - BETA2) * g * g)
        m_hat, v_hat = m / (1.0 - BETA1 ** t), v / (1.0 - BETA2 ** t)
        x.sub_(lr * m_hat / (torch.sqrt(v_hat) + EPS))


def train(init: dict, batches: list, cfg: dict, mode: str = "reference") -> dict:
    """Run len(batches) steps of (a, b, ref) from the parameters `init` (a
    state_dict, not modified), in `mode` (reference.train.precision).
    Returns the losses, each leaf's first gradient as Adam gets it (clipped
    and decayed: its first moment after one step over 1 - beta1) and each
    leaf's change after the last step."""
    if not (cfg["transform"]["use_log_space"] and cfg["transform"]["normalize_input"]):
        raise ValueError("the reference runs the recipe's log-space, normalised transform")
    arch = cfg["net"]
    net = unet.Net(arch)
    names = [k for k, _, kind in unet.layout(**arch) if kind in ref_train.TRAINABLE]
    p = {k: v.detach().clone() for k, v in init.items()}
    leaves = [p[k].requires_grad_() for k in names]
    state: dict = {}
    losses, first = [], None
    with ref_train.precision(mode):
        for count, (a, b, ref) in enumerate(batches):
            for x in leaves:
                x.grad = None
            loss = pair_loss(net, p, a, b, ref, cfg)
            loss.backward()
            update(leaves, state, count, cfg)
            losses.append(float(loss.detach()))
            if first is None:
                first = {k: state[id(x)][0] / (1.0 - BETA1) for k, x in zip(names, leaves)}
    delta = {k: (p[k] - init[k]).detach() for k in names}
    return {"losses": losses, "first_grad": first, "delta": delta}
