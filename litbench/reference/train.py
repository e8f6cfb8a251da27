"""The denoiser's training step written out in plain PyTorch, for the check
of the unet5-train cell: the UNet forward in training mode (BatchNorm on
the batch's moments), the HDR loss (litbox_loss.py:8-75 with the
production coefficients, train_litbox_denoiser.py:44-47), its gradients,
the global-norm clip and torch.optim.Adam with its coupled weight decay
(train_litbox_denoiser.py:183-186).

precision "reference": float32 with TF32 off and PyTorch's own convolution
kernels (cuDNN's float32 gradients stray up to 1e-3 of their maximum from
float64 on an H100, PyTorch's 1e-5). precision "control": float32 with TF32
on, through cuDNN: the step below the configuration's float32.
"""

from __future__ import annotations

import contextlib
import statistics

import torch
import torch.nn.functional as F

from litbench.reference import unet

TRAINABLE = ("conv_weight", "conv_bias", "bn_weight", "bn_bias")


def hdr_loss(pred, target, alpha=1.5, beta=0.4, gamma=0.2, base_weight=0.5):
    """Adaptive-weighted L2 + Sobel gradient L1 + plain L1, NHWC."""
    weights = (target + base_weight) ** alpha
    l2 = torch.mean(weights * (pred - target) ** 2)
    sx = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]],
                      device=pred.device)

    def sobel(x, k):
        c = x.shape[-1]
        y = F.conv2d(x.permute(0, 3, 1, 2), k.expand(c, 1, 3, 3), padding=1, groups=c)
        return y.permute(0, 2, 3, 1)

    grad = sum(torch.mean((sobel(pred, k) - sobel(target, k)).abs()) for k in (sx, sx.T))
    return l2 + beta * grad + gamma * torch.mean((pred - target).abs())


@contextlib.contextmanager
def precision(mode: str):
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.enabled)
    tf32 = mode == "control"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cudnn.enabled = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.enabled) = saved


def train(init: dict, batches: list, cfg: dict, mode: str = "reference") -> dict:
    """Run len(batches) steps from the parameters `init` (a state_dict, not
    modified). Returns the losses, each leaf's first gradient as Adam gets
    it (its first moment after one step over 1 - beta1) and each leaf's
    change after the last step."""
    arch = cfg["net"]
    net = unet.Net(arch)
    names = [k for k, _, kind in unet.layout(**arch) if kind in TRAINABLE]
    p = {k: v.detach().clone() for k, v in init.items()}
    leaves = [p[k].requires_grad_() for k in names]
    opt = torch.optim.Adam(leaves, lr=cfg["learn_rate"], betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=cfg["weight_decay"], foreach=False)
    losses, first = [], None
    with precision(mode):
        for inputs, targets in batches:
            opt.zero_grad(set_to_none=True)
            loss = hdr_loss(net(p, inputs, train=True), targets, **cfg["loss"])
            loss.backward()
            torch.nn.utils.clip_grad_norm_(leaves, cfg["grad_clip"])
            opt.step()
            losses.append(float(loss.detach()))
            if first is None:
                first = {k: opt.state[x]["exp_avg"] / 0.1 for k, x in zip(names, leaves)}
    delta = {k: (p[k] - init[k]).detach() for k in names}
    return {"losses": losses, "first_grad": first, "delta": delta}


def worst_leaf(got: dict, want: dict, keep=None) -> float:
    """The largest gap between a leaf's norm in `got` and in `want`, over the
    larger of that leaf's norm in `want` and the median leaf's."""
    names = [k for k in want if keep is None or k in keep]
    norms = {k: float(want[k].double().norm()) for k in names}
    median = statistics.median(norms.values())
    return max(abs(float(got[k].double().norm()) - norms[k]) / max(norms[k], median, 1e-300)
               for k in names)


def moving_leaves(first_grad: dict, floor: float = 1e-3) -> set:
    """Leaves whose reference gradient is at least `floor` of the median
    leaf's: the others (the conv biases before a BatchNorm, whose gradient
    is nought to rounding) move under Adam by round-off alone."""
    norms = {k: float(g.double().norm()) for k, g in first_grad.items()}
    median = statistics.median(norms.values())
    return {k for k, n in norms.items() if n >= floor * median}
