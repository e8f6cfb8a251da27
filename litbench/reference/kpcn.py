"""KPCN's training step written out in plain PyTorch, for the check of the
kpcn-21-train cell and the port's CPU tests: Bako, Vogels, McWilliams,
Meyer, Novak, Harvill, Sen, DeRose, Rousselle, "Kernel-Predicting
Convolutional Networks for Denoising Monte Carlo Renderings", ACM TOG
36(4), article 97 (SIGGRAPH 2017).

- a plain sampler: (a, b, albedo, trans, ref) of explicit draws, an item at
  a time, by slicing each scene's crop and `torch.rot90`;
- the features (`features`);
- the trunk, `layers` convolutions by `F.conv2d` of `kernel` x `kernel`
  taps, "same" zero padding, a ReLU after each but the last, which emits
  recon^2 logits a pixel;
- the reconstruction: the softmax over the recon^2 taps, the colour's
  recon x recon windows by `F.unfold` (zero padding recon // 2), their
  weighted sum (the paper's eq. 7);
- the L1 between that and log1p(reference);
- Adam (beta1 0.9, beta2 0.999, eps 1e-8) at a constant learning rate, no
  weight decay and no clip (reference/pair.py update).
The step's gradient comes from autograd. The mode "reference" runs float32
with TF32 off and PyTorch's own convolutions (reference/train.py
precision); "control" runs TF32 through cuDNN, one precision below.

Departures from the paper, each the configuration's (configs/kpcn-21.json
`assumed`):
- Features are litbox's own 22 channels: litbox has no normals or depth,
  its auxiliary buffers are albedo and transmissibility, and its variance
  comes from its two independent tracers. With x = (A + B) / 2: the colour
  log1p(x) (3), the variance mean_RGB(((A - B) / 2)^2 / (1 + x)^2) (1),
  albedo (3), transmissibility (1), and the forward differences along x,
  then along y, of the colour, albedo and transmissibility (7 + 7), 0 at
  the last column or row.
- One network: litbox has one radiance buffer and no diffuse/specular
  split, so the specular branch's transform serves: log1p in, the kernel
  applied to the log1p colour, the L1 in that domain.
- Zero padding at the patch's edges, for the trunk and the reconstruction;
  the softmax runs over all recon^2 taps, those outside the patch too.
- Glorot-uniform weights and zero biases (the paper states no
  initialization); the batch, no decay and no clip are assumed as well.

This module imports nothing of the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from litbench.reference import pair as ref_pair
from litbench.reference import train as ref_train

IN_CHANNELS = 22


def sample(data: tuple, draws, crop: int) -> tuple:
    """(a, b, albedo, trans, ref), (batch, crop, crop, C), from the stage's
    (a, b, ref, albedo, trans) (N, H, W, C) tensors and explicit draws (an
    object with (batch,) tensors idx, top, left, rot): each item's crop at
    (top, left) of scene idx, turned by rot quarter turns (torch.rot90 over
    (H, W))."""
    out = ([], [], [], [], [])
    fields = (draws.idx, draws.top, draws.left, draws.rot)
    for i, top, left, k in zip(*(t.tolist() for t in fields)):
        a, b, ref, albedo, trans = (torch.rot90(x[i, top:top + crop, left:left + crop], k,
                                                dims=(0, 1)) for x in data)
        for items, x in zip(out, (a, b, albedo, trans, ref)):
            items.append(x)
    return tuple(torch.stack(items) for items in out)


def features(a, b, albedo, trans) -> tuple[torch.Tensor, torch.Tensor]:
    """(features (N, 22, H, W), colour (N, 3, H, W)) from (N, H, W, C)
    buffers, in the docstring's order."""
    a, b, albedo, trans = (t.permute(0, 3, 1, 2) for t in (a, b, albedo, trans))
    x = (a + b) * 0.5
    colour = torch.log1p(x)
    half = (a - b) * 0.5
    variance = (half.square() / (1.0 + x).square()).mean(1, keepdim=True)
    base = torch.cat([colour, albedo, trans], 1)
    dx = torch.zeros_like(base)
    dx[..., :-1] = base[..., 1:] - base[..., :-1]
    dy = torch.zeros_like(base)
    dy[..., :-1, :] = base[..., 1:, :] - base[..., :-1, :]
    return torch.cat([colour, variance, albedo, trans, dx, dy], 1), colour


def layout(cfg: dict) -> list[tuple[str, tuple]]:
    """(name, shape) of every parameter: convs.<i>.weight (Cout, Cin, k, k)
    and convs.<i>.bias (Cout,)."""
    k = cfg["kernel_size"]
    c = [IN_CHANNELS] + [cfg["features"]] * (cfg["layers"] - 1) + [cfg["recon_kernel"] ** 2]
    out = []
    for i, (cin, cout) in enumerate(zip(c, c[1:])):
        out += [(f"convs.{i}.weight", (cout, cin, k, k)), (f"convs.{i}.bias", (cout,))]
    return out


def trunk(p: dict, feats: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The logits (N, recon^2, H, W) of the features."""
    x, last = feats, cfg["layers"] - 1
    for i in range(cfg["layers"]):
        x = F.conv2d(x, p[f"convs.{i}.weight"], p[f"convs.{i}.bias"],
                     padding=cfg["kernel_size"] // 2)
        if i < last:
            x = F.relu(x)
    return x


def reconstruct(logits: torch.Tensor, colour: torch.Tensor) -> torch.Tensor:
    """sum over taps q of softmax(logits)_q * colour_{p+q}, (N, 3, H, W)."""
    n, taps, h, w = logits.shape
    k = round(taps ** 0.5)
    weights = torch.softmax(logits.reshape(n, 1, taps, h * w), dim=2)
    cols = F.unfold(colour, k, padding=k // 2).reshape(n, colour.shape[1], taps, h * w)
    return (weights * cols).sum(2).reshape(n, colour.shape[1], h, w)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with the slope 1 at 0."""
    return torch.where(x >= 0, x, -x)


def loss(p: dict, batch: tuple, cfg: dict) -> torch.Tensor:
    """The L1 of the reconstruction against log1p(ref), over every value."""
    a, b, albedo, trans, ref = batch
    feats, colour = features(a, b, albedo, trans)
    out = reconstruct(trunk(p, feats, cfg), colour)
    return torch.mean(_abs(out - torch.log1p(ref.permute(0, 3, 1, 2))))


def train(init: dict, batches: list, cfg: dict, mode: str = "reference") -> dict:
    """Run len(batches) steps of (a, b, albedo, trans, ref) from the
    parameters `init` (a state_dict, not modified), in `mode`. Returns the
    losses, each leaf's first gradient (its first moment after one step over
    1 - beta1) and each leaf's change after the last step."""
    names = [k for k, _ in layout(cfg)]
    p = {k: init[k].detach().clone() for k in names}
    leaves = [p[k].requires_grad_() for k in names]
    update_cfg = {"grad_clip": 0.0, "weight_decay": 0.0, "learn_rate": cfg["learn_rate"]}
    state: dict = {}
    losses, first = [], None
    with ref_train.precision(mode):
        for count, batch in enumerate(batches):
            for x in leaves:
                x.grad = None
            value = loss(p, batch, cfg)
            value.backward()
            ref_pair.update(leaves, state, count, update_cfg)
            losses.append(float(value.detach()))
            if first is None:
                first = {k: state[id(x)][0] / (1.0 - ref_pair.BETA1) for k, x in zip(names, leaves)}
    delta = {k: (p[k] - init[k]).detach() for k in names}
    return {"losses": losses, "first_grad": first, "delta": delta}
