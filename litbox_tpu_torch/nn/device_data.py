"""On-device training batches (counterpart of the JAX package's
nn/device_data.py).

A stage's scenes are decoded once on the host and live on the card as
(N, H, W, 3) float32 tensors; every training step draws its batch there:

  scene pick     -> random index over the scene axis
  random crop    -> one gather of (batch, crop, crop) texels
  90-deg rot     -> folded into the gather's indices, per item
  tracer swap    -> where(swap, b, a)   (both tracers are inputs)
  noise2noise    -> where(n2n, other tracer, reference) target
  identity       -> where(identity, reference, tracer) for both tracers
  channel select -> mono nets take one random channel, the same for the
                    input and the target

Each sampler is a draw function (`draw`, the per-item random numbers from a
`torch.Generator` on the stage's device) and a batch function that takes
explicit draws (`sample_batch_from`, `sample_batch_pair_from`,
`sample_batch_kpcn_from`), so the same draws can be given to another
implementation. Nothing goes through the host: a step's batch costs no host
sync.

A stage may also hold each scene's albedo (N, H, W, 3) and
transmissibility (N, H, W, 1), KPCN's auxiliary buffers, which
`sample_kpcn` crops and turns with the tracers' draws.

`DeviceStages.sample`, `sample_pair` and `sample_kpcn` record the span
`data.sample` (the host's issue of the draws and gathers; core/spans.py)
and the counter `data.sample_bytes` (the bytes of the tensors they
return).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import spans


def stack_stage(paths_a, paths_b, paths_ref, scales) -> tuple:
    """Decode and stack a stage's scenes into (N, H, W, 3) f32 arrays
    (host-side, once per run). Returns (a, b, ref) numpy arrays."""
    from ..io.images import read_image_linear

    a = np.stack([read_image_linear(p) * s for p, s in zip(paths_a, scales)])
    b = np.stack([read_image_linear(p) * s for p, s in zip(paths_b, scales)])
    r = np.stack([read_image_linear(p) * s
                  for p, s in zip(paths_ref, scales)])
    return (a.astype(np.float32), b.astype(np.float32), r.astype(np.float32))


@dataclasses.dataclass
class Draws:
    """One batch's per-item draws, (batch,) tensors on the stage's device:
    scene index, crop top and left, rotation k (jnp.rot90's), tracer swap,
    `flag` (noise2noise for sample_batch, identity for sample_batch_pair)
    and channel."""

    idx: torch.Tensor
    top: torch.Tensor
    left: torch.Tensor
    rot: torch.Tensor
    swap: torch.Tensor
    flag: torch.Tensor
    chan: torch.Tensor


def draw(generator: torch.Generator, shape, batch: int, crop: int, p: float) -> Draws:
    """The draws of one batch over stage tensors of `shape` (N, H, W, 3),
    on the generator's device; `flag` is true with probability p."""
    n, h, w = shape[:3]
    dev = generator.device

    def ints(hi):
        return torch.randint(0, hi, (batch,), generator=generator, device=dev)

    def coin(q):
        return torch.rand((batch,), generator=generator, device=dev) < q

    return Draws(idx=ints(n), top=ints(h - crop + 1), left=ints(w - crop + 1),
                 rot=ints(4), swap=coin(0.5), flag=coin(p), chan=ints(3))


def _crop_index(d: Draws, crop: int):
    """(rows, cols) of the (batch, crop, crop) texels of each item's crop
    after jnp.rot90(crop, k): out[i, j] = in[j, C-1-i] for k = 1,
    in[C-1-i, C-1-j] for 2, in[C-1-j, i] for 3."""
    i = torch.arange(crop, device=d.top.device)
    ii, jj = i[:, None].expand(crop, crop), i[None, :].expand(crop, crop)
    fi, fj = crop - 1 - ii, crop - 1 - jj
    k = d.rot[:, None, None]
    r = torch.where(k == 0, ii, torch.where(k == 1, jj, torch.where(k == 2, fi, fj)))
    c = torch.where(k == 0, jj, torch.where(k == 1, fi, torch.where(k == 2, fj, ii)))
    return d.top[:, None, None] + r, d.left[:, None, None] + c


def _gather(data: torch.Tensor, d: Draws, rows, cols, rgb: bool) -> torch.Tensor:
    """The rotated crops of `data` for each item: (batch, crop, crop, 3),
    or the item's channel (batch, crop, crop, 1) when not rgb."""
    idx = d.idx[:, None, None]
    if rgb:
        return data[idx, rows, cols]
    return data[idx, rows, cols, d.chan[:, None, None]][..., None]


def sample_batch_from(data_a, data_b, data_ref, d: Draws, crop: int, rgb: bool):
    """(inputs, targets) of the draws: the input is tracer A or, swapped, B;
    the target the reference or, with the noise2noise flag, the other
    tracer. (batch, crop, crop, 3) when rgb else (batch, crop, crop, 1)."""
    rows, cols = _crop_index(d, crop)
    a, b, ref = (_gather(x, d, rows, cols, rgb) for x in (data_a, data_b, data_ref))
    sw = d.swap[:, None, None, None]
    inp = torch.where(sw, b, a)
    other = torch.where(sw, a, b)
    return inp, torch.where(d.flag[:, None, None, None], other, ref)


def sample_batch_pair_from(data_a, data_b, data_ref, d: Draws, crop: int, rgb: bool):
    """(a, b, ref) of the draws: the tracers swapped where drawn, both
    replaced by the reference under the identity flag."""
    rows, cols = _crop_index(d, crop)
    a, b, ref = (_gather(x, d, rows, cols, rgb) for x in (data_a, data_b, data_ref))
    sw = d.swap[:, None, None, None]
    a, b = torch.where(sw, b, a), torch.where(sw, a, b)
    idn = d.flag[:, None, None, None]
    return torch.where(idn, ref, a), torch.where(idn, ref, b), ref


def sample_batch_kpcn_from(data_a, data_b, data_ref, data_albedo, data_trans, d: Draws,
                           crop: int):
    """(a, b, albedo, trans, ref) of the draws: every buffer cropped and
    turned alike, the tracers neither swapped nor replaced (the features
    are symmetric in them)."""
    rows, cols = _crop_index(d, crop)
    a, b, ref, albedo, trans = (_gather(x, d, rows, cols, True)
                                for x in (data_a, data_b, data_ref, data_albedo, data_trans))
    return a, b, albedo, trans, ref


def sample_batch(data_a, data_b, data_ref, generator: torch.Generator, batch: int,
                 crop: int, rgb: bool, n2n_p: float = 0.0):
    """Draw one (inputs, targets) batch on the stage tensors' device."""
    d = draw(generator, data_a.shape, batch, crop, n2n_p)
    return sample_batch_from(data_a, data_b, data_ref, d, crop, rgb)


def sample_batch_pair(data_a, data_b, data_ref, generator: torch.Generator, batch: int,
                      crop: int, rgb: bool, identity_p: float = 0.0):
    """Draw one (a, b, ref) triplet batch for composition-in-the-loss
    training (Trainer.train_batch_pair_async). identity_p: probability that
    an item shows the converged reference as both tracers, which teaches
    net(clean) = clean."""
    d = draw(generator, data_a.shape, batch, crop, identity_p)
    return sample_batch_pair_from(data_a, data_b, data_ref, d, crop, rgb)


class DeviceStages:
    """Stage tensors resident on a device, and their samplers."""

    def __init__(self, stages: dict[str, tuple], device: str | torch.device = "cuda"):
        """stages: name -> (a, b, ref) arrays from stack_stage or tensors,
        or (a, b, ref, albedo, trans) for KPCN; a tensor already on the
        device in float32 is held as it is, not copied (stages may share
        their scenes' albedo and transmissibility)."""
        self.device = torch.device(device)
        self.data = {name: tuple(torch.as_tensor(x, dtype=torch.float32,
                                                 device=self.device) for x in arrs)
                     for name, arrs in stages.items()}

    def sample(self, name: str, generator: torch.Generator, batch: int, crop: int,
               rgb: bool, n2n_p: float = 0.0):
        a, b, r = self.data[name][:3]
        with spans.span("data.sample"):
            out = sample_batch(a, b, r, generator, batch, crop, rgb, n2n_p)
        spans.count("data.sample_bytes", sum(x.nbytes for x in out))
        return out

    def sample_pair(self, name: str, generator: torch.Generator, batch: int, crop: int,
                    rgb: bool, identity_p: float = 0.0):
        a, b, r = self.data[name][:3]
        with spans.span("data.sample"):
            out = sample_batch_pair(a, b, r, generator, batch, crop, rgb, identity_p)
        spans.count("data.sample_bytes", sum(x.nbytes for x in out))
        return out

    def sample_kpcn(self, name: str, generator: torch.Generator, batch: int, crop: int):
        """A KPCN batch (a, b, albedo, trans, ref), (batch, crop, crop, C),
        from a stage that holds albedo and transmissibility."""
        data = self.data[name]
        if len(data) != 5:
            raise ValueError(f"stage {name!r} holds no albedo and transmissibility")
        with spans.span("data.sample"):
            d = draw(generator, data[0].shape, batch, crop, 0.0)
            out = sample_batch_kpcn_from(*data, d, crop)
        spans.count("data.sample_bytes", sum(x.nbytes for x in out))
        return out
