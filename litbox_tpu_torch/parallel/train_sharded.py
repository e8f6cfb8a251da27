"""The denoiser training step over a (data, model) mesh (counterpart of the
JAX package's parallel/train_sharded.py).

  data  - batch data parallelism: each rank takes its slice of the global
          batch; gradients are averaged over 'data' with one all-reduce a
          tensor. BatchNorm in training mode normalizes with the GLOBAL
          batch's statistics: each rank averages E[x] and E[x^2] over 'data'
          (an all-reduce whose backward is an all-reduce too), and the
          variance is Flax's E[x^2] - E[x]^2 clipped at 0, as nn/unet._bn.
  model - channel parallelism: conv kernels with at least
          MODEL_SHARD_MIN_CHANNELS output channels (the bottleneck and the
          deep encoder/decoder blocks) keep their out-channel slice on the
          rank. The conv's input enters through an identity whose backward
          sums the input gradient over 'model', its local output is gathered
          along channels over 'model' (the gather's backward is a slice),
          and the bias, replicated as in the JAX version, is added after.

hdr_loss at HdrLossConfig() is a sum of means of per-image terms, so the
mean of the shards' losses is the global batch's loss. The optimizer is
add_decayed_weights then adam on each rank's own shards: elementwise, so it
equals the replicated update.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call

from .. import convert
from ..nn.loss import HdrLossConfig, hdr_loss
from ..nn.train import Optimizer, TrainConfig
from ..nn.unet import FlaxBatchNorm2d, LitboxDenoiserNet, init_weights
from ..ops import conv
from . import world

MODEL_SHARD_MIN_CHANNELS = 256  # shard conv kernels with >= this many out-channels


def make_train_mesh(n_devices: int | None = None, model_parallel: int = 2):
    """Mesh ('data', 'model') over the first n ranks; model_parallel falls
    back to 1 when it does not divide n, as in the JAX version."""
    n = n_devices or dist.get_world_size()
    if n % model_parallel:
        model_parallel = 1
    return world.build_mesh(n, (n // model_parallel, model_parallel),
                            ("data", "model"))


def param_shardings(params: dict, mesh) -> dict:
    """{name: the dimension sharded over 'model', or None (replicated)}
    for the net's full-size parameters: conv kernels (the only 4-d
    parameters; (O, I, kh, kw) in the port's layout) with at least
    MODEL_SHARD_MIN_CHANNELS output channels and a channel count that the
    'model' size divides are sharded along their output channels."""
    m = world.mesh_shape(mesh)["model"]
    return {name: 0 if (p.ndim == 4 and p.shape[0] >= MODEL_SHARD_MIN_CHANNELS
                        and p.shape[0] % m == 0) else None
            for name, p in params.items()}


class _AllReduceMean(torch.autograd.Function):
    """Mean over a group's ranks; its gradient is the mean of the ranks'
    gradients (each rank's loss reads the same global mean)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, dist.ReduceOp.AVG, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, dist.ReduceOp.AVG, group=ctx.group)
        return grad, None


class _SumGradOverModel(torch.autograd.Function):
    """Identity whose backward sums the gradient over 'model': the input of
    a channel-sharded conv, whose ranks each hold a part of its gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


class _GatherChannels(torch.autograd.Function):
    """All-gather NCHW blocks along channels over 'model'; the gradient of
    the gather is this rank's channel slice."""

    @staticmethod
    def forward(ctx, x, group, index):
        ctx.index, ctx.width = index, x.shape[1]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.index * ctx.width
        return grad[:, lo:lo + ctx.width].contiguous(), None, None


class _ModelShardedConv2d(nn.Conv2d):
    """A conv whose kernel holds this rank's slice of the output channels;
    the gathered output and the replicated bias give the full conv. The
    slice convolves through `ops.conv.convolve`, as the net's layers do.
    It is an nn.Conv2d for the layer's geometry alone, which convolve
    checks and applies: out_channels is the slice's width and the bias the
    whole layer's, added after the gather, so nn.Conv2d's own forward
    (replaced here) would not fit it."""

    def __init__(self, layer: nn.Conv2d, group, n: int, index: int):
        width = layer.out_channels // n
        super().__init__(layer.in_channels, width, layer.kernel_size, layer.stride,
                         layer.padding, layer.dilation, layer.groups, bias=False,
                         padding_mode=layer.padding_mode, device="meta")
        self.weight = nn.Parameter(
            layer.weight.detach()[index * width:(index + 1) * width].clone())
        self.bias = nn.Parameter(layer.bias.detach().clone())
        self.group, self.index = group, index

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _SumGradOverModel.apply(x, self.group)
        y = conv.convolve(self, x, self.weight, None)
        y = _GatherChannels.apply(y, self.group, self.index)
        return y + self.bias[:, None, None]


def _global_moments(group, mean: torch.Tensor, mean_sq: torch.Tensor):
    both = _AllReduceMean.apply(torch.stack([mean, mean_sq]), group)
    return both[0], both[1]


def build_sharded_train_step(mesh, unet_size: int = 5, initial_features: int = 32,
                             learn_rate: float = 1e-5, weight_decay: float = 0.01,
                             batch: int = 4, variables: dict | None = None):
    """Returns (run, params, batch_stats, opt_state) for this rank.

    run(params, batch_stats, opt_state, inputs, targets) takes the GLOBAL
    (batch, crop, crop, 1) inputs and targets, trains on this rank's rows,
    updates params, batch_stats and opt_state IN PLACE and returns them with
    the global batch's loss (the same on every rank). params are this
    rank's shards (`param_shardings`), batch_stats the BatchNorm running
    statistics, opt_state the optimizer (its state holds count, mu, nu).

    The net lives on the rank's device (its card under NCCL). The initial
    state is the JAX function's `variables` (a Flax {"params",
    "batch_stats"} tree, carried by convert.unet_from_flax) when given,
    else the port's Flax initialization drawn from a generator seeded with
    0 on that device (the counterpart of jax.random.key(0)). The JAX
    function's `crop` only shapes the input its init traces; the port's
    init traces nothing, so it takes no crop."""
    g_data, n_data, i_data = world.axis(mesh, "data")
    g_model, n_model, i_model = world.axis(mesh, "model")
    if batch % n_data:
        raise ValueError(f"batch {batch} does not divide over {n_data} data ranks")
    device = world.rank_device()
    net = LitboxDenoiserNet(unet_size=unet_size, initial_features=initial_features).to(device)
    if variables is not None:
        state = convert.unet_from_flax(variables, unet_size=unet_size,
                                       initial_features=initial_features)
        net.load_state_dict(state)
    else:
        init_weights(net, torch.Generator(device=device).manual_seed(0))

    sharded = param_shardings(dict(net.named_parameters()), mesh)
    for name, module in list(net.named_modules()):
        if isinstance(module, nn.Conv2d) and sharded[f"{name}.weight"] is not None:
            parent, _, child = name.rpartition(".")
            setattr(net.get_submodule(parent), child,
                    _ModelShardedConv2d(module, g_model, n_model, i_model))
    for module in net.modules():
        if isinstance(module, FlaxBatchNorm2d):
            module.reduce_moments = functools.partial(_global_moments, g_data)

    params = dict(net.named_parameters())
    batch_stats = {k: v for k, v in net.named_buffers() if "running" in k}
    opt_state = Optimizer(params, TrainConfig(learn_rate=learn_rate,
                                              weight_decay=weight_decay, grad_clip=0.0))
    loss_cfg = HdrLossConfig()
    rows = batch // n_data

    def run(params, batch_stats, opt_state, inputs, targets):
        if opt_state.params is not params:
            raise ValueError("opt_state must be the optimizer of these params")
        take = lambda a: torch.as_tensor(  # noqa: E731
            a[i_data * rows:(i_data + 1) * rows], dtype=torch.float32).to(device)
        with conv.step_convolutions(device):
            out = functional_call(net, {**params, **batch_stats}, (take(inputs),),
                                  {"train": True})
            loss = hdr_loss(out, take(targets), loss_cfg)
            grads = torch.autograd.grad(loss, list(params.values()))
        for g in grads:
            dist.all_reduce(g, dist.ReduceOp.AVG, group=g_data)
        loss = loss.detach().reshape(1)
        dist.all_reduce(loss, dist.ReduceOp.AVG, group=g_data)
        opt_state.step(dict(zip(params, grads)))
        return params, batch_stats, opt_state, loss[0]

    return run, params, batch_stats, opt_state
