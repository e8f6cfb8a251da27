"""The training step's optimizer update: optax.chain(clip_by_global_norm,
add_decayed_weights, adam) over a net's parameter tensors, in place.

In optax's order: the global-norm clip (scale by clip / norm only when
norm >= clip, no epsilon; none when grad_clip is 0), the coupled decay
g + wd * p, then Adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root,
eps_root 0) with bias corrections from the update count, scaled by the
learning rate: a float, or a 0-d float32 tensor (a schedule's value) read
on the device.

The JAX package has no Pallas kernel here: optax runs through XLA. On the
card the chain as tensor ops (`adam_update_plain`) runs 19-25 device
operations a parameter tensor, and the host's issue of them paced the
training step.
The CUDA kernel, `csrc/adam.cu`, does the update in two launches (one
without the clip), bound by bytes: one read of the gradients for the norm,
then one pass that reads p, g, mu and nu and writes p, mu and nu.

A CPU tensor takes the plain version; a CUDA tensor takes the kernel or the
call raises.
"""

from __future__ import annotations

import ctypes
import operator

import torch

from . import cuda_lib

B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults
CHUNK = 8192        # floats a block of the update (csrc/adam.cu kChunk)
MAX_TENSORS = 448   # gradient pointers a launch carries (csrc/adam.cu kMaxTensors)
NORM_BLOCKS = 1024  # the norm's partial sums: its grid at most


@torch.no_grad()
def adam_update_plain(params: list, grads: list, mu: list, nu: list, count: torch.Tensor,
                      lr, grad_clip: float, weight_decay: float,
                      schedule_count: torch.Tensor | None = None) -> None:
    """The update as tensor ops: params, mu and nu (lists of tensors of the
    gradients' shapes) and count (an int32 0-d tensor, the updates so far)
    are updated in place, and schedule_count, if given, advanced by one."""
    g = grads
    if grad_clip:
        norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
        keep = norm < grad_clip
        g = [torch.where(keep, x, (x / norm) * grad_clip) for x in g]
    g = [x + weight_decay * p for p, x in zip(params, g)]
    n = count + 1
    bc1 = 1 - torch.pow(B1, n.float())
    bc2 = 1 - torch.pow(B2, n.float())
    step_size = -lr
    for p, x, m, v in zip(params, g, mu, nu):
        m.copy_((1 - B1) * x + B1 * m)
        v.copy_((1 - B2) * (x * x) + B2 * v)
        update = (m / bc1) / (torch.sqrt(v / bc2) + EPS)
        p.copy_(p + step_size * update)
    count.copy_(n)
    if schedule_count is not None:
        schedule_count.add_(1)


class Tables:
    """The kernel's view of one set of params, mu and nu: a device table of
    their pointers, sizes and first chunks, and the launches' scratch (the
    norm's partial sums, the norm and two tickets, zero between launches).
    `adam_update` makes it at its first launch and again whenever it is
    given other tensors; the tensors are updated in place, so their
    pointers hold from step to step."""

    def __init__(self):
        self.held: tuple = ((), (), ())
        self.table: torch.Tensor | None = None
        self.scratch: torch.Tensor | None = None
        self.n_chunks = 0

    def holds(self, params: list, mu: list, nu: list) -> bool:
        return all(len(a) == len(b) and all(map(operator.is_, a, b))
                   for a, b in zip(self.held, (params, mu, nu)))

    def make(self, params: list, mu: list, nu: list) -> None:
        for p, m, v in zip(params, mu, nu):
            if m.shape != p.shape or v.shape != p.shape:
                raise ValueError(f"adam_update: moments of {tuple(m.shape)} and "
                                 f"{tuple(v.shape)} for a parameter of {tuple(p.shape)}")
        cuda_lib.require_cuda_float32("adam_update", *params, *mu, *nu)
        numel = [p.numel() for p in params]
        first = [0]
        for n in numel:
            first.append(first[-1] + -(-n // CHUNK))
        rows = [x.data_ptr() for x in (*params, *mu, *nu)] + numel + first
        dev = params[0].device
        # From pinned memory, queued on the stream: the host does not wait.
        table = torch.tensor(rows, dtype=torch.int64).pin_memory()
        self.table = table.to(dev, non_blocking=True)
        if self.scratch is None or self.scratch.device != dev:
            self.scratch = torch.zeros(NORM_BLOCKS + 4, device=dev)
        self.n_chunks = first[-1]
        self.held = (list(params), list(mu), list(nu))


def _check(params, grads, mu, nu, count, schedule_count, lr) -> None:
    """What the kernel takes, before anything reaches the card: one list of
    each, of one length up to MAX_TENSORS, float32 contiguous gradients of
    the parameters' shapes, int32 counts and a float32 0-d learning rate,
    all on the parameters' device (`Tables.make` checks params, mu and nu).
    The gradients are checked with maps over the list, the per-tensor loop
    only on a fault: this runs every step."""
    dev = params[0].device
    n = len(params)
    if not 0 < n <= MAX_TENSORS or not len(grads) == len(mu) == len(nu) == n:
        raise ValueError(f"adam_update: {n} params, {len(grads)} grads, {len(mu)} mu, "
                         f"{len(nu)} nu (1 to {MAX_TENSORS} of each)")
    dtypes = set(map(operator.attrgetter("dtype"), grads))
    if dtypes != {torch.float32}:
        raise TypeError(f"adam_update: expected float32 gradients, got {dtypes}")
    shape = operator.attrgetter("shape")
    if not (set(map(operator.attrgetter("device"), grads)) == {dev}
            and all(map(torch.Tensor.is_contiguous, grads))
            and list(map(shape, grads)) == list(map(shape, params))):
        for p, g in zip(params, grads):
            if g.shape != p.shape or not g.is_contiguous() or g.device != dev:
                raise ValueError(f"adam_update: a gradient of {tuple(g.shape)} on {g.device} "
                                 f"(contiguous: {g.is_contiguous()}) for a parameter of "
                                 f"{tuple(p.shape)} on {dev}")
    for c in (count, schedule_count):
        if c is not None and (c.dtype != torch.int32 or c.numel() != 1):
            raise TypeError(f"adam_update: counts must be int32 scalars, got {c.dtype} "
                            f"of {tuple(c.shape)}")
    if isinstance(lr, torch.Tensor) and (lr.dtype != torch.float32 or lr.numel() != 1):
        raise TypeError(f"adam_update: lr must be a float32 scalar, got {lr.dtype}")
    for x in (count, schedule_count, lr):
        if isinstance(x, torch.Tensor) and x.device != dev:
            raise ValueError(f"adam_update: a scalar on {x.device}, the parameters on {dev}")


def adam_update(params: list, grads: list, mu: list, nu: list, count: torch.Tensor,
                lr, grad_clip: float, weight_decay: float,
                schedule_count: torch.Tensor | None = None,
                tables: Tables | None = None) -> None:
    """One update of params, mu, nu and count in place (see
    `adam_update_plain`). On CPU tensors the plain version runs; on CUDA
    tensors the kernel, with `tables` (a Tables the caller keeps from step
    to step), or the call raises. lr is a float or a float32 0-d tensor on
    the parameters' device."""
    if cuda_lib.on_cpu(params[0], grads[0], mu[0], nu[0], count):
        adam_update_plain(params, grads, mu, nu, count, lr, grad_clip, weight_decay,
                          schedule_count)
        return
    _check(params, grads, mu, nu, count, schedule_count, lr)
    if tables is None:
        raise ValueError("adam_update: CUDA tensors need the caller's Tables")
    if not tables.holds(params, mu, nu):
        tables.make(params, mu, nu)
    lib = cuda_lib.library()
    ptrs = (ctypes.c_void_p * len(grads))(*map(torch.Tensor.data_ptr, grads))
    stream = cuda_lib.stream_handle(params[0].device)
    common = (ptrs, len(grads), tables.table.data_ptr(), tables.n_chunks,
              tables.scratch.data_ptr(), tables.scratch.numel())
    if grad_clip:
        cuda_lib.check(lib.litbox_adam_norm(*common, stream), "adam_update")
        adam_update.launches += 1
    lr_dev = lr.data_ptr() if isinstance(lr, torch.Tensor) else None
    code = lib.litbox_adam_update(
        *common, count.data_ptr(),
        None if schedule_count is None else schedule_count.data_ptr(), lr_dev,
        0.0 if lr_dev else lr, grad_clip, weight_decay, B1, 1 - B1, B2, 1 - B2, EPS, stream)
    cuda_lib.check(code, "adam_update")
    adam_update.launches += 1


adam_update.launches = 0
