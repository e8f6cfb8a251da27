"""Data-movement micro-kernels: the transposes, rolls and flips a rotate
built from shears moves its planes with, each over N float32 (S, S) images
and returning the whole (N, S, S) output (counterparts of the Pallas kernels
of runs/prof_microops.py, pallas_call at :55, :72, :95, :119 and :145).

    transpose   out[d] = x[d]^T
    transpose2  out[d] = ((x[d]^T) * 2)^T, through two transposes on chip
    roll_rows   out[d] = roll(x[d], shifts[d], axis=0)   rows move
    roll_cols   out[d] = roll(x[d], shifts[d], axis=1)   columns move
    flip2       out[d] = x[d][::-1, ::-1]                rot90 by 2

The shifts are an int32 (N,) tensor on the images' device, reduced by floor
modulo as jnp.roll and torch.roll reduce them. The kernels are CUDA C++ in
`csrc/prof_microops.cu`, built into the port's one library. A CPU tensor
takes the plain PyTorch version; a CUDA tensor takes the kernel or the call
raises.
"""

from __future__ import annotations

import torch

from ..ops import cuda_lib

MAX_IMAGES = 65535  # the kernels put the image index on a grid axis


def _check(x: torch.Tensor, shifts: torch.Tensor | None = None) -> tuple[int, int]:
    if x.ndim != 3 or x.shape[1] != x.shape[2]:
        raise ValueError(f"x must be (N, S, S), got {tuple(x.shape)}")
    n, s = x.shape[0], x.shape[1]
    if shifts is not None:
        if tuple(shifts.shape) != (n,):
            raise ValueError(f"shifts {tuple(shifts.shape)} must be ({n},)")
        if shifts.dtype != torch.int32:
            raise TypeError(f"shifts must be int32, got {shifts.dtype}")
    return n, s


def _source_index(shifts: torch.Tensor, s: int) -> torch.Tensor:
    """(N, S) source positions (i - shifts[d]) mod S, built on the shifts'
    device (torch.remainder takes the divisor's sign: floor modulo)."""
    i = torch.arange(s, device=shifts.device)
    return torch.remainder(i[None, :] - shifts[:, None].long(), s)


def transpose_plain(x: torch.Tensor) -> torch.Tensor:
    _check(x)
    return x.transpose(1, 2).contiguous()


def transpose2_plain(x: torch.Tensor) -> torch.Tensor:
    _check(x)
    return (x.transpose(1, 2).contiguous() * 2.0).transpose(1, 2).contiguous()


def roll_rows_plain(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    n, s = _check(x, shifts)
    return torch.gather(x, 1, _source_index(shifts, s)[:, :, None].expand(n, s, s))


def roll_cols_plain(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    n, s = _check(x, shifts)
    return torch.gather(x, 2, _source_index(shifts, s)[:, None, :].expand(n, s, s))


def flip2_plain(x: torch.Tensor) -> torch.Tensor:
    _check(x)
    return torch.flip(x, (1, 2))


def _launch(name: str, x: torch.Tensor, shifts: torch.Tensor | None = None):
    """Check a CUDA call's arguments, launch the kernel into a new output and
    return it."""
    cuda_lib.require_cuda_float32(name, x)
    n, s = _check(x, shifts)
    if n > MAX_IMAGES:
        raise ValueError(f"{name} takes at most {MAX_IMAGES} images, got {n}")
    out = torch.empty_like(x)
    stream = cuda_lib.stream_handle(x.device)
    fn = getattr(cuda_lib.library(), f"litbox_prof_{name}")
    if shifts is None:
        code = fn(x.data_ptr(), out.data_ptr(), n, s, stream)
    else:
        if shifts.device != x.device:
            raise ValueError(f"{name}: shifts on {shifts.device}, x on {x.device}")
        if not shifts.is_contiguous():
            raise ValueError(f"{name}: expected contiguous shifts")
        code = fn(x.data_ptr(), out.data_ptr(), shifts.data_ptr(), n, s, stream)
    cuda_lib.check(code, name)
    return out


def transpose(x: torch.Tensor) -> torch.Tensor:
    """Every image transposed through 32x33 shared tiles."""
    if cuda_lib.on_cpu(x):
        return transpose_plain(x)
    out = _launch("transpose", x)
    transpose.launches += 1
    return out


transpose.launches = 0


def transpose2(x: torch.Tensor) -> torch.Tensor:
    """2 * x, by way of two in-shared-memory transposes: a block per 32x32
    tile and image stages its tile by 16-byte cp.async copies, transposes
    it into a second shared tile while scaling by 2 and reads that back
    transposed into 16-byte stores. Any S (4-byte copies and stores where
    S % 4 != 0)."""
    if cuda_lib.on_cpu(x):
        return transpose2_plain(x)
    out = _launch("transpose2", x)
    transpose2.launches += 1
    return out


transpose2.launches = 0


def roll_rows(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Every image's rows rolled by shifts[d]: one thread per output texel."""
    if cuda_lib.on_cpu(x, shifts):
        return roll_rows_plain(x, shifts)
    out = _launch("roll_rows", x, shifts)
    roll_rows.launches += 1
    return out


roll_rows.launches = 0


def roll_cols(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Every image's columns rolled by shifts[d]: one thread per output texel."""
    if cuda_lib.on_cpu(x, shifts):
        return roll_cols_plain(x, shifts)
    out = _launch("roll_cols", x, shifts)
    roll_cols.launches += 1
    return out


roll_cols.launches = 0


def flip2(x: torch.Tensor) -> torch.Tensor:
    """Every image flipped on both axes: one thread per output texel."""
    if cuda_lib.on_cpu(x):
        return flip2_plain(x)
    out = _launch("flip2", x)
    flip2.launches += 1
    return out


flip2.launches = 0
