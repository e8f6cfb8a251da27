"""Attenuation scan: the RBT per-row deposit recurrence (kernel K1).

For every row of a (D, S, S) rotated field, and for three colour channels
in one pass,

    O[x] = t[x] * O[x-1] + src[x] * sqrt(t[x]),   O[-1] = 0.

Replaces the Pallas kernel `litbox_tpu/ops/attnscan.py::attenuation_scan_rows`
(pallas_call at :97). The CUDA kernel is `csrc/attnscan.cu`: one warp per
(bin, row), a shuffle scan over 32-column chunks with the carry passed from
chunk to chunk. It is bound by bytes: 7 planes of (D/n_groups) * S * S
float32 (528 MB at D=128, S=384; 0.16 ms at the H100's 3.35 TB/s).

A CPU tensor takes the plain PyTorch version below; a CUDA tensor takes the
kernel or the call raises.
"""

from __future__ import annotations

import torch

from . import cuda_lib


def _check_args(t, srcs, group: int, n_groups: int, src_offset: int) -> None:
    if t.ndim != 3:
        raise ValueError(f"t must be (D, S, S), got {tuple(t.shape)}")
    d, rows, width = t.shape
    if n_groups < 1 or d % n_groups or not 0 <= group < n_groups:
        raise ValueError(f"bad group {group} of {n_groups} for {d} bins")
    for s in srcs:
        if s.ndim != 3 or tuple(s.shape[1:]) != (rows, width):
            raise ValueError(f"source shape {tuple(s.shape)} does not match t {tuple(t.shape)}")
        if src_offset < 0 or s.shape[0] < src_offset + d:
            raise ValueError(f"src_offset {src_offset} + {d} bins exceeds {s.shape[0]}")


def attenuation_scan_rows_plain(t: torch.Tensor, src0: torch.Tensor,
                                src1: torch.Tensor, src2: torch.Tensor,
                                group: int = 0, n_groups: int = 1,
                                src_offset: int = 0) -> tuple:
    """The scan as a sequential loop over columns (plain PyTorch)."""
    _check_args(t, (src0, src1, src2), group, n_groups, src_offset)
    d, _, width = t.shape
    tg = t[group::n_groups]
    src = torch.stack([s[src_offset + group:src_offset + d:n_groups]
                       for s in (src0, src1, src2)])
    b = src * torch.sqrt(tg)
    out = torch.empty_like(b)
    o = torch.zeros_like(b[..., 0])
    for x in range(width):
        o = tg[..., x] * o + b[..., x]
        out[..., x] = o
    return out[0], out[1], out[2]


def attenuation_scan_rows(t: torch.Tensor, src0: torch.Tensor,
                          src1: torch.Tensor, src2: torch.Tensor,
                          group: int = 0, n_groups: int = 1,
                          src_offset: int = 0) -> tuple:
    """Per-row affine scan of 3 channels over (D, S, S) fields.

    Returns (dep0, dep1, dep2), each (D//n_groups, S, S) float32:
    dep[i, y, x] = sum_{k<=x} src[b, y, k]*sqrt(t[d, y, k]) * prod_{j in (k, x]} t[d, y, j]
    with d = group + i*n_groups and b = src_offset + d: only the bins of one
    group are scanned, and the sources may be a tracer-major (T*D, S, S)
    buffer read at block src_offset, with no copy of either.
    """
    if cuda_lib.on_cpu(t, src0, src1, src2):
        return attenuation_scan_rows_plain(t, src0, src1, src2, group,
                                           n_groups, src_offset)
    cuda_lib.require_cuda_float32("attenuation_scan_rows", t, src0, src1, src2)
    _check_args(t, (src0, src1, src2), group, n_groups, src_offset)
    d, rows, width = t.shape
    outs = tuple(torch.empty((d // n_groups, rows, width), device=t.device)
                 for _ in range(3))
    code = cuda_lib.library().litbox_attnscan_rows(
        t.data_ptr(), src0.data_ptr(), src1.data_ptr(), src2.data_ptr(),
        *(o.data_ptr() for o in outs), d // n_groups, rows, width, group,
        n_groups, src_offset, cuda_lib.stream_handle(t.device))
    cuda_lib.check(code, "attenuation_scan_rows")
    attenuation_scan_rows.launches += 1
    return outs


attenuation_scan_rows.launches = 0
