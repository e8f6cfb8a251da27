"""conv_kernel_share.train: the share of the training step's convolution
calls that the port's convolution kernels served, in %: the program's
counters train.conv_kernel (a convolution inside the step's routing that
the kernels served) over it plus train.conv_fallback (one that went to
PyTorch's own path), both one a call (ops/conv.py), summed over the
window's steps. None where the program counts neither (a checkout from
before the kernels)."""

from litbench.program_spans import window_records


def read(trace: dict) -> float | None:
    records = window_records(trace)
    if records is None:
        return None
    kernel = sum(r.counts.get("train.conv_kernel", 0) for r in records)
    fallback = sum(r.counts.get("train.conv_fallback", 0) for r in records)
    return 100.0 * kernel / (kernel + fallback) if kernel + fallback else None
