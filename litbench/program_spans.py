"""The program's own step records (litbox_tpu_torch/core/spans.py), as the
per-layer readers of a training cell read them: the window's steps are the
last `trace["steps"]` records of `train.step` made while no torch.profiler
profile was recording (the set-up steps come before them, the profiled
steps after them are flagged)."""

from __future__ import annotations

import statistics


def window_records(trace: dict) -> list | None:
    """The window's step records, or None where the trace has no window or
    the program records no spans (a checkout from before them)."""
    n = trace.get("steps")
    if not n:
        return None
    try:
        from litbox_tpu_torch.core import spans
    except ImportError:
        return None
    records = [r for r in spans.step_records() if r.kind == "train.step" and not r.profiled]
    return records[-n:] or None


def median_ms(trace: dict, *names: str) -> float | None:
    """The median over the window's steps of the host ms of these spans."""
    records = window_records(trace)
    if records is None or records[-1].find(names[0]) is None:
        return None
    return statistics.median(r.host_ms(*names) for r in records)
