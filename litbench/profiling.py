"""What the traced run reads from torch.profiler: device busy time, the
device operations that took most time, and the idle gaps by what the host
was doing (chip_profile.py's summed kernel time over the window, with busy
time as a union of intervals).

The host ranges are `torch.profiler.record_function` ranges named
"litbench.<stage>" that a traffic generator opens around the program's
stages. An idle gap belongs to the range in which the host launched the
operation that ended it: its launch (the runtime call with the operation's
correlation id) lies inside the range, whatever the operation's name.
"""

from __future__ import annotations

import collections
import time
from typing import Callable

import torch

PREFIX = "litbench."


class Ranges:
    """Consecutive named host ranges: `enter(name)` closes the open range and
    opens the next; `close()` closes the last."""

    def __init__(self):
        self.open = None

    def enter(self, name: str) -> None:
        self.close()
        self.open = torch.autograd.profiler.record_function(PREFIX + name)
        self.open.__enter__()

    def close(self) -> None:
        if self.open is not None:
            self.open.__exit__(None, None, None)
            self.open = None


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def profile(body: Callable[[], None], top: int = 10) -> dict:
    """Run body() under torch.profiler (CPU and CUDA activities) and reduce
    the trace. Returns window_s (host wall time of body, ended by a
    synchronize), busy_s (the union of the device operations' intervals),
    device_ops and idle_gaps (at most `top` [name, seconds] each)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        body()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    events = list(prof.events())
    cpu = torch.autograd.DeviceType.CPU
    dev_types = {torch.autograd.DeviceType.CUDA}
    # The device timeline also carries the host ranges' own spans: not work.
    device = [e for e in events if e.device_type in dev_types
              and e.time_range.end > e.time_range.start and not e.name.startswith(PREFIX)]
    if not device:
        raise RuntimeError("the profiler recorded no device operation")
    ranges = [(e.name[len(PREFIX):], e.time_range.start, e.time_range.end)
              for e in events if e.device_type == cpu and e.name.startswith(PREFIX)]
    # The runtime call that launched each device operation, by correlation id.
    launch = {e.id: e.time_range.start for e in events
              if e.device_type == cpu and e.name.startswith("cu") and e.id > 0}
    # Failing that, the host op it is linked to.
    ops = {e.id: e.time_range.start for e in events
           if e.device_type == cpu and not e.name.startswith("cu")}

    def launched(e) -> float | None:
        t = launch.get(e.id)
        return ops.get(getattr(e, "linked_correlation_id", 0)) if t is None else t

    def range_of(t: float | None) -> str:
        if t is None:
            return "unattributed"
        inside = [(b - a, n) for n, a, b in ranges if a <= t <= b]
        return min(inside)[1] if inside else "outside ranges"

    per_op: dict[str, float] = collections.defaultdict(float)
    for e in device:
        per_op[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
    busy = _merge([(e.time_range.start, e.time_range.end) for e in device])
    busy_s = sum(b - a for a, b in busy) * 1e-6

    # Each idle gap, labelled by the range in which the host launched the
    # operation that ended it: what the device was waiting for.
    first_launch = {}
    for e in device:
        first_launch.setdefault(e.time_range.start, launched(e))
    gaps: dict[str, float] = collections.defaultdict(float)
    for (_, end), (start, _) in zip(busy, busy[1:]):
        gaps[range_of(first_launch.get(start))] += (start - end) * 1e-6
    ordered = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"window_s": window_s, "busy_s": busy_s,
            "device_ops": ordered(per_op), "idle_gaps": ordered(gaps)}
