"""Stage clocks and counters of the port: named spans around the places
where the program does its work, and integer counters beside them, kept in
memory for the process to read.

    from litbox_tpu_torch.core import spans

    with spans.step("train.step"):
        with spans.span("train.forward"):
            ...
    spans.count("train.h2d_bytes", x.nbytes)
    spans.step_records()[-1].host_ms("train.forward")

Level 1 is always on and touches only the host. Each span reads
`time.perf_counter_ns()` at entry and exit and records its name, its parent
(the span open around it) and the id of the step record it belongs to. The
recorder keeps, for each name, a count, the total time and the self time
(the duration less what its child spans cover). A counter is an integer
add. The spans that closed since the last step, and the counters' changes
over them, form a step record when the outermost step span closes: a span
its caller opened with `step(name)`, not `span(name)`. So a batch made
before a training step belongs to that step. The record also says whether
a torch.profiler profile was recording when it closed. The last `RING`
records are kept. Level 1 makes no device call: no CUDA event, no
synchronize, no profiler range.

Level 2 is on only after `enable()`. On a CUDA device each span then also
records a CUDA event at each edge, on the current stream, from a pool.
`enable()` synchronizes once, records an anchor event and reads the host
clock at that moment; each edge's device time is the anchor's host time
plus `anchor.elapsed_time(edge)`. So a span's host interval and the times
at which the card reached its edges are on one clock: `timeline()`
(which synchronizes) fills them in. A card that keeps up with the host
reaches an edge soon after the host records it; a card behind the host
reaches it later by its backlog.

Spans are recorded from one thread: the stack of open spans is the
recorder's. The module-level functions use one recorder, `RECORDER`; a
test may make its own `Recorder`.
"""

from __future__ import annotations

import collections
import time

import torch
import torch.autograd.profiler as _profiler

# The step records kept, and the spans that close outside any step, the
# oldest dropped first: a long fit, or a loop of spans with no step, grows
# no memory.
RING = 4096
PENDING_MAX = 1 << 15

_now = time.perf_counter_ns


class Span:
    """One span: `name`, `parent` (the name of the span open around it, or
    None), `step` (the id of the step record it belongs to), its host
    interval `start_ns`-`end_ns` (perf_counter_ns) and, at level 2, the
    device times at which the card reached its edges on the same clock
    (`device_start_ns`, `device_end_ns`; None until `timeline()` reads
    them). Each recorder has its own subclasses, which name it in `_rec`;
    in the one its `step(name)` makes, `_closes` is true."""

    __slots__ = ("name", "step", "start_ns", "end_ns", "_up", "_child_ns", "_dev")
    _rec: Recorder
    _closes = False

    def __init__(self, name: str):
        self.name = name
        self._child_ns = 0
        self._dev = None  # level 2: [start event, end event], then (start ns, end ns)

    @property
    def parent(self) -> str | None:
        return None if self._up is None else self._up.name

    @property
    def device_start_ns(self) -> float | None:
        return self._dev[0] if type(self._dev) is tuple else None

    @property
    def device_end_ns(self) -> float | None:
        return self._dev[1] if type(self._dev) is tuple else None

    def __enter__(self) -> Span:
        rec = self._rec
        stack = rec._stack
        self._up = stack[-1] if stack else None
        self.step = rec._step
        stack.append(self)
        self.start_ns = _now()
        if rec._level2:
            self._dev = [rec._edge(), None]
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.end_ns = end = _now()
        rec = self._rec
        if self._dev is not None:
            self._dev[1] = rec._edge()
        rec._stack.pop()
        # The recorder's books, written out here: this runs for every span.
        dur = end - self.start_ns
        t = rec._totals.get(self.name)
        if t is None:
            t = rec._totals[self.name] = [0, 0, 0]
        t[0] += 1
        t[1] += dur
        t[2] += dur - self._child_ns
        if self._up is not None:
            self._up._child_ns += dur
        rec._pending.append(self)
        if self._closes:
            rec._close_step(self.name)
        return False


class StepRecord:
    """The spans that closed during one step (the step span last), the
    counters' changes over them, the name of the step span (`kind`), and
    whether a torch.profiler profile was recording when it closed."""

    __slots__ = ("step", "kind", "profiled", "spans", "counts")

    def __init__(self, step: int, kind: str, profiled: bool, spans: list, counts: dict):
        self.step, self.kind, self.profiled = step, kind, profiled
        self.spans, self.counts = spans, counts

    def find(self, name: str) -> Span | None:
        """The first span of `name` in the record."""
        return next((s for s in self.spans if s.name == name), None)

    def host_ms(self, *names: str) -> float:
        """Host milliseconds of the record's spans of these names, summed."""
        return sum(s.end_ns - s.start_ns for s in self.spans if s.name in names) * 1e-6


class Recorder:
    """Spans, counters and step records of one process (see the module's
    docstring)."""

    def __init__(self):
        # span(name) and step(name) are classes: one call less a span than
        # a method.
        self.span = type("Span", (Span,), {"__slots__": (), "_rec": self})
        self.step = type("Step", (Span,), {"__slots__": (), "_rec": self, "_closes": True})
        self.reset()

    def reset(self) -> None:
        """Forget every span, counter and record; level 2 off."""
        self._stack: list[Span] = []
        self._records = collections.deque(maxlen=RING)
        self._pending = collections.deque(maxlen=PENDING_MAX)
        self._totals: dict[str, list[int]] = {}
        self._counts: dict[str, int] = {}
        self._delta: dict[str, int] = {}
        self._step = 0
        self._level2 = False
        self._anchor = None
        self._anchor_ns = 0
        self._pool: list = []

    # ----- level 1 -----

    def count(self, name: str, n: int) -> None:
        """Add n to the counter `name`."""
        self._counts[name] = self._counts.get(name, 0) + n
        self._delta[name] = self._delta.get(name, 0) + n

    def _close_step(self, kind: str) -> None:
        """A step span closed: the spans and counts since the last record
        become a record, unless a step span is still open around it."""
        if any(s._closes for s in self._stack):
            return
        self._records.append(StepRecord(self._step, kind, _profiler._is_profiler_enabled,
                                        list(self._pending), self._delta))
        self._pending.clear()
        self._delta = {}
        self._step += 1

    def step_records(self) -> list[StepRecord]:
        """The step records kept, oldest first."""
        return list(self._records)

    def totals(self) -> dict[str, tuple[int, int, int]]:
        """{name: (spans closed, total ns, self ns)}."""
        return {k: tuple(v) for k, v in self._totals.items()}

    def counters(self) -> dict[str, int]:
        """{name: the counter's total}."""
        return dict(self._counts)

    # ----- level 2 -----

    def enable(self) -> None:
        """Level 2: each span also records a CUDA event at its edges.
        Synchronizes once, to anchor the card's clock to the host's."""
        if not torch.cuda.is_available():
            raise RuntimeError("level 2 records CUDA events: no CUDA device is visible")
        torch.cuda.synchronize()
        self._convert()  # edges of an earlier anchor
        self._anchor = self._edge()
        self._anchor_ns = _now()
        self._level2 = True

    def disable(self) -> None:
        """Back to level 1; `timeline()` still reads the edges recorded."""
        self._level2 = False

    def _edge(self):
        """An event from the pool, recorded on the current stream."""
        ev = self._pool.pop() if self._pool else torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _held(self) -> list[Span]:
        return [s for r in self._records for s in r.spans] + list(self._pending)

    def _convert(self) -> None:
        """Device times of the edges recorded (their events complete), the
        events back to the pool."""
        anchor, base = self._anchor, self._anchor_ns
        for s in self._held():
            if type(s._dev) is list:
                a, b = s._dev
                s._dev = (base + anchor.elapsed_time(a) * 1e6,
                          base + anchor.elapsed_time(b) * 1e6)
                self._pool += (a, b)

    def timeline(self) -> list[Span]:
        """Every span held (the records' and those since the last step),
        in the order they closed, with the device times of the edges
        recorded at level 2 filled in. Synchronizes when there are any."""
        if self._anchor is not None:
            torch.cuda.synchronize()
            self._convert()
        return self._held()


RECORDER = Recorder()
span = RECORDER.span  # span(name): a context manager timing its block
step = RECORDER.step  # step(name): a span that closes a step record
count = RECORDER.count
step_records = RECORDER.step_records
totals = RECORDER.totals
counters = RECORDER.counters
enable = RECORDER.enable
disable = RECORDER.disable
timeline = RECORDER.timeline
reset = RECORDER.reset
