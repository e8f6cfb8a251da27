"""gap_ms.train: the card's idle milliseconds between window steps, without
the profiler, from the program's spans: the host time from the end of a
step's loss read (train.loss_read: the stream is empty when it ends) to the
start of the next step's copy to the card (train.h2d: the card's next work).
The median over consecutive window steps."""

import statistics

from litbench.program_spans import window_records


def read(trace: dict) -> float | None:
    records = window_records(trace)
    if records is None or len(records) < 2:
        return None
    gaps = []
    for a, b in zip(records, records[1:]):
        read_, copy = a.find("train.loss_read"), b.find("train.h2d")
        if read_ is None or copy is None:
            return None
        gaps.append((copy.start_ns - read_.end_ns) * 1e-6)
    return statistics.median(gaps)
