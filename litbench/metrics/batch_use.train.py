"""batch_use.train: the share of the bytes of the window's batches that reach
the card, in %: the program's counters train.h2d_bytes (the copies in
Trainer.select_random_channel) over data.batch_bytes (the arrays
DenoiserDataset.batches yields), summed over the window's steps."""

from litbench.program_spans import window_records


def read(trace: dict) -> float | None:
    records = window_records(trace)
    if records is None:
        return None
    made = sum(r.counts.get("data.batch_bytes", 0) for r in records)
    used = sum(r.counts.get("train.h2d_bytes", 0) for r in records)
    return 100.0 * used / made if made else None
