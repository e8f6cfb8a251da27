"""batch_ms.train: host milliseconds a window step spends on its batch, from
the program's spans: making it (data.batch, in DenoiserDataset.batches),
choosing its channel (data.channel) and copying it to the card (train.h2d,
both in Trainer.select_random_channel); the median over the window's
steps."""

from litbench.program_spans import median_ms


def read(trace: dict) -> float | None:
    return median_ms(trace, "data.batch", "data.channel", "train.h2d")
