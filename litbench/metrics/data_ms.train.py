"""data_ms.train: host wall milliseconds a step spends making the batch
(DenoiserDataset.batches) and moving it to the card
(Trainer.select_random_channel), the mean over the traced window's steps."""


def read(trace: dict) -> float | None:
    ms = trace.get("data_ms")
    return sum(ms) / len(ms) if ms else None
