"""wait_ms.train: host milliseconds a window step waits in the read of its
loss (the program's span train.loss_read in Trainer.train_batch) for the
card to finish the step: the card's work that the host's issue did not
hide. The median over the window's steps."""

from litbench.program_spans import median_ms


def read(trace: dict) -> float | None:
    return median_ms(trace, "train.loss_read")
