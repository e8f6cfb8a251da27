"""issue_ms.train: host milliseconds a window step spends issuing its work,
from the program's spans train.forward, train.backward and train.optimizer
(Trainer.gradients, Trainer._update); the median over the window's steps."""

from litbench.program_spans import median_ms


def read(trace: dict) -> float | None:
    return median_ms(trace, "train.forward", "train.backward", "train.optimizer")
