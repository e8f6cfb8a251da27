"""sample_ms.pair: host milliseconds a window step spends issuing its batch
of pairs on the card, from the program's span data.sample
(DeviceStages.sample_pair: the draws and the gathers); the median over the
window's steps."""

from litbench.program_spans import median_ms


def read(trace: dict) -> float | None:
    return median_ms(trace, "data.sample")
