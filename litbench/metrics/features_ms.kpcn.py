"""features_ms.kpcn: host milliseconds a window step spends issuing KPCN's
22 input features on the card, from the program's span data.features
(nn/kpcn.features inside Trainer.kpcn_loss); the median over the window's
steps."""

from litbench.program_spans import median_ms


def read(trace: dict) -> float | None:
    return median_ms(trace, "data.features")
