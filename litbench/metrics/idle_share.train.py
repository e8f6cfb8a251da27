"""idle_share.train: the share of the profiled training steps' wall time in
which no operation ran on the device, in %."""


def read(trace: dict) -> float | None:
    profile = trace.get("profile")
    if not profile or "step_flop" not in trace:
        return None
    return 100.0 * (1.0 - profile["busy_s"] / profile["window_s"])
