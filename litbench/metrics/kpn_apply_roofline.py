"""kpn_apply_roofline: the reconstruction kernels' share of their bound, in
%: the bytes a step's forward and backward move (yardstick_kpcn.kpn_bytes,
each tensor once) at the card's 3.35 TB/s, over the device time of the
kernels of csrc/kpn.cu (kpn_forward_kernel, kpn_backward_kernel) a
profiled step. None where the profile holds neither (a checkout from
before them)."""

from litbench import yardstick_kpcn

KERNELS = ("kpn_forward_kernel", "kpn_backward_kernel")


def read(trace: dict) -> float | None:
    profile = trace.get("profile")
    if not profile or "kpn_bytes" not in trace:
        return None
    seconds = sum(s for name, s in profile["device_ops"] if any(k in name for k in KERNELS))
    if not seconds:
        return None
    bound = trace["kpn_bytes"] / yardstick_kpcn.HBM_BYTES_PER_S
    return 100.0 * bound / (seconds / trace["profile_steps"])
