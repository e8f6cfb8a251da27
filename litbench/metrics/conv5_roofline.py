"""conv5_roofline: the training step's convolution kernels' share of the
card's float32 peak, in %: the FLOPs they launch a step (3 x the forward's
convolution FLOPs less the first layer's data gradient,
yardstick_kpcn.launched_flop) at 67 TFLOP/s, over the device time of every
launch of csrc/conv.cu (the forward and data-gradient kernel, the weight
gradient, the bias's partial sums, the weight's layout and the reductions)
a profiled step. None where the profile holds none of them."""

from litbench import yardstick

KERNELS = ("conv_fwd_kernel", "conv_fwd_reduce_kernel", "conv_wgrad_kernel",
           "conv_wgrad_reduce_kernel", "conv_bias_part_kernel", "conv_weight_layout_kernel")


def read(trace: dict) -> float | None:
    profile = trace.get("profile")
    if not profile or "conv_flop" not in trace:
        return None
    seconds = sum(s for name, s in profile["device_ops"] if any(k in name for k in KERNELS))
    if not seconds:
        return None
    bound = trace["conv_flop"] / yardstick.FP32_FLOP_PER_S
    return 100.0 * bound / (seconds / trace["profile_steps"])
