"""train_mfu: the training step's share of the card's float32 peak, in %:
three times the UNet's forward convolution FLOPs (yardstick.unet_flop at the
step's batch and crop: forward, and backward to the inputs and to the
weights) over the mean step time of the traced window, against 67 TFLOP/s
(the configuration runs float32 with TF32 off)."""

from litbench import yardstick


def read(trace: dict) -> float | None:
    if "step_flop" not in trace or not trace.get("step_s"):
        return None
    return 100.0 * trace["step_flop"] / trace["step_s"] / yardstick.FP32_FLOP_PER_S
