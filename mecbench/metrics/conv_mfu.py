"""The stack's operations over the traced run's whole window (forward, or
three times it for a training step), against the card's peak for the
dtype (bf16 989 TFLOP/s, f32 as TF32 495), in percent."""
from mecbench.yardstick import conv, peaks


def read(trace):
    if "geoms" not in trace or trace.get("window_s", 0) <= 0:
        return None
    flops = conv.stack_flops(trace["geoms"], train=trace["train"])
    rate = flops * trace["steps"] / trace["window_s"]
    return 100.0 * rate / peaks.PEAK_FLOPS[trace["dtype"]]
