"""The prefill batches' model operations (``yardstick.lm.prefill_flops``)
over the untraced window's seconds, against the card's bf16 peak of 989
TFLOP/s, in percent."""
from mecbench.yardstick import lm, peaks


def read(trace):
    if trace.get("loop") != "prefill" or trace.get("window_s", 0) <= 0:
        return None
    flops = lm.prefill_flops(trace["config"], trace["batch"],
                             trace["prompt_len"]) * trace["steps"]
    return 100.0 * flops / trace["window_s"] / peaks.PEAK_FLOPS[trace["dtype"]]
