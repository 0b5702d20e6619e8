"""The decode loop's model operations over the untraced window: each
batch's prefill (``yardstick.lm.prefill_flops``) and its decode steps
(``decode_flops`` at each step's cache length), for the steps the window
ran, against the card's bf16 peak of 989 TFLOP/s, in percent."""
from mecbench.yardstick import lm, peaks


def read(trace):
    if trace.get("loop") != "decode" or trace.get("window_s", 0) <= 0:
        return None
    cfg, b, p = trace["config"], trace["batch"], trace["prompt_len"]
    g = trace["gen_len"]
    flops = 0.0
    for i in range(trace["steps"]):
        j = i % g
        flops += (lm.prefill_flops(cfg, b, p) if j == 0
                  else lm.decode_flops(cfg, b, p + j))
    return 100.0 * flops / trace["window_s"] / peaks.PEAK_FLOPS[trace["dtype"]]
