"""The captured decode step against its roofline: the bytes the step must
move (``yardstick.lm.decode_bytes`` at the recorded replays' cache
lengths, averaged) at 3.35 TB/s, over ``decode_step_ms``, in percent."""
from mecbench.lm_trace import span_device_ms
from mecbench.yardstick import lm, peaks


def read(trace):
    if trace.get("loop") != "decode" or not trace.get("lengths"):
        return None
    ms = span_device_ms(trace, "decode_program.replay")
    if ms is None or ms <= 0:
        return None
    lengths = trace["lengths"]
    nbytes = sum(lm.decode_bytes(trace["config"], trace["batch"], n,
                                 trace["dtype"]) for n in lengths)
    return 100.0 * nbytes / len(lengths) / peaks.HBM_BYTES_PER_S / (ms * 1e-3)
