"""Busy device milliseconds of one captured decode step: the port's span
``decode_program.replay`` given the durations of the graph's kernels by
``obs.attribute``, over the replays of the traced run's recorded pass;
the steady statistic beside ``decode_tokens_per_s``."""
from mecbench.lm_trace import span_device_ms


def read(trace):
    if trace.get("loop") != "decode":
        return None
    return span_device_ms(trace, "decode_program.replay")
