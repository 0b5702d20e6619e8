"""Busy device milliseconds a prefill batch inside the port's span
``mamba2.ssd`` (the Mamba2 layers' chunked scans): the durations of the
kernels launched inside it, summed by ``obs.attribute`` over the traced
run's recorded pass of one batch."""
from mecbench.lm_trace import span_device_ms


def read(trace):
    if trace.get("loop") != "prefill":
        return None
    return span_device_ms(trace, "mamba2.ssd", trace.get("profiled_steps"))
