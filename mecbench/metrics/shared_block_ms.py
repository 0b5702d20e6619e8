"""Busy device milliseconds a prefill batch inside the port's spans
``lm.shared_block`` (each hybrid layer's concatenation, norms, attention,
LoRA-MLP and linear: 13 a batch), from the traced run's recorded pass of
one batch."""
from mecbench.lm_trace import span_device_ms


def read(trace):
    if trace.get("loop") != "prefill":
        return None
    return span_device_ms(trace, "lm.shared_block",
                          trace.get("profiled_steps"))
