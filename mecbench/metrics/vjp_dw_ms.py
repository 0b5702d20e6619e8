"""Device milliseconds a training step inside the MEC VJP's kernel
gradient (the port's span ``mec_vjp.dw``: the input's lowering, the k_h
einsums over strided views of L, the stack), from the readers' profiled
pass: the durations of the kernels launched inside the span, summed."""
from mecbench.spans import device_ms


def read(trace):
    return device_ms(trace, "mec_vjp.dw")
