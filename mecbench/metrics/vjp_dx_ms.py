"""Device milliseconds a training step inside the MEC VJP's input
gradient (the port's span ``mec_vjp.dx``: the cotangent dilated and
padded, the kernel flipped, the transposed conv's lowering and row GEMMs,
the crop), from the readers' profiled pass: the durations of the kernels
launched inside the span, summed."""
from mecbench.spans import device_ms


def read(trace):
    return device_ms(trace, "mec_vjp.dx")
