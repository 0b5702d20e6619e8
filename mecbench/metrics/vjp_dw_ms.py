"""Device milliseconds a training step inside the MEC VJP's kernel
gradient (the port's span ``mec_vjp.dw``: on CUDA tensors one K6 launch,
``wgrad_kernel``, and ``wgrad_sum_kernel`` where the positions are split),
from the readers' profiled pass: the durations of the kernels launched
inside the span, summed."""
from mecbench.spans import device_ms


def read(trace):
    return device_ms(trace, "mec_vjp.dw")
