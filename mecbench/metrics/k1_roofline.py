"""K1 (``fused_kernel``) against its roofline: the forward bound of the
stack's convs (the larger of their products at the dtype's tensor-core
peak and each input, kernel and output byte moved once over HBM), times
the profiled steps, over the profiled device time of ``fused_kernel``,
in percent."""
from mecbench.common import kernel_time
from mecbench.yardstick import conv


def read(trace):
    if trace.get("profile") is None or trace.get("train") is not False:
        return None
    secs, count = kernel_time(trace, "fused_kernel")
    if count == 0 or secs <= 0:
        return None
    bound = conv.stack_bound_s(trace["geoms"], trace["dtype"])
    return 100.0 * bound * trace["profiled_steps"] / secs
