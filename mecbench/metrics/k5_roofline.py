"""K5 (``conv1d_kernel``, the Mamba2 conv) against its roofline in a
prefill batch: the bytes of its calls (input read, output written,
weights read; one call a Mamba2 layer) at 3.35 TB/s, over the profiled
device time of ``conv1d_kernel``, in percent."""
from mecbench.common import kernel_time
from mecbench.yardstick import lm, peaks


def read(trace):
    if trace.get("loop") != "prefill" or trace.get("profile") is None:
        return None
    secs, count = kernel_time(trace, "conv1d_kernel")
    if count == 0 or secs <= 0:
        return None
    one = lm.k5_bytes(trace["config"], trace["batch"], trace["prompt_len"],
                      trace["dtype"])
    return 100.0 * one * count / peaks.HBM_BYTES_PER_S / secs
