"""GiB the caching allocator hands out a training step inside the MEC
VJP (the port's span ``mec_vjp``: the cumulative allocated bytes at its
end less at its start, summed over the stack's convs), from the readers'
profiled pass."""
from mecbench.spans import device_pass


def read(trace):
    got = device_pass(trace)
    if got is None:
        return None
    summary, steps = got
    vjp = summary["names"].get("mec_vjp")
    if not vjp or vjp["alloc_bytes"] is None:
        return None
    return vjp["alloc_bytes"] / steps / 2 ** 30
