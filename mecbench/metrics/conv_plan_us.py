"""Host microseconds a ``conv2d`` call spends resolving its plan (the
port's span ``conv2d.plan`` around ``resolve_cached_plan``: pure Python,
no device call, so the recording profiler does not stretch it), over the
profiled steps' calls."""
from mecbench.spans import recorded


def read(trace):
    got = recorded(trace)
    if got is None:
        return None
    summary, _ = got
    plan = summary["names"].get("conv2d.plan")
    if not plan:
        return None
    return plan["host_s"] / summary["paths"]["conv2d"]["count"] * 1e6
