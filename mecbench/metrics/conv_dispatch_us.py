"""Host microseconds a ``conv2d`` call, mean over the traced run's span
window (each step followed by a synchronisation, so the launch queue is
empty and the span times the host's own work)."""


def read(trace):
    spans = trace.get("spans", {}).get("conv2d")
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e6
