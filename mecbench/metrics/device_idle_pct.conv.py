"""Share of a step in which no operation ran on the device, in percent
(the conv stack's cells): the device's busy seconds a step, from the
profiled steps' trace (the pass that traces the device alone), against
the seconds a step of the same run's untraced window.  The profiler
stretches the host's side of the traced window, so its own window would
count that overhead as idle."""


def read(trace):
    prof = trace.get("profile")
    if prof is None or "geoms" not in trace or not trace.get("steps"):
        return None
    busy = prof["busy_s"] / trace["profiled_steps"]
    return 100.0 * (1.0 - busy / (trace["window_s"] / trace["steps"]))
