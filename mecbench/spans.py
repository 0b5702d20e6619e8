"""What the readers of the port's own spans share.

``recorded`` is the span summary of ``repro_torch.obs`` as the traced run
left it.  The spans record, host bounds only, while any profiler session
records, so they cover the profiled passes of ``common.profile`` (one or
both, as the port's check of a recording profiler sees them) and nothing
else; the steps are the ``conv2d`` calls at the top of a span tree over
the stack's convs.  ``conv_plan_us`` reads it.

``device_pass`` is a profiled pass of its own, made once the traced run
has ended, for the readers of the MEC VJP: the training stack's step on
one input set drawn anew, under ``obs.recording()`` and a profiler that
traces host and card, so that each span opens its ``repro_torch.`` range
and reads the allocator, and ``obs.attribute`` gives each span the summed
durations of the kernels launched inside it.  That is busy device time: a
card that waits for the host inside a span does not count, and the
benchmark's own passes stay unmarked.

A port without ``repro_torch.obs`` (or without ``attribute``), a run
that recorded no ``conv2d`` call, or a run off the card gives nothing.
"""

#: steps of the training stack in the readers' profiled pass, after one
#: step that warms the allocator
DEVICE_STEPS = 2
#: the operands' seed (their values do not move a time)
SEED = 1

_passes = {}


def recorded(trace):
    """(the port's span summary, steps it covers), or None."""
    if not trace.get("geoms"):
        return None
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return _per_step(obs.summary(), trace)


def _per_step(summary, trace):
    calls = summary["paths"].get("conv2d")
    if not calls or not calls["count"]:
        return None
    return summary, calls["count"] / len(trace["geoms"])


def device_pass(trace):
    """(the span summary of the readers' profiled pass of the training
    stack, steps it covers), or None; made once a traced run."""
    # the trace is kept beside its pass, so that its id is not reused
    got = _passes.get(id(trace))
    if got is None or got[0] is not trace:
        got = _passes[id(trace)] = (trace, _device_pass(trace))
    return got[1]


def _device_pass(trace):
    if recorded(trace) is None or not trace.get("train"):
        return None
    summary = _profiled(trace)
    return None if summary is None else _per_step(summary, trace)


def _profiled(trace, device=None):
    """The span summary of DEVICE_STEPS steps of the training stack on
    ``device`` (the card where there is one, else nothing is made) under
    ``obs.recording()`` and a profiler of host and card, each span given
    its kernels' time; None with a port that cannot."""
    import torch
    from repro_torch import obs
    if not hasattr(obs, "attribute"):
        return None
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda")
    from torch.profiler import ProfilerActivity, profile

    from mecbench.drivers.conv_stack import Stack, make_operands
    algorithms = {r["attrs"].get("algorithm") for r in obs.records()
                  if r["name"] == "conv2d" and r["parent"] is None}
    if len(algorithms) != 1:
        return None
    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])

    def sync():
        if cuda:
            torch.cuda.synchronize()

    geoms = [(None, tuple(g)) for g in trace["geoms"]]
    ops = make_operands(geoms, getattr(torch, trace["dtype"]), 1, SEED,
                        device, True)
    stack = Stack(geoms, ops, algorithms.pop(), True)
    stack(0)
    sync()
    obs.reset()
    with obs.recording(), profile(activities=activities) as prof:
        for _ in range(DEVICE_STEPS):
            stack(0)
        sync()
    obs.attribute(prof)
    return obs.summary()


def device_ms(trace, name):
    """Device milliseconds a step inside the spans named ``name``, from
    the readers' profiled pass."""
    got = device_pass(trace)
    if got is None:
        return None
    summary, steps = got
    stats = summary["names"].get(name)
    if not stats or stats["device_s"] is None:
        return None
    return stats["device_s"] / steps * 1e3
