"""What the drivers share: the run's context, host spans, the profiler's
reading, the token window of the LM rates, the import check and the
comparison verdict.

Nothing here imports the port: the drivers do, after ``run.py`` has set
the environment up.
"""
from __future__ import annotations

import collections
import dataclasses
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

#: top-level module names that no run may load: the JAX package and JAX
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Context:
    """One run of one cell: what the driver needs, from ``run.py``."""
    workload: str
    config_name: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_start: float = dataclasses.field(default_factory=time.perf_counter)
    reference: Optional[object] = None     # the config's reference module
    #: also compute the control's numbers (``control.py``; never in a run)
    control: bool = False


@dataclasses.dataclass
class Check:
    """One number compared, beside its limit (lower is better)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Result:
    """What a driver returns: end-to-end values, the traced run's record
    (None in a run without ``--trace``), the comparisons, the work
    attempted and failed."""
    metrics: Dict[str, float]
    checks: List[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Optional[dict] = None
    #: the control's numbers, beside the program's (``control.py`` only)
    control: Optional[List[Check]] = None


def forbidden_loaded(modules: Sequence[str]) -> List[str]:
    """Names in ``modules`` whose top-level package (the part before the
    first dot, compared whole) is forbidden."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN_MODULES)


def seed_stream(seed: int, stream: int) -> int:
    """A 63-bit seed for the ``stream``-th generator of a run: any whole
    number (of any size) and the stream index mix into one seed."""
    return (seed * 1_000_003 + stream * 7_919 + 17) % (2 ** 63 - 1)


class Spans:
    """Host-clock spans by name, kept in memory."""

    def __init__(self):
        self.spans: Dict[str, List[float]] = {}

    def add(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)


#: idle stretches shorter than this are launch spacing, not attributed
SHORT_GAP_US = 5.0


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _read(prof, torch) -> Tuple[dict, list, list]:
    """Kernels by name, device intervals and labelled host spans of a
    finished profile (the labels' own device-side copies left out)."""
    kernels: Dict[str, dict] = {}
    device: List[Tuple[float, float]] = []
    labels: List[Tuple[float, float, str]] = []
    for evt in prof.events():
        start, end = evt.time_range.start, evt.time_range.end
        if evt.name.startswith("mecbench."):
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                labels.append((start, end, evt.name[len("mecbench."):]))
        elif evt.device_type == torch.autograd.DeviceType.CUDA:
            device.append((start, end))
            k = kernels.setdefault(evt.name, {"device_s": 0.0, "count": 0})
            k["device_s"] += (end - start) * 1e-6
            k["count"] += 1
    return kernels, device, labels


def profile(fn: Callable[[], None], synchronize: Callable[[], None]) -> dict:
    """Run ``fn`` twice under ``torch.profiler`` and read the traces.

    The first pass traces the device alone (CUPTI), so the host runs at
    its own pace: device seconds and launches by kernel name, the union of
    the device's busy intervals and the window's host-clock length.  The
    second traces host and device, for the breakdown's idle stretches:
    each gap between busy intervals goes to the innermost labelled host
    span (``label``) open when it began; gaps under ``SHORT_GAP_US`` are
    launch spacing.  The breakdown also lists the 10 device operations
    that took most time in the first pass."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    # on a machine without a card (the tests) both passes trace the host
    traced = (ProfilerActivity.CUDA if torch.cuda.is_available()
              else ProfilerActivity.CPU)
    synchronize()
    with torch_profile(activities=[traced]) as prof:
        t0 = time.perf_counter()
        fn()
        synchronize()
        window_s = time.perf_counter() - t0
    kernels, device, _ = _read(prof, torch)
    busy = _union(device)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    del prof
    with torch_profile(activities=list({ProfilerActivity.CPU,
                                        traced})) as prof:
        fn()
        synchronize()
    _, device2, labels = _read(prof, torch)
    del prof
    labels.sort()
    busy2 = _union(device2)
    gaps: Dict[str, float] = {}
    for (_, a), (b, _) in zip(busy2, busy2[1:]):
        if b - a < SHORT_GAP_US:
            name = f"gaps under {SHORT_GAP_US:g} us between device operations"
        else:
            open_ = [lab for lab in labels if lab[0] <= a < lab[1]]
            name = (min(open_, key=lambda lab: lab[1] - lab[0])[2]
                    if open_ else "host outside the benchmark's spans")
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    ops = sorted(kernels.items(), key=lambda kv: -kv[1]["device_s"])
    return {
        "kernels": kernels,
        "busy_s": busy_s,
        "window_s": window_s,
        "breakdown": {
            "device_ops": [[name[:160], v["device_s"]] for name, v in ops[:10]],
            "idle_gaps": [[name, s] for name, s in
                          sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
        },
    }


#: steps the host keeps enqueued ahead of the card in a token window
IN_FLIGHT = 2


def token_window(step: Callable[[int], int], seconds: float,
                 device) -> Tuple[int, int, float]:
    """A closed loop of ``step(0), step(1), ...`` for ``seconds`` on the
    host's clock, then a wait for the device: (steps, tokens, window
    seconds).

    Each step enqueues its work and returns the tokens it counts: a
    prefill batch its prompt tokens, a decode step its batch's emitted
    tokens, a decode batch's own prefill none (its time is in the window,
    its prompt is not counted).  The window runs from an idle device to
    the end of the last step enqueued, so every token counted completed
    inside it.  On a card the host keeps at most ``IN_FLIGHT`` steps
    enqueued ahead of the device, so the window ends near ``seconds``."""
    import torch
    cuda = torch.device(device).type == "cuda"
    pending = collections.deque()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = tokens = 0
    while time.perf_counter() - t0 < seconds:
        tokens += step(steps)
        steps += 1
        if cuda:
            event = torch.cuda.Event()
            event.record()
            pending.append(event)
            if len(pending) > IN_FLIGHT:
                pending.popleft().synchronize()
    if cuda:
        torch.cuda.synchronize()
    return steps, tokens, time.perf_counter() - t0


def kernel_time(trace: dict, token: str) -> Tuple[float, int]:
    """(device seconds, launches) of the profiled kernels whose name holds
    ``token`` as a whole identifier."""
    import re
    pat = re.compile(r"(?<![A-Za-z0-9_])" + re.escape(token)
                     + r"(?![A-Za-z0-9_])")
    secs, count = 0.0, 0
    for name, v in trace["profile"]["kernels"].items():
        if pat.search(name):
            secs += v["device_s"]
            count += v["count"]
    return secs, count


def label(name: str):
    """A host span the profiler records, read back as an idle gap's
    cause (``profile``)."""
    import torch
    return torch.profiler.record_function("mecbench." + name)


def stderr(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def log_marks(what: str, marks: List[Tuple[str, float]]) -> None:
    """Seconds between successive (name, clock) marks, on standard
    error."""
    parts = [f"{name} {b - a:.2f} s" for (_, a), (name, b)
             in zip(marks, marks[1:])]
    stderr(f"mecbench: {what}: " + ", ".join(parts))
