"""Spans and counters recorded inside the port, kept in memory.

A span times one piece of the program: ``conv2d``, its plan resolution,
the MEC VJP and each of the VJP's pieces (the names are listed in
``PERF.md`` §3).  With tracing off, :func:`span` returns one shared
no-op object after two flag tests: the operator's switch and torch's own
flag for a recording profiler session.  A hot path (``conv2d``) tests
:func:`tracing` once instead and opens no span at all while it is off.

Tracing is on while the operator has turned it on (:func:`enable`,
:func:`disable`, or :func:`recording` as a context manager), and while
any profiler session records, whoever started it.  A span then keeps, in
memory:

* its name, its id, its parent (the span open on the same thread: on
  CUDA, autograd runs the backward on a thread of its own) and its path
  (the names from the thread's outermost open span down to it);
* its ``cause``, the id of the ``conv2d`` call it belongs to: a span
  inherits its parent's, a backward span is handed the forward call's
  (``_MecConv`` saves it), and a span with neither is its own cause;
* host start and end (``time.perf_counter_ns``);
* its attributes (``conv2d`` notes its spec, algorithm and dtype; the
  spans inside a call take the call's spec through their cause).

Under a profiler session the program was not asked to mark, that is all:
a span costs a few microseconds of host and calls nothing of CUDA, so
the session's timeline and its idle gaps read as without the spans.

When the operator turned tracing on, a span with ``device=True`` in a
process that has initialised CUDA also reads the caching allocator's
cumulative allocated bytes at both ends (a host-side read, no CUDA call),
which counts the copies a library call makes inside the span too.  And
while a profiler session records, each span opens a
``torch.profiler.record_function("repro_torch.<name>")`` range, which
lands on the profiler's timeline beside the kernels the span launched.
:func:`attribute` then gives each span the device time of the kernels
whose launch call fell inside its range: busy time, the sum of their
durations, so a device that waits for the host inside a span does not
count.  Nothing else times the device.

:func:`summary` aggregates the spans by name, by path and by spec key;
:func:`records` returns them one by one; :func:`reset` forgets them.  At
most :data:`MAX_RECORDS` spans are kept; the rest are counted in
``dropped``.  :func:`counters` gathers what the port counts elsewhere:
kernel launches, the plan cache's lookups and disk reads, the kernel
compiles, the decode programs' CUDA graphs captured and replayed.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _torch_profiler

#: spans kept in memory at most; the rest are counted as dropped
MAX_RECORDS = 1 << 20
#: prefix of the profiler ranges the spans open when tracing is enabled
PREFIX = "repro_torch."

_enabled = False
_lock = threading.Lock()


class _Local(threading.local):
    """Each thread's open spans: set up on a thread's first use, so that
    reading it never fails (a failed ``getattr`` on a thread-local costs
    an exception, a microsecond on every call of the off path)."""

    def __init__(self):
        self.stack: List["_Span"] = []


_local = _Local()
_ids = itertools.count(1)
_records: List["_Span"] = []
_dropped = 0


class _Off:
    """The span returned while tracing is off: does nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def note(self, spec, algorithm, dtype) -> None:
        pass

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


def _allocated() -> int:
    """The caching allocator's cumulative allocated bytes on the current
    device, read through ``torch._C`` (``torch.cuda.memory_stats`` adds a
    flattened copy of every statistic to each read)."""
    stats = torch._C._cuda_memoryStats(torch.cuda.current_device())
    return stats["allocated_bytes"]["all"]["allocated"]


class _Span:
    """One recorded span (see the module's docstring)."""

    __slots__ = ("name", "id", "parent", "cause", "path", "attrs", "t0",
                 "t1", "alloc", "device_s", "self_device_s", "ranged",
                 "_range")

    def __init__(self, name: str, device: bool, cause: Optional[int]):
        self.name, self.cause, self.attrs = name, cause, {}
        self.id = next(_ids)
        # the allocator is read only where the operator asked for tracing
        self.alloc = (0 if device and _enabled and torch.cuda.is_initialized()
                      else None)
        self.device_s = self.self_device_s = self._range = None
        self.ranged = False

    def __enter__(self):
        stack = _local.stack
        top = stack[-1] if stack else None
        self.parent = top.id if top is not None else None
        if self.cause is None:
            self.cause = top.cause if top is not None else self.id
        self.path = self.name if top is None else f"{top.path}/{self.name}"
        if _enabled and _torch_profiler._is_profiler_enabled:
            self.ranged = True
            self._range = torch.profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
        if self.alloc is not None:
            self.alloc = _allocated()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.alloc is not None:
            self.alloc = _allocated() - self.alloc
        _local.stack.pop()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        _keep(self)
        return None

    def note(self, spec, algorithm, dtype) -> None:
        """Add the conv's spec (None where the call has not made one),
        algorithm and dtype to the span's attributes."""
        self.attrs.update(algorithm=algorithm, dtype=dtype)
        if spec is not None:
            self.attrs["spec"] = spec

    def set(self, **attrs) -> None:
        """Add ``attrs`` to the span's attributes."""
        self.attrs.update(attrs)


def _keep(sp: _Span) -> None:
    global _dropped
    with _lock:
        if len(_records) >= MAX_RECORDS:
            _dropped += 1
            return
        _records.append(sp)


def span(name: str, device: bool = True, cause: Optional[int] = None):
    """A context manager timing one piece of the program as ``name``.

    ``device``: the piece runs work on the card (its allocations counted
    when the operator turned tracing on), else host work only.
    ``cause``: the id of the ``conv2d`` call the piece belongs to, where
    the thread's open span does not say (a backward)."""
    # torch's own flag, set while any ``torch.profiler`` session records
    if not (_enabled or _torch_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, device, cause)


def tracing() -> bool:
    """Whether spans record now (see :func:`span`): a caller on a hot path
    checks this once and opens no span while it is False."""
    return _enabled or _torch_profiler._is_profiler_enabled


def current_cause() -> Optional[int]:
    """The cause of the innermost span open on this thread (None with no
    span open, as with tracing off)."""
    stack = _local.stack
    return stack[-1].cause if stack else None


def enable() -> None:
    """Turn tracing on: spans record, read the allocator, and mark a
    recording profiler's timeline with their ranges."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Turn the operator's switch off (spans still record, host bounds
    only, while a profiler session records)."""
    global _enabled
    _enabled = False


@contextlib.contextmanager
def recording():
    """Tracing on inside the block, as before it after."""
    global _enabled
    was = _enabled
    _enabled = True
    try:
        yield
    finally:
        _enabled = was


def reset() -> None:
    """Forget every span kept and the dropped count."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0


def _kept() -> List[_Span]:
    with _lock:
        return list(_records)


def _launched(events) -> list:
    """(host time of the launch call, device microseconds) of each piece of
    device work in a profile: a kernel, copy or fill joined to the CUDA
    runtime or driver call that launched it (the two share an id), with
    the device-side copies of ranges left out (they have no launch)."""
    cpu = torch.autograd.DeviceType.CPU
    calls = {e.id: e.time_range.start for e in events
             if e.device_type == cpu and e.name.startswith("cu")}
    cpu_names = {e.name for e in events if e.device_type == cpu}
    return sorted((calls[e.id], e.time_range.end - e.time_range.start)
                  for e in events if e.device_type != cpu
                  and e.id in calls and e.name not in cpu_names)


def _range_us(ranges, work) -> Dict[int, tuple]:
    """Per range (by ``id``): the device microseconds launched while it was
    open, and of those the part launched while no range inside it was."""
    ranges = sorted(ranges, key=lambda e: (e.time_range.start,
                                           -e.time_range.end))
    total = dict.fromkeys(map(id, ranges), 0.0)
    own = dict(total)
    stack: list = []
    i = 0
    for at, us in work:
        while i < len(ranges) and ranges[i].time_range.start <= at:
            opened = ranges[i]
            while stack and stack[-1].time_range.end < opened.time_range.start:
                stack.pop()
            stack.append(opened)
            i += 1
        while stack and stack[-1].time_range.end < at:
            stack.pop()
        if stack:
            own[id(stack[-1])] += us
            for r in stack:
                total[id(r)] += us
    return {k: (total[k], own[k]) for k in total}


def attribute(prof) -> int:
    """Give the spans that opened a range in the finished profiler session
    ``prof`` (recorded under :func:`recording`, tracing the card) their
    device time: the summed durations of the kernels, copies and fills
    whose launch call the profiler saw while the range was open, and of
    those the ones launched outside the ranges of child spans (self).
    Launches are placed by the host time of the call, so threads that
    launch work at the same time are not told apart.  The ranges of a
    name are matched, in order, to the latest spans of that name that
    opened one; a name whose counts differ is left out.  Returns the
    number of spans given a time (0 where ``prof`` traced no device
    work)."""
    cpu = torch.autograd.DeviceType.CPU
    events = prof.events()
    work = _launched(events)
    if not work:
        return 0
    ranges: Dict[str, list] = collections.defaultdict(list)
    for e in events:
        if e.device_type == cpu and e.name.startswith(PREFIX):
            ranges[e.name[len(PREFIX):]].append(e)
    times = _range_us([e for evts in ranges.values() for e in evts], work)
    spans: Dict[str, list] = collections.defaultdict(list)
    for sp in _kept():
        if sp.ranged:
            spans[sp.name].append(sp)
    given = 0
    for name, evts in ranges.items():
        mine = sorted(spans[name], key=lambda sp: sp.t0)[-len(evts):]
        if len(mine) != len(evts):
            continue
        evts.sort(key=lambda e: e.time_range.start)
        for sp, e in zip(mine, evts):
            total, own = times[id(e)]
            sp.device_s, sp.self_device_s = total * 1e-6, own * 1e-6
        given += len(evts)
    return given


def _spec_key(spec) -> str:
    from repro_torch.plan.convplan import spec_key
    return spec_key(spec)


def _attrs(sp: _Span) -> dict:
    out = dict(sp.attrs)
    if "spec" in out:
        out["spec"] = _spec_key(out["spec"])
    if "dtype" in out:
        out["dtype"] = str(out["dtype"]).replace("torch.", "")
    return out


def records() -> List[dict]:
    """Every span kept, in the order they ended, as plain dicts (host
    times in nanoseconds of ``perf_counter_ns``; ``device_s`` None until
    :func:`attribute` gives it, ``alloc_bytes`` None where the allocator
    was not read)."""
    return [{"name": sp.name, "id": sp.id, "parent": sp.parent,
             "cause": sp.cause, "path": sp.path, "t0_ns": sp.t0,
             "t1_ns": sp.t1, "device_s": sp.device_s,
             "alloc_bytes": sp.alloc, "attrs": _attrs(sp)}
            for sp in _kept()]


def _empty() -> dict:
    return {"count": 0, "host_s": 0.0, "self_host_s": 0.0, "device_s": None,
            "self_device_s": None, "alloc_bytes": None}


def _add(stats: dict, sp: _Span, child_host: int) -> None:
    stats["count"] += 1
    host = sp.t1 - sp.t0
    stats["host_s"] += host * 1e-9
    stats["self_host_s"] += (host - child_host) * 1e-9
    if sp.device_s is not None:
        stats["device_s"] = (stats["device_s"] or 0.0) + sp.device_s
        stats["self_device_s"] = ((stats["self_device_s"] or 0.0)
                                  + sp.self_device_s)
    if sp.alloc is not None:
        stats["alloc_bytes"] = (stats["alloc_bytes"] or 0) + sp.alloc


def summary() -> dict:
    """The spans kept, aggregated: ``names`` and ``paths`` map a span name
    or path to its ``count``, ``host_s``, ``self_host_s`` (less the part
    its child spans cover), ``device_s`` and ``self_device_s`` (the part
    launched outside child spans; None where no span was given a device
    time) and ``alloc_bytes`` (None where the
    allocator was not read); ``by_spec`` maps a conv's spec key to the
    same by path; ``dropped`` counts the spans not kept."""
    spans = _kept()
    child_host: Dict[int, int] = collections.Counter()
    specs = {}
    for sp in spans:
        if sp.parent is not None:
            child_host[sp.parent] += sp.t1 - sp.t0
        if "spec" in sp.attrs:
            specs[sp.id] = sp.attrs["spec"]
    names: Dict[str, dict] = {}
    paths: Dict[str, dict] = {}
    by_spec: Dict[str, Dict[str, dict]] = {}
    for sp in spans:
        ch = child_host[sp.id]
        _add(names.setdefault(sp.name, _empty()), sp, ch)
        _add(paths.setdefault(sp.path, _empty()), sp, ch)
        spec = sp.attrs.get("spec", specs.get(sp.cause))
        if spec is not None:
            group = by_spec.setdefault(_spec_key(spec), {})
            _add(group.setdefault(sp.path, _empty()), sp, ch)
    with _lock:
        dropped = _dropped
    return {"names": names, "paths": paths, "by_spec": by_spec,
            "dropped": dropped}


def counters() -> dict:
    """What the port counts, read where it is counted: the kernel
    wrappers' launches, the process plan cache's hits, misses, disk loads
    and I/O errors, the kernel compiles ``kernels.build.build`` ran in
    this process with their seconds, and the CUDA graphs of
    ``serving.step_graph.DecodeProgram`` captured and replayed."""
    from repro_torch.kernels import build, mec_conv, mec_conv1d
    from repro_torch.plan.cache import global_plan_cache
    from repro_torch.serving import step_graph
    cache = global_plan_cache()
    return {"launches": dict(mec_conv.launch_counts(),
                             mec_conv1d=mec_conv1d.mec_conv1d.launches),
            "plan_cache": {"hits": cache.hits, "misses": cache.misses,
                           "disk_loads": cache.disk_loads,
                           "io_errors": cache.io_errors},
            "nvcc": {"compiles": build.build.compiles,
                     "seconds": build.build.seconds},
            "decode_program": step_graph.counts()}
