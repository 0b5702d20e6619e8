"""Straggler/step-time watchdog (counterpart of
``repro.training.watchdog``; plain Python, a copy).

A host whose step time exceeds ``threshold x median`` is flagged
(counted) so an orchestrator can replace it.  Hangs are caught by a hard
deadline: ``check_deadline`` raises if a step exceeds ``hard_timeout_s``,
letting the surrounding retry loop restart from the newest checkpoint.
The step times are host-clock times: a caller that times device work
synchronises the device before ``end_step``.
"""
from __future__ import annotations

import statistics
import time
from typing import List, Optional


class StepWatchdog:
    def __init__(self, threshold: float = 2.0, window: int = 50,
                 hard_timeout_s: Optional[float] = None,
                 warmup_steps: int = 2):
        self.threshold = threshold
        self.window = window
        self.hard_timeout_s = hard_timeout_s
        self.warmup_steps = warmup_steps
        self.times: List[float] = []
        self.straggler_events = 0
        self._t0: Optional[float] = None
        self._steps_seen = 0

    def start_step(self) -> None:
        self._t0 = time.monotonic()

    def check_deadline(self) -> None:
        if (self.hard_timeout_s is not None and self._t0 is not None
                and time.monotonic() - self._t0 > self.hard_timeout_s):
            raise TimeoutError(
                f"step exceeded hard timeout {self.hard_timeout_s}s")

    def end_step(self) -> float:
        dt = time.monotonic() - self._t0
        self._steps_seen += 1
        if self._steps_seen > self.warmup_steps:   # skip the first steps
            self.times.append(dt)
            self.times = self.times[-self.window:]
            if len(self.times) >= 5:
                med = statistics.median(self.times)
                if dt > self.threshold * med:
                    self.straggler_events += 1
        return dt

    @property
    def median(self) -> float:
        return statistics.median(self.times) if self.times else 0.0
