"""Operands and timing for the planner's measured policy (the two
functions of ``repro.bench.harness`` it calls; the rest of the harness is
ROADMAP Queue 1 item 7)."""
from __future__ import annotations

import functools
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.convspec import ConvSpec


def make_arrays(s: ConvSpec, dtype="float32", seed: int = 0,
                device="cuda"):
    """Deterministic NHWC input and HWIO kernel for a spec: the JAX
    package's ``np.random.RandomState`` draws, then cast to ``dtype`` on
    ``device``."""
    rng = np.random.RandomState(seed)
    inp = rng.randn(s.i_n, s.i_h, s.i_w, s.i_c).astype(np.float32)
    ker = rng.randn(s.k_h, s.k_w, s.i_c, s.k_c).astype(np.float32)
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return (torch.from_numpy(inp).to(device, dtype),
            torch.from_numpy(ker).to(device, dtype))


@functools.lru_cache(maxsize=None)
def _sleep_cycles_per_ms(device: int) -> float:
    """``torch.cuda._sleep`` cycles a millisecond on ``device``, from one
    timed sleep."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(10 ** 7)
    end.record()
    torch.cuda.synchronize()
    return 10 ** 7 / start.elapsed_time(end)


def slept_event_ms(run, iters: int, margin_ms: float) -> List[float]:
    """Device time (ms) of ``iters`` calls of a nullary ``run`` that has
    already been warmed up, each between one pair of CUDA events on the
    current device and stream, with the host's work hidden: before each
    start event the device sleeps for twice the host's time to enqueue one
    ``run()`` plus ``margin_ms``, so the events do not read the host's
    Python and launch overhead."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = int(_sleep_cycles_per_ms(torch.cuda.current_device())
                 * (2 * host_ms + margin_ms))
    pairs = []
    for _ in range(max(iters, 1)):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(cycles)
        start.record()
        run()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in pairs]


def time_compiled(call, iters: int = 3, warmup: int = 1) -> Dict:
    """Steady-state stats (microseconds) of a nullary call returning a
    tensor.

    On a CUDA tensor each call is timed by :func:`slept_event_ms`, the
    device's time alone (the host's time to enqueue a conv2d call, ~0.1 ms
    on the card, is as long as the shorter kernels themselves).  Otherwise
    each call is timed with the host clock (CPU work is synchronous).
    ``us_std`` and ``us_rel_spread`` (std over median) are the jitter the
    planner's noise margin is held against."""
    out = None
    for _ in range(max(warmup, 1)):
        out = call()
    if isinstance(out, torch.Tensor) and out.is_cuda:
        with torch.cuda.device(out.device):
            us = [ms * 1e3 for ms in slept_event_ms(call, iters, 0.05)]
    else:
        us: List[float] = []
        for _ in range(max(iters, 1)):
            t0 = time.perf_counter()
            call()
            us.append((time.perf_counter() - t0) * 1e6)
    median = float(np.median(us))
    std = float(np.std(us))
    return {"iters": max(iters, 1), "warmup": max(warmup, 1),
            "us_median": median, "us_min": float(min(us)),
            "us_mean": float(np.mean(us)), "us_std": std,
            "us_rel_spread": (std / median if median > 0 else None)}
