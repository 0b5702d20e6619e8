"""The paper-figure drivers (counterpart of ``benchmarks/``), thin over
``repro_torch.bench``; each runs as ``python -m
repro_torch.benchmarks.<name>`` and prints the JAX package's
``table,name,us_per_call,derived`` CSV lines, or ``--format json``.

This module re-exports what ``benchmarks/convbench.py`` re-exports: the
layer tables and the timing helpers.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.bench.harness import make_arrays, time_compiled  # noqa: F401
from repro_torch.bench.scenarios import (CV_LAYERS,  # noqa: F401
                                         RESNET101_WEIGHTS, layer_spec)
from repro_torch.core.convspec import ConvSpec


def spec(name: str, batch: int = 1) -> ConvSpec:
    return layer_spec(name, batch=batch)


def time_us(fn: Callable, iters: int = 3, warmup: int = 1) -> float:
    """Median microseconds a call (device time on the card)."""
    return time_compiled(fn, iters=iters, warmup=warmup)["us_median"]
