"""The decode step as one program: the port's counterpart of the JAX
package's jitted decode (``repro.launch.serve`` and
``repro.serving.scheduler`` compile it once with ``jax.jit``).

:class:`DecodeProgram` runs one decode step over fixed buffers: a cache
whose buffers the step writes in place (every ported family's
``models.serve.decode_step`` and the batcher's ``batched_decode_step``
do), a (B, 1) token buffer the caller fills before each call, and the
cache's position counter (``len``, or the batcher's per-slot ``lens``),
which the step returns as a new tensor and the program copies back into
the cache's own.  On the card the step is captured once as a CUDA graph
and each call is one replay; on the CPU each call runs it eagerly.  Both
leave the cache as the eager ``decode_step`` leaves it, and return the
(B, V) f32 logits.

The capture follows ``serving.conv_service``'s class executors: one eager
run on a side stream (it initialises the libraries' handles and warms the
allocator), then ``torch.cuda.graph``.  The eager run goes over a clone of
the cache, because a decode step is not idempotent (the hybrid family's
Mamba2 state and conv history advance a token; the counter advances), and
reads token 0, since the token buffer may not hold ids yet; the capture
itself runs nothing.  So the first replay starts from the cache the
caller built.  Nothing in a step reads a device value on the host, so the
whole step is captured; a capture that fails raises, and there is no
eager fallback on the card.

A capture records the span ``decode_program.capture`` and a replay
``decode_program.replay``, host bounds around the graph's launch; the
process's captures and replays are counted (:func:`counts`, read by
``obs.counters``).

A replay overwrites the logits buffer of the previous one: consume (or
clone) them before the next call.  The graph's private memory pool keeps
the step's transients (for a dense model, the f32 copy of the LM head in
``models.serve._logits_last``) alive for the program's lifetime.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import obs
from repro_torch.models.lm import tree_map

__all__ = ["DecodeProgram", "counts"]

#: CUDA graphs captured and replayed by the process's decode programs
_COUNTS = {"captures": 0, "replays": 0}


def counts() -> dict:
    """The decode programs' captures and replays in this process."""
    return dict(_COUNTS)


class DecodeProgram:
    """``step(cache, tokens) -> (logits, new_cache)`` over the fixed
    ``cache`` and ``tokens`` buffers, advancing ``cache[counter]`` in
    place.  ``graph`` selects the captured program (default: on a CUDA
    device) or the eager one; a graph needs a CUDA device."""

    def __init__(self, step: Callable, cache: dict, tokens: torch.Tensor,
                 counter: str = "len", graph: Optional[bool] = None):
        self.cache, self.tokens, self.counter = cache, tokens, counter
        self._step = step
        device = tokens.device
        graph = device.type == "cuda" if graph is None else graph
        if graph and device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {device}")
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.replays = 0
        self._logits: Optional[torch.Tensor] = None
        if graph:
            self._capture(device)

    def _run(self, cache: dict, tokens: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            logits, new = self._step(cache, tokens)
            cache[self.counter].copy_(new[self.counter])
        return logits

    def _capture(self, device: torch.device) -> None:
        with obs.span("decode_program.capture"):
            self._capture_graph(device)
        _COUNTS["captures"] += 1

    def _capture_graph(self, device: torch.device) -> None:
        # the eager warm-up on a clone of the cache, so the caller's cache
        # stays as built, and on token 0 (the buffer may not hold ids yet)
        scratch = tree_map(torch.clone, self.cache)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self._run(scratch, torch.zeros_like(self.tokens))
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        del scratch
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                self._logits = self._run(self.cache, self.tokens)
        except RuntimeError as e:
            raise RuntimeError(f"capturing the decode step failed: {e}") from e
        self.graph = graph

    def __call__(self) -> torch.Tensor:
        """One step from the tokens in :attr:`tokens`: the cache advanced in
        place, the (B, V) logits returned (on the card, the graph's output
        buffer)."""
        if self.graph is None:
            return self._run(self.cache, self.tokens)
        with obs.span("decode_program.replay"):
            self.graph.replay()
        self.replays += 1
        _COUNTS["replays"] += 1
        return self._logits
