"""Warm-plan conv serving (counterpart of ``repro.serving.conv_service``).

MEC's per-shape lowering decision (paper Table 2: no single algorithm
wins everywhere) pays off in production only if its setup cost amortizes
across requests.  The planner (``repro_torch.plan``) produces a frozen,
cacheable :class:`~repro_torch.plan.ConvPlan`; this module cashes it in
under live traffic:

* :class:`ShapeClass` / :meth:`ConvService.bucket`: a *bounded* set of
  padded input shape classes.  A variable ``(n, h, w)`` request maps
  deterministically to the smallest class that contains it (padding never
  shrinks a dimension); one plan per class, not per request shape.
* :meth:`ConvService.warm`: at startup, resolve the plan of every class
  through the persistent plan cache (``plan_conv2d(mode="cached")``) and
  build the class executor.  Best-effort: an unreadable, corrupt or
  read-only ``$REPRO_TORCH_PLAN_CACHE_DIR`` degrades to analytic planning
  with a warning *counter*, never a crash.
* :meth:`ConvService.execute`: bucket, zero-pad into the class, run the
  class executor, copy the request's true output back out.  A class the
  service was never warmed for resolves and builds lazily (the "cold"
  path of the bench ``serve`` suite).

A class executor owns a class-shaped static input buffer.  On a CUDA
kernel it is a captured ``torch.cuda.CUDAGraph`` of ``conv2d(plan=)``
from that buffer to a static output (the counterpart of the JAX
package's jit plus one throwaway execution): the kernels are built and
run once eagerly, then captured, and each request is one replay.  On the
CPU it is a plain call of the same ``conv2d(plan=)``.  Each request
writes its data into the buffer and zeroes the rest of it (the previous
request's data stays there otherwise), and gets a copy of its slice of
the output, never a view the next replay overwrites.  A replay computes
the same bits as the eager ``conv2d(plan=)`` on the same padded input.

A wrapper's launch count (``kernels.mec_conv``) counts the eager warm-up
run and the capture; a replay launches the captured kernels without
Python, so the service counts its replays per class (:attr:`replays`).

Padding must be ``"VALID"``, an int, or explicit ``((lo, hi), (lo,
hi))``: ``"SAME"`` derives its pad split from the input size, so a
request and its padded class would disagree on window alignment.  With
size-independent pads the slice is exact: every output element the
request needs reads only rows and columns that hold the same values in
the padded class input (real data, then zeros either way).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core.conv_api import Padding, conv2d
from repro_torch.core.convspec import (ConvSpec, normalize_stride,
                                       padding_amounts)
from repro_torch.models.layers import init_normal

__all__ = [
    "ShapeClass", "ConvService", "WarmupReport", "parse_shape_classes",
    "fit_prefix", "whisper_frontend_kernels", "whisper_frontend_service",
    "patch_embed_service",
]


@dataclasses.dataclass(frozen=True, order=True)
class ShapeClass:
    """One padded input class: requests with ``n <= n_, h <= h_, w <= w_``
    are zero-padded up to exactly this shape and share one ConvPlan.
    Ordering is (n, h, w), the bucketing tie-break."""

    n: int
    h: int
    w: int

    def contains(self, n: int, h: int, w: int) -> bool:
        return n <= self.n and h <= self.h and w <= self.w

    def tag(self) -> str:
        return f"{self.n}x{self.h}x{self.w}"


def parse_shape_classes(text: str) -> Tuple[ShapeClass, ...]:
    """``"1x32x32,4x64x64"`` -> ShapeClass tuple (the ``--shape-classes``
    format of ``launch.serve`` and ``python -m repro_torch.serving``)."""
    classes = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        dims = part.split("x")
        if len(dims) != 3:
            raise ValueError(f"shape class {part!r} is not NxHxW")
        classes.append(ShapeClass(*(int(d) for d in dims)))
    if not classes:
        raise ValueError(f"no shape classes in {text!r}")
    return tuple(classes)


@dataclasses.dataclass
class WarmupReport:
    """What :meth:`ConvService.warm` did: the serve report and the
    ``--warmup-report`` CLI both render from this."""

    classes: List[ShapeClass] = dataclasses.field(default_factory=list)
    plans: Dict[ShapeClass, "object"] = dataclasses.field(
        default_factory=dict)
    warnings: List[str] = dataclasses.field(default_factory=list)
    plan_cache_io_errors: int = 0
    warm_seconds: float = 0.0

    @property
    def warning_count(self) -> int:
        return len(self.warnings)

    def summary(self) -> str:
        return (f"warmed {len(self.plans)}/{len(self.classes)} shape "
                f"class(es) in {self.warm_seconds:.2f}s; "
                f"{self.warning_count} warning(s), "
                f"{self.plan_cache_io_errors} plan-cache I/O error(s)")

    def render(self) -> str:
        lines = [self.summary()]
        for w in self.warnings:
            lines.append(f"  warning: {w}")
        for cls in sorted(self.plans):
            plan = self.plans[cls]
            lines.append(f"-- class {cls.tag()} --")
            lines.extend("  " + ln for ln in plan.explain().splitlines())
        return "\n".join(lines)


class _ClassExecutor:
    """A class's static input buffer and the call that convolves it into
    its static output: a CUDA graph replay, or a plain call on the CPU."""

    def __init__(self, static_in: torch.Tensor, run: Callable[[], torch.Tensor],
                 graph: Optional["torch.cuda.CUDAGraph"] = None,
                 static_out: Optional[torch.Tensor] = None):
        self.static_in = static_in
        self._run = run
        self.graph = graph
        self.static_out = static_out

    def __call__(self) -> torch.Tensor:
        if self.graph is None:
            return self._run()
        self.graph.replay()
        return self.static_out


class ConvService:
    """One convolution served over a bounded set of padded shape classes.

    kernel: HWIO weights (the service owns them; their device is the
    service's, and on a CUDA device the plans and executors are the
    card's).  stride/padding: the fixed geometry every class shares;
    padding must be size-independent (VALID / int / explicit pair).
    classes: the bounded shape-class set ((n, h, w) tuples or
    :class:`ShapeClass`), each admitting at least one output window.
    plan_mode: the policy for :func:`repro_torch.plan.plan_conv2d` at
    warmup ("cached" keeps decisions across restarts).
    """

    def __init__(self, kernel: torch.Tensor, *, stride=1,
                 padding: Padding = "VALID",
                 classes: Sequence[Union[ShapeClass, Tuple[int, int, int]]],
                 plan_mode: str = "cached"):
        if isinstance(padding, str) and padding.upper() == "SAME":
            raise ValueError(
                "ConvService cannot serve SAME padding: its pad split "
                "depends on the input size, so a request and its padded "
                "class would disagree; pass the explicit ((lo, hi), "
                "(lo, hi)) pads instead")
        self.kernel = kernel.detach()
        self.stride = normalize_stride(stride)
        self.padding = padding
        self.plan_mode = plan_mode
        self.dtype = str(kernel.dtype).replace("torch.", "")
        norm = []
        for c in classes:
            cls = c if isinstance(c, ShapeClass) else ShapeClass(*c)
            if min(cls.n, cls.h, cls.w) < 1:
                raise ValueError(f"shape class {cls} has a non-positive "
                                 "dimension")
            norm.append(cls)
        # Sorted ascending: bucket() takes the FIRST containing class, so
        # the smallest wins and the map is deterministic.  Duplicates would
        # make "exactly one class" ambiguous.
        self.classes: Tuple[ShapeClass, ...] = tuple(sorted(set(norm)))
        if len(self.classes) != len(norm):
            raise ValueError(f"duplicate shape classes in {classes!r}")
        for cls in self.classes:
            self.class_spec(cls).validate()   # every class must be servable
        self._plans: Dict[ShapeClass, object] = {}
        self._compiled: Dict[ShapeClass, _ClassExecutor] = {}
        self._out_shapes: Dict[Tuple[int, int, int], Tuple[int, ...]] = {}
        self.replays: Dict[ShapeClass, int] = {c: 0 for c in self.classes}
        self.warmup = WarmupReport(classes=list(self.classes))

    @property
    def device(self) -> torch.device:
        return self.kernel.device

    # ------------------------------------------------------------ bucketing

    def bucket(self, shape: Sequence[int]) -> ShapeClass:
        """The one class serving this request shape: the smallest (by
        (n, h, w) order) class containing it.  Anything larger is a loud
        error: serving never silently grows a class."""
        if len(shape) == 4:
            n, h, w, c = shape
            if c != self.kernel.shape[2]:
                raise ValueError(
                    f"request has {c} channels; this service convolves "
                    f"{self.kernel.shape[2]}")
        elif len(shape) == 3:
            n, h, w = shape
        else:
            raise ValueError(f"request shape {tuple(shape)!r} is not "
                             "(n, h, w[, c])")
        if min(n, h, w) < 1:
            raise ValueError(f"request shape {tuple(shape)!r} has a "
                             "non-positive dimension")
        for cls in self.classes:
            if cls.contains(n, h, w):
                return cls
        raise ValueError(
            f"request {n}x{h}x{w} fits no shape class "
            f"{[c.tag() for c in self.classes]}; add a class or shrink "
            "the request")

    def _padded_spec(self, n: int, h: int, w: int) -> ConvSpec:
        k_h, k_w, i_c, k_c = self.kernel.shape
        s_h, s_w = self.stride
        pad_h, pad_w = padding_amounts(h, w, k_h, k_w, s_h, s_w, self.padding)
        return ConvSpec(n, h + pad_h, w + pad_w, i_c, k_h, k_w, k_c, s_h, s_w)

    def class_spec(self, cls: ShapeClass) -> ConvSpec:
        """The post-padding ConvSpec all requests of a class execute."""
        return self._padded_spec(cls.n, cls.h, cls.w)

    def request_out_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The request's own output shape: what execute() copies back.
        Memoized, as the JAX package's (whose shape is a trace there)."""
        key = (shape[0], shape[1], shape[2])
        cached = self._out_shapes.get(key)
        if cached is None:
            cached = tuple(self._padded_spec(*key).out_shape)
            self._out_shapes[key] = cached
        return cached

    # -------------------------------------------------------------- warmup

    def warm(self) -> WarmupReport:
        """Resolve every class's ConvPlan through the plan cache and build
        the class executors.  Best-effort: a class whose cached resolution
        fails falls back to an analytic plan; a class that cannot be
        planned or built at all is recorded as a warning and served
        lazily: warmup never raises for cache trouble."""
        from repro_torch.plan.cache import global_plan_cache
        t0 = time.perf_counter()
        cache = global_plan_cache()
        io_before = cache.io_errors
        for cls in self.classes:
            if cls in self._compiled:
                continue
            try:
                plan = self._resolve_plan(cls)
                self._compiled[cls] = self._compile(cls, plan)
            except Exception as e:  # degraded, not down
                self.warmup.warnings.append(
                    f"class {cls.tag()}: {type(e).__name__}: {e}")
                continue
            self._plans[cls] = plan
            self.warmup.plans[cls] = plan
        self.warmup.plan_cache_io_errors = cache.io_errors - io_before
        self.warmup.warm_seconds = time.perf_counter() - t0
        return self.warmup

    def _resolve_plan(self, cls: ShapeClass):
        from repro_torch.plan import plan_conv2d
        spec = self.class_spec(cls)
        backend = self.device.type
        try:
            return plan_conv2d(spec, dtype=self.dtype, mode=self.plan_mode,
                               backend=backend, partition="none")
        except Exception as e:
            if self.plan_mode == "analytic":
                raise
            # The cached policy's failure modes (a poisoned cache object, a
            # cache dir that is a file, ...) must not take the service
            # down: replan analytically and count the warning.
            self.warmup.warnings.append(
                f"class {cls.tag()}: {self.plan_mode!r} planning failed "
                f"({type(e).__name__}: {e}); fell back to analytic")
            return plan_conv2d(spec, dtype=self.dtype, mode="analytic",
                               backend=backend, partition="none")

    def _compile(self, cls: ShapeClass, plan) -> _ClassExecutor:
        """The class executor: one eager run on the static input builds and
        warms the kernels; on CUDA the same call is then captured into a
        graph that each request replays."""
        # a normal tensor even when warmed under inference mode, so that
        # requests may write into it outside inference mode
        with torch.inference_mode(False):
            static_in = torch.zeros(
                (cls.n, cls.h, cls.w, self.kernel.shape[2]),
                dtype=self.kernel.dtype, device=self.device)

        def run() -> torch.Tensor:
            with torch.no_grad():
                return conv2d(static_in, self.kernel, stride=self.stride,
                              padding=self.padding, plan=plan)

        if self.device.type != "cuda":
            run()
            return _ClassExecutor(static_in, run)
        # Warm up on a side stream (the first run builds and loads the
        # kernels, and any library call initialises its handles), then
        # capture: nothing inside the capture may build or synchronise.
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_out = run()
        return _ClassExecutor(static_in, run, graph, static_out)

    @property
    def plans(self) -> Dict[ShapeClass, object]:
        return dict(self._plans)

    # ------------------------------------------------------------ execution

    def pad_to_class(self, x: torch.Tensor, cls: ShapeClass) -> torch.Tensor:
        """Zero-pad a request into its class shape (bottom/right/batch
        growth only: bucket() guarantees no dimension shrinks)."""
        n, h, w = x.shape[0], x.shape[1], x.shape[2]
        return F.pad(x, (0, 0, 0, cls.w - w, 0, cls.h - h, 0, cls.n - n))

    def execute(self, x: torch.Tensor) -> torch.Tensor:
        """Serve one request: bucket -> the class's static input (the
        request, zeros around it) -> its executor -> a copy of the
        request's true output."""
        if x.dtype != self.kernel.dtype:
            raise ValueError(f"request dtype {x.dtype} != service dtype "
                             f"{self.kernel.dtype}")
        cls = self.bucket(x.shape)
        ex = self._compiled.get(cls)
        if ex is None:                  # cold start for this class
            plan = self._resolve_plan(cls)
            ex = self._compile(cls, plan)
            self._plans[cls] = plan
            self._compiled[cls] = ex
        n, h, w = x.shape[0], x.shape[1], x.shape[2]
        buf = ex.static_in
        buf[n:].zero_()
        buf[:n, h:].zero_()
        buf[:n, :h, w:].zero_()
        buf[:n, :h, :w].copy_(x)
        out = ex()
        if ex.graph is not None:
            self.replays[cls] += 1
        o_n, o_h, o_w, _ = self.request_out_shape(x.shape)
        return out[:o_n, :o_h, :o_w].clone(
            memory_format=torch.contiguous_format)

    __call__ = execute


# ---------------------------------------------------------------------------
# frontends: conv encoders ahead of the LM stack
# ---------------------------------------------------------------------------

def fit_prefix(frames: torch.Tensor, prefix_len: int) -> torch.Tensor:
    """Crop or zero-pad the time axis of (B, T, d) frontend output to the
    model's fixed prefix length."""
    t = frames.shape[1]
    if t >= prefix_len:
        return frames[:, :prefix_len]
    return F.pad(frames, (0, 0, 0, prefix_len - t))


def _require_generator(generator) -> None:
    if generator is None:
        raise ValueError("pass a generator to draw the kernels, or the "
                         "kernels")


def whisper_frontend_kernels(generator: torch.Generator, n_mels: int,
                             d_model: int, *, device="cuda",
                             dtype=torch.float32) -> List[torch.Tensor]:
    """The whisper frontend's HWIO kernels (3, 1, n_mels, d_model) and (3,
    1, d_model, d_model), N(0, 1/n_mels) and N(0, 1/d_model), drawn from
    ``generator`` in that order."""
    return [init_normal(generator, (3, 1, n_mels, d_model), n_mels ** -0.5,
                        dtype, device),
            init_normal(generator, (3, 1, d_model, d_model), d_model ** -0.5,
                        dtype, device)]


def whisper_frontend_service(generator: Optional[torch.Generator],
                             n_mels: int, d_model: int,
                             classes: Sequence[Tuple[int, int, int]],
                             plan_mode: str = "cached", *, device="cuda",
                             kernels=None):
    """The whisper mel frontend as two warm ConvServices over
    time-bucketed shape classes.

    classes are (batch, T, 1): a conv1d expressed as a height-1 conv2d
    with i_h = time, the paper's Algorithm 2 framing.  Layer 1 keeps
    SAME's stride-1 split explicitly as (1, 1) (size-independent, so it is
    class-servable); layer 2 is the whisper-conventional stride-2 (1, 1)
    pad.  The f32 kernels are :func:`whisper_frontend_kernels` drawn from
    ``generator``, or given as ``kernels`` (moved to ``device``).  Returns ``(frontend, [service1, service2])`` where
    ``frontend(mel)`` maps (B, T, n_mels) -> (B, ceil(T/2), d_model)
    through the warmed plans, each layer followed by the tanh GELU (the
    JAX package's ``jax.nn.gelu`` default)."""
    if kernels is None:
        _require_generator(generator)
        kernels = whisper_frontend_kernels(generator, n_mels, d_model,
                                           device=device)
    w1, w2 = (k.to(device) for k in kernels)
    svc1 = ConvService(w1, stride=(1, 1), padding=((1, 1), (0, 0)),
                       classes=classes, plan_mode=plan_mode)
    svc2 = ConvService(w2, stride=(2, 1), padding=((1, 1), (0, 0)),
                       classes=classes, plan_mode=plan_mode)
    svc1.warm()
    svc2.warm()

    def frontend(mel: torch.Tensor) -> torch.Tensor:
        x = mel[:, :, None, :]                   # (B, T, 1, mels), h=time
        x = F.gelu(svc1(x), approximate="tanh")
        x = F.gelu(svc2(x), approximate="tanh")  # stride-2 downsample
        return x[:, :, 0, :]

    return frontend, [svc1, svc2]


def patch_embed_service(generator: Optional[torch.Generator],
                        in_channels: int, d_model: int, patch: int,
                        classes: Sequence[Tuple[int, int, int]],
                        prefix_len: int, plan_mode: str = "cached", *,
                        device="cuda", kernel=None):
    """A ViT-style patch-embed vision frontend: one k = s = patch conv
    maps (B, H, W, C) images, bucketed into ``classes``, to (B,
    prefix_len, d_model) vision tokens.  The f32 kernel (patch, patch,
    in_channels, d_model), N(0, 1/(patch^2 in_channels)), is drawn from
    ``generator``, or given (moved to ``device``).  Returns
    ``(frontend, service)``."""
    if kernel is None:
        _require_generator(generator)
    w = (init_normal(generator, (patch, patch, in_channels, d_model),
                     (patch * patch * in_channels) ** -0.5, torch.float32,
                     device)
         if kernel is None else kernel.to(device))
    svc = ConvService(w, stride=(patch, patch), padding="VALID",
                      classes=classes, plan_mode=plan_mode)
    svc.warm()

    def frontend(image: torch.Tensor) -> torch.Tensor:
        grid = svc(image)                        # (B, H/p, W/p, d_model)
        tokens = grid.reshape(grid.shape[0], -1, grid.shape[3])
        return fit_prefix(tokens, prefix_len)

    return frontend, svc
