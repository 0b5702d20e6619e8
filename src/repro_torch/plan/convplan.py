"""ConvPlan: the frozen planner/executor decision record (counterpart of
``repro.plan.convplan``).

MEC's win is choosing the right lowering per shape (paper §3-4, Table 2:
no single algorithm wins every cv1-cv12 cell).  A :class:`ConvPlan`
captures the whole decision for one convolution: geometry
(:class:`~repro_torch.core.convspec.ConvSpec`), dtype, algorithm, MEC
solution, the kernel's ``w_blk``, GEMM precision and the partition, so it
can be inspected (:meth:`ConvPlan.explain`), serialized
(:meth:`ConvPlan.to_json`, field for field the JAX package's format, so
plans of the two packages load in each other), cached
(``repro_torch.plan.cache``) and executed exactly by
``conv2d(..., plan=)``.

:func:`plan_conv2d` produces plans under three policies:

``analytic``  the costmodel pick (``repro_torch.launch.costmodel``): on
              CUDA the fused kernel K1, on the CPU MEC or direct.
``measured``  time every candidate algorithm through the executor on the
              plan's device (``repro_torch.bench.harness``), keep the
              winner under :data:`MEASURED_NOISE_MARGIN`, then tune its
              knob (the MEC solution, or the kernel's ``w_blk``) over a
              small grid; every trial goes into the calibration store
              (``repro_torch.plan.calibrate``).
``cached``    process LRU in front of an on-disk JSON file keyed by
              spec|dtype|backend; a miss falls back to ``analytic`` and
              fills both tiers.

Where the port differs from the JAX package:

* ``backend`` is the device type of the operands ("cpu" or "cuda"), and
  :meth:`ConvPlan.check_executable` compares the plan with the operands'
  device, not with a process default.
* The JAX package gates its Pallas candidates through the static checker
  ``repro.analysis.pallas_check``; here :func:`launcher_check` asks the
  CUDA launcher itself (``kernels.ops.launch_config``), on a CUDA device
  only, until the analysis port (ROADMAP Queue 1 item 9).  Where the JAX
  package's measured race skips any candidate that raises, here a kernel
  candidate that fails (to build, launch or run) raises: only a
  configuration the launcher refuses by design is skipped.
  The static numeric-contract check the JAX package runs on every plan
  (``assert_plan_numerics``) also waits for item 9, and the collective
  contract of partitioned plans (``shardcheck``) for item 11.
* ``partition`` other than None / "none" raises ``NotImplementedError``
  naming ROADMAP Queue 1 item 11.
* ``precision`` keeps its three names, but every port path already
  computes f32 at f32 accuracy (three TF32 products on the tensor cores,
  TF32 off for cuDNN and cuBLAS), so all three execute alike.
* K4's output rows per CTA have no plan field: the executor derives them
  with ``kernels.ops.pick_oh_blk`` from the plan's ``w_blk``.
"""
from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.convspec import ConvSpec
from repro_torch.core.mec import SOLUTIONS, pick_solution

PLAN_VERSION = 1

# Canonical precision names (the JAX package's jax.lax.Precision members).
PRECISION_NAMES = ("DEFAULT", "HIGH", "HIGHEST")

_SINGLE_DEVICE_ALGOS = ("direct", "im2col", "fft", "winograd", "mec",
                        "mec_lowered", "mec_fused", "mec_fused2")
# The CUDA kernel paths (the JAX package's _PALLAS_ALGOS): the only
# algorithms whose plan carries a w_blk.
_KERNEL_ALGOS = ("mec_lowered", "mec_fused", "mec_fused2")

PLAN_MODES = ("analytic", "measured", "cached")

BACKENDS = ("cpu", "cuda")

_NOT_PORTED_PARTITION = ("distributed execution is not ported yet: "
                         "ROADMAP Queue 1 item 11")


def _precision_name(precision) -> Optional[str]:
    """None | 'highest' | 'HIGHEST' -> canonical name or None."""
    if precision is None:
        return None
    if not isinstance(precision, str):
        raise ValueError(f"precision is a name {PRECISION_NAMES} or None, "
                         f"got {precision!r}")
    name = precision.upper()
    if name not in PRECISION_NAMES:
        raise ValueError(f"unknown precision {precision!r}; expected one "
                         f"of {PRECISION_NAMES} (or None)")
    return name


def dtype_name(dtype) -> str:
    """torch.float32 | 'float32' -> 'float32' (the plan's dtype field)."""
    resolved = getattr(torch, dtype, None) if isinstance(dtype, str) \
        else dtype
    if not isinstance(resolved, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return str(resolved).removeprefix("torch.")


def _backend(backend: Optional[str]) -> str:
    """The plan's backend: the entry points' default device, the card."""
    backend = "cuda" if backend is None else backend
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    return backend


def _check_partition(partition) -> None:
    if partition not in (None, "none"):
        raise NotImplementedError(f"partition={partition!r}: "
                                  f"{_NOT_PORTED_PARTITION}")


def spec_key(spec: ConvSpec) -> str:
    """Readable, order-stable spec identity used in cache keys."""
    return (f"{spec.i_n}x{spec.i_h}x{spec.i_w}x{spec.i_c}"
            f"-k{spec.k_h}x{spec.k_w}x{spec.k_c}"
            f"-s{spec.s_h}x{spec.s_w}")


def plan_cache_key(spec: ConvSpec, dtype: str, backend: str) -> str:
    """The one cache-key format: ``ConvPlan.cache_key()`` and the cached
    policy's lookup both build it here."""
    return f"{spec_key(spec)}|{dtype}|{backend}"


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """One fully resolved convolution decision.  Frozen: a plan is a
    value; compare, hash, serialize and replay it, never mutate it."""

    spec: ConvSpec
    dtype: str
    algorithm: str                         # resolved; never "auto"
    solution: str = "auto"                 # 'A'/'B' for mec, else 'auto'
    w_blk: Optional[int] = None            # kernel output-column block
    precision: Optional[str] = None        # canonical precision name
    partition: Optional[Tuple[str, ...]] = None
    partition_axes: Optional[Tuple[str, ...]] = None
    backend: str = "cpu"
    mode: str = "analytic"                 # policy that produced the plan

    def __post_init__(self):
        if self.algorithm not in _SINGLE_DEVICE_ALGOS:
            raise ValueError(f"plan algorithm {self.algorithm!r} is not a "
                             f"resolved algorithm {_SINGLE_DEVICE_ALGOS}")
        if self.solution not in SOLUTIONS:
            raise ValueError(f"unknown MEC solution {self.solution!r}")
        if self.precision is not None and \
                self.precision not in PRECISION_NAMES:
            raise ValueError(f"unknown precision {self.precision!r}")
        if (self.partition is None) != (self.partition_axes is None):
            raise ValueError("partition and partition_axes must be set "
                             "together")
        _check_partition(self.partition)

    def cache_key(self) -> str:
        """spec + dtype + backend: what the plan cache indexes on."""
        return plan_cache_key(self.spec, self.dtype, self.backend)

    def check_executable(self, spec: ConvSpec, dtype: torch.dtype,
                         device: torch.device) -> None:
        """Raise unless this plan was made for exactly this call: its
        geometry, its input dtype and the operands' device type."""
        if spec != self.spec:
            raise ValueError(
                f"plan/call geometry mismatch: plan was made for "
                f"{self.spec}, call resolves to {spec}")
        got = dtype_name(dtype)
        if got != self.dtype:
            raise ValueError(
                f"plan/call dtype mismatch: plan was made for "
                f"{self.dtype!r}, call carries {got!r}")
        live = torch.device(device).type
        if live != self.backend:
            raise ValueError(
                f"plan/backend mismatch: plan was made for "
                f"{self.backend!r}, the operands are on {live!r}; "
                f"re-plan with plan_conv2d(spec, backend={live!r})")

    # -------------------------------------------------------- serialization

    def to_dict(self) -> Dict:
        return {
            "plan_version": PLAN_VERSION,
            "spec": dataclasses.asdict(self.spec),
            "dtype": self.dtype,
            "algorithm": self.algorithm,
            "solution": self.solution,
            "w_blk": self.w_blk,
            "precision": self.precision,
            "partition": (None if self.partition is None
                          else list(self.partition)),
            "partition_axes": (None if self.partition_axes is None
                               else list(self.partition_axes)),
            "backend": self.backend,
            "mode": self.mode,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, doc: Dict) -> "ConvPlan":
        version = doc.get("plan_version")
        if version != PLAN_VERSION:
            raise ValueError(f"plan_version {version!r} is not "
                             f"{PLAN_VERSION}; regenerate the plan")
        return cls(
            spec=ConvSpec(**doc["spec"]),
            dtype=doc["dtype"],
            algorithm=doc["algorithm"],
            solution=doc.get("solution", "auto"),
            w_blk=doc.get("w_blk"),
            precision=doc.get("precision"),
            partition=(None if doc.get("partition") is None
                       else tuple(doc["partition"])),
            partition_axes=(None if doc.get("partition_axes") is None
                            else tuple(doc["partition_axes"])),
            backend=doc.get("backend", "cpu"),
            mode=doc.get("mode", "analytic"),
        )

    @classmethod
    def from_json(cls, text: str) -> "ConvPlan":
        return cls.from_dict(json.loads(text))

    def explain(self) -> str:
        """Human-readable why: the paper's Eq. 2-4 memory overheads and
        flops for every eligible algorithm, the plan's marked."""
        from repro_torch.core import memory
        from repro_torch.launch.costmodel import conv2d_algorithm_costs
        s = self.spec
        lines = [
            f"ConvPlan[{self.mode}] {spec_key(s)} dtype={self.dtype} "
            f"backend={self.backend}",
            f"  algorithm={self.algorithm} solution={self.solution} "
            f"w_blk={self.w_blk} precision={self.precision}",
            f"  out_shape={tuple(s.out_shape)}  "
            f"mec saving vs im2col (Eq. 4): {memory.mec_saving(s)} elems",
            "  candidate costs (Eq. 2-4 overhead elems / flops):",
        ]
        base = {"mec_lowered": "mec", "mec_fused": "direct",
                "mec_fused2": "direct"}.get(self.algorithm, self.algorithm)
        costs = conv2d_algorithm_costs(s)
        for alg in sorted(costs):
            mark = " <- plan" if alg == base else ""
            c = costs[alg]
            lines.append(f"    {alg:8s} overhead={c['overhead_elems']:.3e} "
                         f"flops={c['flops']:.3e}{mark}")
        if self.algorithm in ("mec_fused", "mec_fused2"):
            lines.append("  (CUDA kernel: the lowering stays in shared "
                         "memory; device-memory overhead is the direct "
                         "conv's)")
        lines.append("  partition: none (single device)")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# planning policies
# ---------------------------------------------------------------------------

def _kernel_mode(algorithm: str) -> str:
    """``mec_fused`` -> ``fused``: the mode ``ops.mec_conv2d_cuda`` takes."""
    return algorithm[len("mec_"):]


def _spec_shapes(spec: ConvSpec):
    return ((spec.i_n, spec.i_h, spec.i_w, spec.i_c),
            (spec.k_h, spec.k_w, spec.i_c, spec.k_c), (spec.s_h, spec.s_w))


def _kernel_w_blk(spec: ConvSpec, algorithm: str) -> Optional[int]:
    """The block each launcher picks when given none
    (``ops.default_w_blk``).  A plan thus changes no block that ``auto``
    runs."""
    if algorithm not in _KERNEL_ALGOS:
        return None
    from repro_torch.kernels import ops
    return ops.default_w_blk(_kernel_mode(algorithm), *_spec_shapes(spec))


def launcher_check(plan: ConvPlan) -> Optional[str]:
    """Why the CUDA launcher would refuse the plan's kernel configuration,
    or None.  Only CUDA plans of a kernel path are checked, and only where
    a card is present (the launcher sizes its configuration from the
    device): it asks the launcher what it would run
    (``ops.launch_config``), launching nothing.  Only a refusal by design
    (``mec_conv.LaunchRefused``) is a reason; a failure to build or load
    the kernels raises.  Stands in for the JAX package's
    ``analysis.pallas_check`` (ROADMAP Queue 1 item 9)."""
    if plan.algorithm not in _KERNEL_ALGOS or plan.backend != "cuda" \
            or not torch.cuda.is_available():
        return None
    from repro_torch.kernels import mec_conv, ops
    try:
        ops.launch_config(_kernel_mode(plan.algorithm),
                          getattr(torch, plan.dtype),
                          *_spec_shapes(plan.spec), w_blk=plan.w_blk)
    except mec_conv.LaunchRefused as e:
        return f"launcher: {e}"
    return None


def assert_plan(plan: ConvPlan) -> None:
    """Raise unless the launcher takes the plan (:func:`launcher_check`):
    raising here beats faulting at execute."""
    reason = launcher_check(plan)
    if reason is not None:
        raise ValueError(f"{spec_key(plan.spec)} {plan.algorithm}: {reason}")


def _hit_satisfies(hit: ConvPlan, precision_name: Optional[str]) -> bool:
    """Would serving this cached plan honour the caller's request?  The
    key is spec|dtype|backend only, so the precision and the block pick
    (which the pickers may have changed since) are checked on the hit."""
    return (hit.precision == precision_name and hit.partition is None
            and hit.w_blk == _kernel_w_blk(hit.spec, hit.algorithm))


# A measured flip needs to clear this margin over the analytic pick:
# sub-5% deltas are timer jitter at bench iteration counts, and a pick
# that flips run to run on noise is worse than a stable analytic one.
MEASURED_NOISE_MARGIN = 0.05


def pick_measured(times: Dict[str, float], analytic: str,
                  margin: float = MEASURED_NOISE_MARGIN,
                  spreads: Optional[Dict[str, float]] = None) -> str:
    """The measured policy's decision rule: the fastest candidate, except
    that the analytic pick is kept whenever it is within the noise margin
    of the fastest.  ``spreads`` (algorithm -> ``us_rel_spread`` of the
    same timed iterations) widens the margin to the observed jitter of
    the two candidates compared; the margin is the floor."""
    best = min(times, key=lambda a: times[a])
    if analytic not in times:
        return best
    eff = margin
    for alg in (analytic, best):
        sp = (spreads or {}).get(alg)
        if sp is not None:
            eff = max(eff, min(float(sp), 1.0))
    if times[analytic] <= times[best] * (1 + eff):
        return analytic
    return best


def eligible_candidates(spec: ConvSpec) -> Tuple[str, ...]:
    """conv2d algorithm names the measured policy may time on a spec."""
    return tuple(alg for alg in _SINGLE_DEVICE_ALGOS
                 if alg != "winograd"
                 or (spec.k_h, spec.k_w, spec.s_h, spec.s_w) == (3, 3, 1, 1))


@dataclasses.dataclass
class MeasuredCandidates:
    """What one measured sweep learned: per-candidate timings and their
    full stats, and every candidate that could not be timed, with why."""

    times: Dict[str, float]            # alg -> us_median (timeable only)
    stats: Dict[str, Dict]             # alg -> full time_compiled stats
    skipped: Dict[str, str]            # alg -> why it was not timed


def _time_trial(trial: ConvPlan, inp: torch.Tensor, ker: torch.Tensor,
                iters: int, warmup: int) -> Dict:
    """Run one trial plan through the executor under the harness's
    timing protocol."""
    from repro_torch.bench.harness import time_compiled
    from repro_torch.core.conv_api import conv2d
    spec = trial.spec

    def call():
        with torch.no_grad():
            return conv2d(inp, ker, stride=(spec.s_h, spec.s_w), plan=trial)

    return time_compiled(call, iters=iters, warmup=warmup)


def _record_time_trials(spec: ConvSpec, dtype: str, backend: str,
                        trials) -> None:
    """Fold measured trials into the calibration store.  Best effort: a
    calibration failure must never fail a measurement."""
    try:
        from repro_torch.plan.calibrate import CalibrationStore
        store = CalibrationStore(backend=backend)
        for alg, solution, w_blk, us in trials:
            store.add_time(spec, dtype, alg, us, solution=solution,
                           w_blk=w_blk)
        store.flush()
    except Exception:
        pass


def _skip(out: MeasuredCandidates, label: str, reason: str) -> None:
    out.skipped[label] = reason
    warnings.warn(f"measured planning skips {label}: {reason}")


def measure_candidates_detailed(
        spec: ConvSpec, dtype="float32",
        candidates: Optional[Sequence[str]] = None,
        iters: int = 3, warmup: int = 1, precision=None,
        record: bool = True, backend: Optional[str] = None
) -> MeasuredCandidates:
    """Per candidate algorithm, its time per call on ``backend`` (default
    the card) through a ConvPlan executor call, so the measurement runs
    exactly what the winning plan will (resolved solution, planner-derived
    ``w_blk``).  A candidate the launcher refuses by design, or another
    algorithm whose call raises (Winograd off 3x3/s1), is never dropped
    silently: it lands in ``.skipped`` with its reason, and a warning.  A
    kernel candidate whose call raises (a build, launch or run failure)
    raises: the race does not move off a broken kernel.  With ``record=True`` every timed trial goes into the
    calibration store."""
    from repro_torch.bench.harness import make_arrays
    backend = _backend(backend)
    candidates = tuple(candidates) if candidates else \
        eligible_candidates(spec)
    dtype = dtype_name(dtype)
    precision_name = _precision_name(precision)
    inp, ker = make_arrays(spec, dtype, device=backend)
    out = MeasuredCandidates(times={}, stats={}, skipped={})
    recorded = []
    for alg in candidates:
        trial = ConvPlan(
            spec=spec, dtype=dtype, algorithm=alg,
            solution=pick_solution(spec) if alg == "mec" else "auto",
            w_blk=_kernel_w_blk(spec, alg), precision=precision_name,
            backend=backend)
        reason = launcher_check(trial)
        if reason is not None:
            _skip(out, alg, reason)
            continue
        try:
            timing = _time_trial(trial, inp, ker, iters, warmup)
        except Exception as e:
            # A kernel that fails to build, launch or run is a fault, not
            # a loss of the race: it raises.  Another candidate that
            # rejects the shape is counted, not silently absent.
            if alg in _KERNEL_ALGOS:
                raise
            _skip(out, alg, f"{type(e).__name__}: {e}"[:300])
            continue
        out.times[alg] = timing["us_median"]
        out.stats[alg] = dict(timing, solution=trial.solution,
                              w_blk=trial.w_blk)
        recorded.append((alg, trial.solution, trial.w_blk,
                         timing["us_median"]))
    if record and recorded:
        _record_time_trials(spec, dtype, backend, recorded)
    return out


def measure_candidates(spec: ConvSpec, dtype="float32",
                       candidates: Optional[Sequence[str]] = None,
                       iters: int = 3, warmup: int = 1, precision=None,
                       record: bool = True,
                       backend: Optional[str] = None) -> Dict[str, float]:
    """``measure_candidates_detailed`` reduced to {algorithm: us_median}."""
    return measure_candidates_detailed(
        spec, dtype, candidates, iters=iters, warmup=warmup,
        precision=precision, record=record, backend=backend).times


def _stage2_trials(spec: ConvSpec, dtype: str, algorithm: str,
                   precision_name: Optional[str], backend: str):
    """The winner's knob grid for measured stage 2.  mec: both §3.2
    solutions (A, h-direction; B, w-direction).  Kernel paths: the
    launcher's ``w_blk`` plus half and double (clamped to [8, o_w]), each
    re-checked by the launcher.  Other algorithms have no plan-level knob.
    Returns (knob_name, {label: trial plan}) or (None, {})."""
    if algorithm == "mec":
        plans = {sol: ConvPlan(spec=spec, dtype=dtype, algorithm="mec",
                               solution=sol, precision=precision_name,
                               backend=backend)
                 for sol in ("A", "B")}
        return "solution", plans
    if algorithm in _KERNEL_ALGOS:
        default = _kernel_w_blk(spec, algorithm)
        grid = {default, max(8, default // 2), min(spec.o_w, default * 2)}
        plans = {}
        for blk in sorted(b for b in grid if 1 <= b <= spec.o_w):
            trial = ConvPlan(spec=spec, dtype=dtype, algorithm=algorithm,
                             w_blk=blk, precision=precision_name,
                             backend=backend)
            if launcher_check(trial) is None:
                plans[str(blk)] = trial
        return "w_blk", plans
    return None, {}


def tune_measured(spec: ConvSpec, dtype="float32",
                  backend: Optional[str] = None, precision=None,
                  candidates: Optional[Sequence[str]] = None,
                  iters: int = 3, warmup: int = 1, record: bool = True,
                  calibration="ambient") -> Tuple[ConvPlan, Dict]:
    """The full measured policy: the stage-1 algorithm race, then a
    stage-2 grid over the winner's knob (MEC solution or ``w_blk``), both
    through ``pick_measured``'s noise margin, so that leaving a default
    needs evidence beyond jitter.  Returns ``(plan, detail)``: the
    measured plan and the evidence ``{analytic_algorithm, candidate_us,
    candidate_stats, skipped, tuning}`` (``tuning`` None when the winner
    has no knob)."""
    from repro_torch.launch.costmodel import pick_conv2d_algorithm
    backend = _backend(backend)
    dtype = dtype_name(dtype)
    precision_name = _precision_name(precision)
    mc = measure_candidates_detailed(
        spec, dtype, candidates, iters=iters, warmup=warmup,
        precision=precision_name, record=record, backend=backend)
    analytic = pick_conv2d_algorithm(spec, backend, calibration=calibration)
    if not mc.times:
        raise ValueError(
            f"measured planning has no timeable candidate for "
            f"{spec_key(spec)}: skipped={mc.skipped}")
    algorithm = pick_measured(mc.times, analytic, spreads={
        a: s.get("us_rel_spread") for a, s in mc.stats.items()})
    solution = pick_solution(spec) if algorithm == "mec" else "auto"
    w_blk = _kernel_w_blk(spec, algorithm)

    tuning = None
    knob, plans = _stage2_trials(spec, dtype, algorithm, precision_name,
                                 backend)
    if knob is not None and plans:
        from repro_torch.bench.harness import make_arrays
        inp, ker = make_arrays(spec, dtype, device=backend)
        default_label = solution if knob == "solution" else str(w_blk)
        trial_times: Dict[str, float] = {}
        trial_stats: Dict[str, Dict] = {}
        recorded = []
        for label, trial in plans.items():
            try:
                timing = _time_trial(trial, inp, ker, iters, warmup)
            except Exception as e:
                if algorithm in _KERNEL_ALGOS:    # a fault, as in stage 1
                    raise
                mc.skipped[f"{algorithm}[{knob}={label}]"] = \
                    f"{type(e).__name__}: {e}"[:300]
                continue
            trial_times[label] = timing["us_median"]
            trial_stats[label] = dict(timing, solution=trial.solution,
                                      w_blk=trial.w_blk)
            recorded.append((algorithm, trial.solution, trial.w_blk,
                             timing["us_median"]))
        if record and recorded:
            _record_time_trials(spec, dtype, backend, recorded)
        if trial_times:
            # The default keeps its noise-margin advantage (the plain 5%
            # floor: both trials run one algorithm, so their jitter is
            # common-mode); if it could not be timed the fastest wins.
            picked = pick_measured(trial_times, default_label) \
                if default_label in trial_times \
                else min(trial_times, key=lambda k: trial_times[k])
            if knob == "solution":
                solution = picked
            else:
                w_blk = int(picked)
            tuning = {"knob": knob, "algorithm": algorithm,
                      "default": default_label, "picked": picked,
                      "trials": trial_stats}

    plan = ConvPlan(spec=spec, dtype=dtype, algorithm=algorithm,
                    solution=solution, w_blk=w_blk,
                    precision=precision_name, backend=backend,
                    mode="measured")
    assert_plan(plan)
    detail = {"analytic_algorithm": analytic,
              "candidate_us": dict(mc.times),
              "candidate_stats": mc.stats,
              "skipped": mc.skipped,
              "tuning": tuning}
    return plan, detail


def plan_conv2d(spec: ConvSpec, *, dtype="float32", mode: str = "analytic",
                backend: Optional[str] = None, precision=None,
                partition=None,
                candidates: Optional[Sequence[str]] = None,
                iters: int = 3, warmup: int = 1,
                cache=None, calibration="ambient") -> ConvPlan:
    """The :class:`ConvPlan` for one post-padding ``spec`` on ``backend``
    ("cuda", the default, or "cpu").

    mode: ``"analytic"`` (the costmodel pick, ``auto``'s rule),
    ``"measured"`` (time every candidate on the backend's device, keep the
    winner, tune its knob: :func:`tune_measured`) or ``"cached"`` (process
    LRU, then the on-disk JSON, then analytic on a miss:
    ``repro_torch.plan.cache``).

    calibration: what the analytic pick consults: ``"ambient"`` (the
    default: $REPRO_TORCH_CALIBRATION or the fingerprinted store beside
    the plan cache, absent when unfitted), None (the paper's constants) or
    an explicit ``Calibration``.  On CUDA the pick is the fused kernel
    whatever the calibration says.  partition: None or "none" only.
    """
    if mode not in PLAN_MODES:
        raise ValueError(f"unknown plan mode {mode!r}; expected one of "
                         f"{PLAN_MODES}")
    _check_partition(partition)
    spec.validate()
    dtype = dtype_name(dtype)
    backend = _backend(backend)
    precision_name = _precision_name(precision)

    if mode == "cached":
        from repro_torch.plan.cache import global_plan_cache
        cache = cache if cache is not None else global_plan_cache()
        key = plan_cache_key(spec, dtype, backend)
        hit = cache.get(key)
        if hit is not None and _hit_satisfies(hit, precision_name):
            return hit
        # A miss, or a hit that does not satisfy this request (the key is
        # spec|dtype|backend only): recompute and overwrite.
        plan = plan_conv2d(spec, dtype=dtype, mode="analytic",
                           backend=backend, precision=precision_name,
                           calibration=calibration)
        if plan != hit:               # an agreeing recompute skips the
            cache.put(key, plan)      # disk rewrite
        return plan

    if mode == "measured":
        plan, _detail = tune_measured(
            spec, dtype, backend=backend, precision=precision_name,
            candidates=candidates, iters=iters, warmup=warmup,
            calibration=calibration)
        return plan

    from repro_torch.launch.costmodel import pick_conv2d_algorithm
    algorithm = pick_conv2d_algorithm(spec, backend, calibration=calibration)
    plan = ConvPlan(spec=spec, dtype=dtype, algorithm=algorithm,
                    solution=(pick_solution(spec) if algorithm == "mec"
                              else "auto"),
                    w_blk=_kernel_w_blk(spec, algorithm),
                    precision=precision_name, backend=backend, mode=mode)
    assert_plan(plan)
    return plan


def resolve_cached_plan(spec: ConvSpec, dtype="float32",
                        backend: Optional[str] = None) -> ConvPlan:
    """What ``conv2d(algorithm="auto")`` calls: the cached-policy plan for
    (spec, dtype, backend)."""
    return plan_conv2d(spec, dtype=dtype, mode="cached", backend=backend,
                       partition="none")
