"""Benchmark harness: one measurement protocol for every scenario
(counterpart of ``repro.bench.harness``).

Each (scenario, algorithm) cell runs ``conv2d`` with the variant's
kwargs on the scenario's ``run_spec`` (the paper's full widths, see
``bench.scenarios``) on the device the caller names, the card by
default: ``warmup`` calls, then ``iters`` timed calls; ``us_per_call``
is the median.  On the card each call is timed by its device time alone
(:func:`slept_event_ms`), since ``conv2d`` runs eagerly and the host's
enqueue (~0.1 ms a call on the H100) is as long as the shorter kernels.
Beside the timing every record carries deterministic analytic fields:
memory overhead (``core.memory``, paper Eqs. 2-4, on the paper spec),
flops (``launch.costmodel``), the ``auto`` pick and the analytic plan for
the run's backend.  ``repro_torch.bench.check`` gates on those; timing
is tolerance- or schema-only checked.

A partitioned cell (suite ``dist``) always carries the JAX package's
per-device analytics (``launch.costmodel.conv_partition_costs``: the
partition, its device counts, the halo, Eq. 3 overhead and wire bytes
per device, and the ``auto`` partition).  It is executed, through
``parallel.conv.sharded_conv2d`` on a host mesh of the first ranks, when
the initialised world holds its devices and the geometry splits (the
JAX package's rule); every rank of the world must then run the suite,
cell for cell.  ``run_suite(time_only=)`` narrows which cells run at all
(the others keep their analytics), for a caller whose ranks share one
card or the CPU.  Such a call is timed on the host clock around a
synchronised call, since its collectives run on the host.  Where the JAX
package's harness skips timing for a conv that will not compile, here a
variant that fails on the device raises: no record gets
``us_per_call: null`` because a kernel failed to build or launch.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import functools
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.numcheck import cell_numcheck
from repro_torch.bench.scenarios import (ALGORITHM_VARIANTS, Scenario,
                                         resolve_suite)
from repro_torch.core.convspec import ConvSpec
from repro_torch.core.memory import algorithm_overhead
from repro_torch.launch.costmodel import (conv2d_algorithm_costs,
                                          conv_partition_costs,
                                          pick_conv2d_algorithm,
                                          pick_conv_partition)

DEVICES = ("cuda", "cpu")

# Variant name -> key into conv2d_algorithm_costs for the flops model
# (all MEC executions compute the same mult-adds as the reference).
_FLOPS_BASE = {"mecA": "mec", "mecB": "mec", "mec_lowered": "mec",
               "mec_fused": "mec", "mec_fused2": "mec"}


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
    with torch.cuda.device(device):
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


def _host_us(call, iters: int, device=None) -> List[float]:
    """Host-clock microseconds of ``iters`` calls, each ending with the
    card synchronised when ``device`` is a CUDA device."""
    us: List[float] = []
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        call()
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        us.append((time.perf_counter() - t0) * 1e6)
    return us


def _stats(us: Sequence[float], iters: int, warmup: int) -> Dict:
    median = float(np.median(us))
    std = float(np.std(us))
    return {"iters": max(iters, 1), "warmup": max(warmup, 1),
            "us_median": median, "us_min": float(min(us)),
            "us_mean": float(np.mean(us)), "us_std": std,
            "us_rel_spread": (std / median if median > 0 else None)}


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
        us = _host_us(call, iters)
    return _stats(us, iters, warmup)


def time_host(call, iters: int = 3, warmup: int = 1) -> Dict:
    """:func:`time_compiled`'s stats on the host clock around each call,
    the card synchronised after it: the timer of calls whose collectives
    run on the host."""
    out = None
    for _ in range(max(warmup, 1)):
        out = call()
    return _stats(_host_us(call, iters, getattr(out, "device", None)),
                  iters, warmup)


def require_device(device: str) -> None:
    """A measurement on the card fails without one: it never falls back
    to the CPU."""
    if device not in DEVICES:
        raise ValueError(f"unknown device {device!r}; expected one of "
                         f"{DEVICES}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the bench runs on the CUDA card by default and "
                           "none is available; pass device='cpu' to run "
                           "on the CPU")


def _analytic_flops(spec: ConvSpec, algorithm: str) -> float:
    costs = conv2d_algorithm_costs(spec)
    return float(costs[_FLOPS_BASE.get(algorithm, algorithm)]["flops"])


def _resolved_plan_dict(sc: Scenario, device: str) -> Dict:
    """The analytic ConvPlan for the scenario's paper geometry on
    ``device``, recorded per cell so a report shows the whole decision.
    Lazy import: bench sits below plan."""
    from repro_torch.plan import plan_conv2d
    return plan_conv2d(sc.spec, dtype=sc.dtype, mode="analytic",
                       backend=device, partition="none").to_dict()


def measure(sc: Scenario, algorithm: str, iters: int = 3, warmup: int = 1,
            with_timing: bool = True, plan_dict: Optional[Dict] = None,
            device: str = "cuda") -> Dict:
    """One result record for a (scenario, algorithm) cell on ``device``.
    ``plan_dict`` lets run_suite derive the (per-scenario,
    algorithm-independent) plan once instead of per cell."""
    from repro_torch.core.conv_api import conv2d
    require_device(device)
    kwargs = dict(ALGORITHM_VARIANTS[algorithm])
    dtype_bytes = getattr(torch, sc.dtype).itemsize
    overhead = int(algorithm_overhead(sc.spec, algorithm))
    record = {
        "scenario": sc.name,
        "algorithm": algorithm,
        "dtype": sc.dtype,
        "weight": sc.weight,
        "spec": dataclasses.asdict(sc.spec),
        "run_spec": dataclasses.asdict(sc.run_spec),
        # Deterministic analytics on the exact paper spec (check gates on
        # these) ...
        "overhead_elems": overhead,
        "overhead_bytes": overhead * dtype_bytes,
        "flops": _analytic_flops(sc.spec, algorithm),
        # ... and on the spec actually executed.
        "run_flops": _analytic_flops(sc.run_spec, algorithm),
        "auto_algorithm": pick_conv2d_algorithm(sc.spec, device),
        "plan": plan_dict if plan_dict is not None
        else _resolved_plan_dict(sc, device),
        "out_shape": list(sc.run_spec.out_shape),
        "us_per_call": None,
        "timing": None,
        # PyTorch compiles no HLO: these stay None (a count from the
        # profiler would miss the CUDA kernels' own work).
        "hlo_flops": None,
        "hlo_bytes": None,
        # The cell's static numeric contract (analysis.numcheck): traced on
        # meta tensors, memoised across cells of one (spec, algorithm,
        # dtype, solution), no extra execution; the full evidence is the
        # numcheck suite's (python -m repro_torch.analysis).
        "numcheck": cell_numcheck(sc.run_spec, kwargs["algorithm"], sc.dtype,
                                  solution=kwargs.get("solution", "auto")),
    }
    mesh = None
    if sc.partition is not None:
        mesh = _dist_fields(record, sc, dtype_bytes, with_timing)
        with_timing = mesh is not None
        if mesh is not None:
            # every rank of the world takes part in the check
            record["shardcheck"] = cell_shardcheck(sc, kwargs, mesh, device)
        if mesh is not None and mesh.get_coordinate() is None:
            return record          # a rank outside the cell's mesh
    if not with_timing:
        return record
    inp, ker = make_arrays(sc.run_spec, sc.dtype, device=device)
    stride = (sc.run_spec.s_h, sc.run_spec.s_w)

    if mesh is None:
        def call():
            with torch.no_grad():
                return conv2d(inp, ker, stride=stride, **kwargs)

        timing = time_compiled(call, iters=iters, warmup=warmup)
    else:
        from repro_torch.launch.mesh import axis_names
        from repro_torch.parallel.conv import sharded_conv2d
        composite = isinstance(sc.n_dev, tuple)

        def call():
            with torch.no_grad():
                return sharded_conv2d(
                    inp, ker, stride=stride, partition=sc.partition,
                    mesh=mesh, axis=axis_names(mesh) if composite else None,
                    **kwargs)

        timing = time_host(call, iters=iters, warmup=warmup)
    record["timing"] = timing
    record["us_per_call"] = timing["us_median"]
    return record


def cell_shardcheck(sc: Scenario, kwargs: Dict, mesh, device: str) -> Dict:
    """The executed dist cell's collective-contract verdict
    (``analysis.shardcheck``), reduced to the fields ``bench.check``
    gates: the verdict, each direction's status, the expected required
    and optional bytes, the violations.  The full evidence (every rank's
    counts) is the shardcheck suite's.  Collective over the world."""
    from repro_torch.analysis.shardcheck import check_sharding
    chk = check_sharding(
        sc.run_spec, sc.partition, dtype=sc.dtype,
        algorithm=kwargs.get("algorithm", "auto"),
        solution=kwargs.get("solution", "auto"), mesh=mesh,
        axes=tuple(mesh.mesh_dim_names), device=device).record
    return {
        "verdict": chk["verdict"],
        "skipped_reason": chk["skipped_reason"],
        "directions": {d: ("unmodeled" if "unmodeled" in info
                           else "verified")
                       for d, info in chk["directions"].items()},
        "expected": {d: {"required": info["expected"],
                         "optional": info["optional"]}
                     for d, info in chk["directions"].items()
                     if "expected" in info},
        "violations": chk["violations"],
    }


def _dist_fields(record: Dict, sc: Scenario, dtype_bytes: int,
                 execute: bool):
    """Add the partitioned cell's analytics to ``record``; return the host
    mesh to execute it on, or None when it stays analytic (not
    ``execute``, a world smaller than the cell, or a geometry that does
    not split)."""
    import math

    import torch.distributed as dist

    from repro_torch.parallel.conv import (COMPOSITE_PARTITIONS,
                                           normalize_partition,
                                           partition_name, partition_viable)
    parts = normalize_partition(sc.partition)
    composite = len(parts) > 1
    sizes = tuple(sc.n_dev) if composite else (int(sc.n_dev),)
    n_total = math.prod(sizes)
    entry = conv_partition_costs(sc.spec, sizes if composite else sizes[0],
                                 dtype_bytes)[parts if composite
                                              else parts[0]]
    record["partition"] = partition_name(parts)
    record["n_dev"] = int(n_total)
    record["n_dev_axes"] = [int(n) for n in sizes]
    record["halo_bytes_per_device"] = entry["halo_bytes_per_device"]
    record["per_device_overhead_elems"] = entry["per_device_overhead_elems"]
    record["comm_bytes_per_device"] = (entry["comm_bytes_fwd_per_device"]
                                       + entry["comm_bytes_bwd_per_device"])
    candidates = {p: n_total for p in ("batch", "channel", "spatial")}
    if composite:
        candidates.update({c: sizes for c in COMPOSITE_PARTITIONS})
    auto = pick_conv_partition(sc.spec, candidates, dtype_bytes)
    record["auto_partition"] = None if auto is None else partition_name(auto)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not execute or n_total > world or \
            not partition_viable(sc.run_spec, parts, sc.n_dev):
        return None
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(shape=sizes)


def crosscheck_scenario(records: Sequence[Dict]) -> Dict:
    """Costmodel-vs-measurement cross-validation for one scenario.

    * ``auto_matches_best``: did ``pick_conv2d_algorithm`` choose the
      algorithm that timed fastest here?
    * ``auto_overhead_ok``: is auto's pick no worse on analytic memory
      overhead than the measured-fastest one?
    * ``flops_ratio_hlo``: kept for the JAX package's schema; empty here
      (no HLO flops).
    """
    timed = [r for r in records if r["us_per_call"] is not None]
    out = {"scenario": records[0]["scenario"],
           "auto_algorithm": records[0]["auto_algorithm"],
           "measured_best": None, "auto_matches_best": None,
           "auto_overhead_ok": None, "flops_ratio_hlo": {}}
    if not timed:
        return out
    best = min(timed, key=lambda r: r["us_per_call"])
    out["measured_best"] = best["algorithm"]
    auto = out["auto_algorithm"]
    # auto names a conv2d algorithm; bench variants mecA/mecB both map to it
    base_of = {n: kw["algorithm"] for n, kw in ALGORITHM_VARIANTS.items()}
    out["auto_matches_best"] = base_of[best["algorithm"]] == auto
    auto_recs = [r for r in records if base_of[r["algorithm"]] == auto]
    if auto_recs:
        out["auto_overhead_ok"] = \
            auto_recs[0]["overhead_elems"] <= best["overhead_elems"]
    return out


def run_suite(suite: str, iters: int = 3, warmup: int = 1,
              with_timing: bool = True, crosscheck: bool = False,
              progress=None, device: str = "cuda",
              time_only: Optional[str] = None) -> Dict:
    """Run a registered suite on ``device`` and return the report
    document.  ``time_only``: a glob over scenario names; the cells it
    does not match are not run (their analytic fields stay)."""
    from repro_torch.bench.report import make_report
    require_device(device)
    results: List[Dict] = []
    checks: List[Dict] = []
    for sc in resolve_suite(suite):
        recs = []
        plan_dict = _resolved_plan_dict(sc, device)   # algorithm-free
        run = with_timing and (time_only is None
                               or fnmatch.fnmatchcase(sc.name, time_only))
        for alg in sc.algorithms:
            if progress:
                progress(f"[bench] {suite}/{sc.name}/{alg}")
            recs.append(measure(sc, alg, iters=iters, warmup=warmup,
                                with_timing=run,
                                plan_dict=plan_dict, device=device))
        results.extend(recs)
        if crosscheck:
            checks.append(crosscheck_scenario(recs))
    harness = {"iters": iters, "warmup": warmup, "with_timing": with_timing,
               "time_only": time_only, "device": device,
               "timer": ("device time, host hidden (slept_event_ms)"
                         if device == "cuda" else "host clock")}
    if suite == "dist":
        import torch.distributed as dist
        harness["world_size"] = dist.get_world_size() \
            if dist.is_initialized() else 1
        harness["timer"] = "host clock, card synchronised (time_host)"
    return make_report(suite, results, harness,
                       crosscheck=checks if crosscheck else None,
                       backend=device)


SERVE_MODES = ("warm", "cold", "auto")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _serve_requests(cell, device: str) -> List[torch.Tensor]:
    """The cell's deterministic request stream, the JAX package's numpy
    draws, built on ``device`` before the stream starts (building tensors
    must not pollute the latency measurement)."""
    i_c = cell.kernel_shape[2]
    dtype = getattr(torch, cell.dtype)
    reqs = []
    for i in range(cell.n_requests):
        n, h, w = cell.requests[i % len(cell.requests)]
        rng = np.random.RandomState(1000 + i)
        reqs.append(torch.from_numpy(rng.randn(n, h, w, i_c)
                                     .astype(np.float32)).to(device, dtype))
    _sync(device)
    return reqs


def serve_latencies(svc, reqs: Sequence[torch.Tensor], mode: str
                    ) -> Tuple[Dict, float]:
    """Serve ``reqs`` through ``svc`` (a ``repro_torch.serving.
    ConvService``) under ``mode``, one at a time: per shape class, each
    request's host wall-clock in microseconds, the device synchronised
    after it.  ``warm`` and ``cold`` run :meth:`ConvService.execute`
    (cold pays plan resolution and the executor's build inside the first
    request of each class); ``auto`` is the pre-planner baseline, an eager
    ``conv2d(algorithm="auto")`` on the padded request, sliced.  Returns
    ``{class: [us, ...]}`` and the total seconds."""
    from repro_torch.core.conv_api import conv2d
    if mode not in SERVE_MODES:
        raise ValueError(f"unknown serve mode {mode!r}; expected one of "
                         f"{SERVE_MODES}")
    per_class: Dict = {cls: [] for cls in svc.classes}
    t_all = time.perf_counter()
    with torch.no_grad():
        for x in reqs:
            cls = svc.bucket(x.shape)
            t0 = time.perf_counter()
            if mode == "auto":
                out = conv2d(svc.pad_to_class(x, cls), svc.kernel,
                             stride=svc.stride, padding=svc.padding,
                             algorithm="auto")
                o_n, o_h, o_w, _ = svc.request_out_shape(x.shape)
                out = out[:o_n, :o_h, :o_w, :]
            else:
                out = svc.execute(x)
            _sync(out.device)
            per_class[cls].append((time.perf_counter() - t0) * 1e6)
    return per_class, max(time.perf_counter() - t_all, 1e-9)


def run_serve(progress=None, device: str = "cuda") -> Dict:
    """The ``serve`` suite: every registered
    :class:`~repro_torch.bench.scenarios.ServeScenario` served on
    ``device`` under the three policies of :data:`SERVE_MODES`, one record
    per (shape class, mode), the JAX package's record keys.

    Latencies are end-to-end request wall-clock with the device
    synchronised (:func:`serve_latencies`), including each mode's setup
    profile: warm resolves the plans and captures the class executors
    before the stream starts, cold does it inside the first request of
    each class (seen in ``first_request_us`` and the p99), and auto pays
    eager dispatch on every request.  ``us_per_call`` is the p50.  The
    analytic fields are Eq. 3's MEC overhead on the padded class spec,
    gated exactly by ``bench.check``.
    """
    from repro_torch.bench.report import make_report
    from repro_torch.bench.scenarios import serve_cells
    from repro_torch.plan import plan_conv2d
    from repro_torch.serving.conv_service import ConvService
    require_device(device)
    results: List[Dict] = []
    for cell in serve_cells():
        rng = np.random.RandomState(7)
        kernel = torch.from_numpy(rng.randn(*cell.kernel_shape)
                                  .astype(np.float32)) \
            .to(device, getattr(torch, cell.dtype))
        reqs = _serve_requests(cell, device)
        itemsize = kernel.element_size()
        for mode in SERVE_MODES:
            if progress:
                progress(f"[bench] serve/{cell.name}/{mode}")
            svc = ConvService(kernel, stride=cell.stride,
                              padding=cell.padding, classes=cell.classes,
                              plan_mode="cached")
            warmed = svc.warm() if mode == "warm" else None
            per_class, total_s = serve_latencies(svc, reqs, mode)
            throughput = len(reqs) / total_s
            for cls in svc.classes:
                spec = svc.class_spec(cls)
                lat = per_class[cls]
                overhead = int(algorithm_overhead(spec, "mec"))
                p50 = float(np.percentile(lat, 50)) if lat else None
                p99 = float(np.percentile(lat, 99)) if lat else None
                results.append({
                    "scenario": f"{cell.name}_c{cls.tag()}",
                    "algorithm": mode,
                    "dtype": cell.dtype,
                    "weight": 1,
                    "spec": dataclasses.asdict(spec),
                    "run_spec": dataclasses.asdict(spec),
                    # Eq. 3 on the padded class spec: the memory the MEC
                    # lowering costs a class request, exact-gated.
                    "overhead_elems": overhead,
                    "overhead_bytes": overhead * itemsize,
                    "flops": _analytic_flops(spec, "mec"),
                    "run_flops": _analytic_flops(spec, "mec"),
                    "auto_algorithm": pick_conv2d_algorithm(spec, device),
                    "plan": plan_conv2d(spec, dtype=cell.dtype,
                                        mode="analytic", backend=device,
                                        partition="none").to_dict(),
                    "out_shape": list(spec.out_shape),
                    "us_per_call": p50,
                    "timing": ({"n": len(lat), "us_p50": p50, "us_p99": p99,
                                "us_mean": float(np.mean(lat)),
                                "us_min": float(min(lat)),
                                "us_max": float(max(lat))}
                               if lat else None),
                    "hlo_flops": None,
                    "hlo_bytes": None,
                    "serve_mode": mode,
                    "shape_class": cls.tag(),
                    "n_classes": len(svc.classes),
                    "n_requests": len(lat),
                    "p50_us": p50,
                    "p99_us": p99,
                    "first_request_us": float(lat[0]) if lat else None,
                    "throughput_rps": float(throughput),
                    "warmup_warnings": (warmed.warning_count
                                        if warmed else 0),
                    "plan_cache_io_errors": (warmed.plan_cache_io_errors
                                             if warmed else 0),
                })
    harness = {"modes": list(SERVE_MODES), "device": device,
               "latency": "end-to-end request wall-clock incl. each "
                          "mode's setup profile, the device synchronised"}
    return make_report("serve", results, harness, backend=device)


def run_autotune(base_suite: str = "smoke", iters: int = 3, warmup: int = 1,
                 progress=None, device: str = "cuda") -> Dict:
    """Analytic-vs-measured pick quality (the ``autotune`` scenario), on
    ``device``.

    For every scenario of ``base_suite``, the analytic plan on the timed
    geometry, then the full measured policy (``repro_torch.plan.
    tune_measured``: the staged race and knob grid of
    ``plan_conv2d(mode="measured")``), both picks recorded with their
    times.  ``speedup`` > 1 means measurement beat the costmodel on that
    cell.  Schema v2: per-candidate timing stats with spread, skipped
    candidates with their reasons, the stage-2 grid (``tuning``), the
    measured ``plan`` and the active calibration's provenance.
    """
    from repro_torch.bench.report import environment_fingerprint
    from repro_torch.plan import pick_measured, plan_conv2d, tune_measured
    from repro_torch.plan.calibrate import calibration_info
    from repro_torch.plan.convplan import MEASURED_NOISE_MARGIN
    require_device(device)
    results: List[Dict] = []
    for sc in resolve_suite(base_suite):
        if progress:
            progress(f"[bench] autotune/{sc.name}")
        analytic = plan_conv2d(sc.run_spec, dtype=sc.dtype, mode="analytic",
                               backend=device, partition="none")
        plan, detail = tune_measured(sc.run_spec, sc.dtype, backend=device,
                                     iters=iters, warmup=warmup,
                                     candidates=sc.tune_candidates)
        times = detail["candidate_us"]
        # The planner's own rule: the noise margin ties to analytic,
        # widened to each candidate's observed spread.
        measured_alg = pick_measured(times, analytic.algorithm, spreads={
            a: s.get("us_rel_spread")
            for a, s in detail["candidate_stats"].items()})
        analytic_us = times.get(analytic.algorithm)
        measured_us = times[measured_alg]
        spreads = [s.get("us_rel_spread")
                   for s in detail["candidate_stats"].values()
                   if s.get("us_rel_spread") is not None]
        results.append({
            "scenario": sc.name,
            "dtype": sc.dtype,
            "run_spec": dataclasses.asdict(sc.run_spec),
            "analytic_algorithm": analytic.algorithm,
            "analytic_us": analytic_us,
            "measured_algorithm": measured_alg,
            "measured_us": measured_us,
            "candidate_us": {a: times[a] for a in sorted(times)},
            "candidate_stats": {a: detail["candidate_stats"][a]
                                for a in sorted(detail["candidate_stats"])},
            "skipped": dict(sorted(detail["skipped"].items())),
            "n_skipped": len(detail["skipped"]),
            "max_rel_spread": (round(max(spreads), 4) if spreads else None),
            "tuning": detail["tuning"],
            "plan": plan.to_dict(),
            "speedup": (None if not analytic_us
                        else round(analytic_us / measured_us, 3)),
            "pick_agrees": measured_alg == analytic.algorithm,
        })
    return {
        "autotune_schema_version": 2,
        "suite": "autotune",
        "base_suite": base_suite,
        "environment": environment_fingerprint(device),
        "calibration": calibration_info(device),
        "harness": {"iters": iters, "warmup": warmup, "device": device,
                    "noise_margin": MEASURED_NOISE_MARGIN},
        "results": results,
    }
