"""Memory auditor: the allocator's bytes against the paper's Eqs. 2-4
(counterpart of ``repro.analysis.memaudit``).

For every plan (by default the port's own analytic plans of the
``smoke`` and ``table2`` suites, built for the device audited), run one
``conv2d(plan=)`` call and gate its temporary bytes against the analytic
model (``core.memory.algorithm_overhead`` x dtype size).

**What is measured.**  On the card: the peak bytes one call requests
above what was live before it (``torch.cuda.memory_stats``
``requested_bytes``, after ``reset_peak_memory_stats`` and a warm-up
call, so that a library's one-time workspace is not counted), less the
output's bytes: what the model counts, tensor for tensor.  The same in
the caching allocator's blocks (``max_memory_allocated``) stands beside
it as ``measured_block_bytes``: a block the allocator reuses is not
split when what is left is under 1 MB, so the blocks can exceed the
request by up to that much, depending on what earlier calls left in the
cache.  The CPU exposes no allocator statistics: every cell there is
``recorded`` with ``measured_* = None``.

Tolerance policy, keyed by the base model name:

* ``direct``, ``im2col``, ``mec``, ``winograd``, ``fft``: the JAX
  package's bands (:data:`TOLERANCES`), kept as they are, gated on the
  card like the kernel paths.  ``direct`` is cuDNN's convolution: what
  the library allocates inside the one ``F.conv2d`` call (its workspace,
  and the KRSC copy of the kernel its binding makes) is measured apart,
  as the peak of the bare ``F.conv2d`` call on the same operands
  (``library_workspace_bytes``), and the 4,096 B slack holds the bytes
  that remain, the port's own.
* The CUDA kernel paths (:data:`KERNEL_ALGORITHMS`) are gated on the
  card, where the JAX package only records its Pallas kernels off the
  TPU: ``mec_fused`` and ``mec_fused2`` keep no temporary and
  ``mec_lowered`` keeps exactly the Eq. 3 L, with 2 MiB of allocator
  slack (:data:`KERNEL_TOLERANCE`).

Every cell whose base model is ``mec`` gets an ``im2col`` companion and a
crosscheck (one per mec cell, naming its algorithm): measured mec
temporary bytes must stay below im2col's whenever Eq. 4 predicts a
saving, the paper's claim.  On the card, where every analytic plan is
K1, each plan's geometry is also audited under every other algorithm the
planner may pick, so that K1-K4, the plain algorithms' bands and the
crosscheck (through ``mec_lowered``'s L and the plain ``mec``) are all
read.

Output is a schema-validated report (suite ``memaudit``) through
``repro_torch.bench.report``.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import memory
from repro_torch.core.convspec import ConvSpec

# ratio = measured_temp_bytes / predicted_overhead_bytes.
TOLERANCES: Dict[str, Dict[str, float]] = {
    "direct": {"abs_slack": 4096},
    "im2col": {"lo": 0.98, "hi": 1.15},
    "mec": {"lo": 0.95, "hi": 1.9},
    "winograd": {"lo": 0.95, "hi": 2.0},
    "fft": {"lo": 0.95, "hi": 2.1},
}

KERNEL_ALGORITHMS = ("mec_fused", "mec_fused2", "mec_lowered")
# predicted <= measured <= predicted + 2 MiB (allocator rounding)
KERNEL_TOLERANCE: Dict[str, float] = {"min_slack": 0, "abs_slack": 2 << 20}

DEFAULT_SUITES = ("smoke", "table2")
DEFAULT_REPORT = "BENCH_torch_memaudit.json"
MEASURE_SOURCE = "torch.cuda.memory_stats requested_bytes"


def _base_algorithm(algorithm: str) -> str:
    return memory._DISPATCH_BASE.get(algorithm, algorithm)


def tolerance_for(algorithm: str) -> Dict[str, float]:
    if algorithm in KERNEL_ALGORITHMS:
        return KERNEL_TOLERANCE
    return TOLERANCES[_base_algorithm(algorithm)]


def _temp_bytes(call) -> Tuple[int, int, int]:
    """(temporary bytes, the same in allocator blocks, output bytes) of
    the second of two calls of a nullary ``call`` on the card: its peak
    above what was live before it, less the output it returns.  The first
    call makes the one-time workspaces and handles, which an emptied
    cache then keeps.  The temporary bytes are what the call requested;
    the block bytes add the caching allocator's rounding (a reused free
    block under 1 MB larger than the request is not split)."""
    import torch
    call()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    requested = torch.cuda.memory_stats()["requested_bytes.all.current"]
    allocated = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = call()
    torch.cuda.synchronize()
    peak = torch.cuda.memory_stats()["requested_bytes.all.peak"] - requested
    blocks = torch.cuda.max_memory_allocated() - allocated
    out_bytes = out.numel() * out.element_size()
    del out
    return peak - out_bytes, blocks - out_bytes, out_bytes


def measure_plan(plan) -> Optional[Dict]:
    """The allocator's bytes around one ``conv2d(plan=)`` call on the
    card: ``temp_bytes`` (peak above what was live, less the output),
    ``argument_bytes``, ``output_bytes``, and for ``direct`` the
    library's own, ``library_workspace_bytes`` (the bare ``F.conv2d``
    call on the operands ``direct_conv2d`` hands it, measured alike;
    None for every other algorithm).  None for a CPU plan."""
    if plan.backend != "cuda":
        return None
    import torch
    import torch.nn.functional as F
    from repro_torch.bench.harness import make_arrays
    from repro_torch.core.conv_api import conv2d
    from repro_torch.core.direct import cudnn_operands, ieee_f32_conv
    s = plan.spec
    inp, ker = make_arrays(s, plan.dtype, device="cuda")

    def call():
        with torch.no_grad():
            return conv2d(inp, ker, stride=(s.s_h, s.s_w), plan=plan)

    def library_call():
        x, w = cudnn_operands(inp, ker)
        with torch.no_grad(), ieee_f32_conv():
            return F.conv2d(x, w, stride=(s.s_h, s.s_w))

    temp, blocks, out_bytes = _temp_bytes(call)
    library = _temp_bytes(library_call)[0] \
        if plan.algorithm == "direct" else None
    return {"temp_bytes": temp, "block_bytes": blocks,
            "argument_bytes": (inp.numel() * inp.element_size()
                               + ker.numel() * ker.element_size()),
            "output_bytes": out_bytes, "library_workspace_bytes": library,
            "source": MEASURE_SOURCE}


def gate(scenario: str, algorithm: str, predicted_bytes: int,
         measured: Optional[int]) -> Tuple[Dict, List[str]]:
    """The verdict on one cell: ``{ratio, slack_bytes, tolerance, policy,
    verdict}`` and its gate failures.  ``measured`` None (no allocator
    statistics) records the cell ungated."""
    tol = tolerance_for(algorithm)
    ratio = None
    slack = None
    policy = "gated"
    failures: List[str] = []
    if measured is None:
        verdict = "recorded"
        policy = "recorded"
    elif "abs_slack" in tol:
        slack = measured - predicted_bytes
        if predicted_bytes:
            ratio = measured / predicted_bytes
        ok = tol.get("min_slack", slack) <= slack <= tol["abs_slack"]
        verdict = "pass" if ok else "fail"
    else:
        slack = measured - predicted_bytes
        if predicted_bytes <= 0:
            verdict = "fail"
            failures.append(
                f"{scenario}/{algorithm}: model predicts no overhead "
                f"but algorithm is ratio-gated")
        else:
            ratio = measured / predicted_bytes
            verdict = "pass" if tol["lo"] <= ratio <= tol["hi"] else "fail"
    if verdict == "fail" and not failures:
        failures.append(
            f"{scenario}/{algorithm}: measured temp {measured}B vs "
            f"predicted {predicted_bytes}B "
            f"(ratio={'n/a' if ratio is None else f'{ratio:.3f}'}, "
            f"slack={slack}B) outside {tol}")
    return {"ratio": ratio, "slack_bytes": slack, "tolerance": dict(tol),
            "policy": policy, "verdict": verdict}, failures


def audit_plan(scenario: str, plan) -> Tuple[Dict, List[str]]:
    """One audit record (bench-report shape) and its gate failures."""
    import torch
    s = plan.spec
    dtype_bytes = getattr(torch, plan.dtype).itemsize
    predicted_elems = memory.algorithm_overhead(s, plan.algorithm)
    predicted_bytes = predicted_elems * dtype_bytes
    stats = measure_plan(plan)
    measured = None if stats is None else stats["temp_bytes"]
    library = None if stats is None else stats["library_workspace_bytes"]
    # the gate reads the port's own bytes: the library's are apart
    verdict, failures = gate(scenario, plan.algorithm, predicted_bytes,
                             measured if library is None
                             else measured - library)
    record = {
        "scenario": scenario,
        "algorithm": plan.algorithm,
        "dtype": plan.dtype,
        "spec": dataclasses.asdict(s),
        "predicted_overhead_elems": predicted_elems,
        "predicted_overhead_bytes": predicted_bytes,
        "measured_temp_bytes": measured,
        "library_workspace_bytes": library,
        "measured_block_bytes": None if stats is None
        else stats["block_bytes"],
        "measured_argument_bytes": None if stats is None
        else stats["argument_bytes"],
        "measured_output_bytes": None if stats is None
        else stats["output_bytes"],
        "ratio": verdict["ratio"],
        "slack_bytes": verdict["slack_bytes"],
        "tolerance": verdict["tolerance"],
        "policy": verdict["policy"],
        "source": None if stats is None else stats["source"],
        "verdict": verdict["verdict"],
    }
    return record, failures


def _companion_plan(plan, algorithm: str):
    """Same cell, different algorithm."""
    return dataclasses.replace(plan, algorithm=algorithm, solution="auto",
                               w_blk=None)


def _audited_plans(plan) -> List:
    """The plan, and on the card its geometry under every other
    algorithm the planner may pick (``convplan.eligible_candidates``)."""
    cells = [plan]
    if plan.backend == "cuda":
        from repro_torch.plan.convplan import eligible_candidates
        cells += [_companion_plan(plan, a)
                  for a in eligible_candidates(plan.spec)
                  if a != plan.algorithm]
    return cells


def plans_of(doc: Dict) -> Dict[str, object]:
    """name -> ConvPlan of a plans document (``python -m
    repro_torch.plan``'s, or the JAX package's)."""
    from repro_torch.plan.convplan import ConvPlan
    return {name: ConvPlan.from_dict(d)
            for name, d in sorted(doc["plans"].items())}


def load_plans(path) -> Dict[str, object]:
    return plans_of(json.loads(pathlib.Path(path).read_text()))


def record_calibration(records: Sequence[Dict], store=None,
                       backend: str = "cuda") -> int:
    """Feed the memory side of the fit: every gated measured/predicted
    ratio becomes a memory sample in the calibration store of
    ``backend``.  Returns the number of samples added; flushes when it
    created the store."""
    from repro_torch.plan.calibrate import CalibrationStore
    own = store is None
    store = store or CalibrationStore(backend=backend)
    n = 0
    for rec in records:
        if rec.get("policy") != "gated" or rec.get("ratio") is None:
            continue
        store.add_memory(ConvSpec(**rec["spec"]), rec["dtype"],
                         _base_algorithm(rec["algorithm"]),
                         float(rec["ratio"]))
        n += 1
    if own and n:
        store.flush()
    return n


def run_audit(plans_path=None, plans: Optional[Dict[str, object]] = None,
              calibration_store=None,
              device: str = "cuda") -> Tuple[Dict, List[str]]:
    """Audit every plan (and its companions) on ``device``.

    ``plans`` (name -> ConvPlan), else ``plans_path`` (a plans document),
    else the analytic plans of :data:`DEFAULT_SUITES` built for
    ``device``.  Returns ``(report_doc, failures)``: the doc validates as
    suite ``memaudit``; failures is the flat list of gate violations.
    Pass a ``CalibrationStore`` (or True for the ambient one of
    ``device``) to also record the gated ratios as memory samples.
    """
    from repro_torch.bench.harness import require_device
    from repro_torch.bench.report import make_report
    from repro_torch.plan.__main__ import build_plans
    require_device(device)
    if plans is None:
        plans = load_plans(plans_path) if plans_path \
            else plans_of(build_plans(DEFAULT_SUITES, backend=device))
    results: List[Dict] = []
    crosscheck: List[Dict] = []
    failures: List[str] = []
    for scenario, plan in plans.items():
        recs: Dict[str, Dict] = {}
        for cell in _audited_plans(plan):
            todo = [cell]
            if _base_algorithm(cell.algorithm) == "mec" \
                    and "im2col" not in recs:
                todo.append(_companion_plan(cell, "im2col"))
            for p in todo:
                if p.algorithm in recs:
                    continue
                rec, fails = audit_plan(scenario, p)
                results.append(rec)
                failures.extend(fails)
                recs[p.algorithm] = rec
        saving = memory.mec_saving(plan.spec)
        for alg, rec in recs.items():
            if _base_algorithm(alg) != "mec":
                continue
            mec_b = rec["measured_temp_bytes"]
            im2col_b = recs["im2col"]["measured_temp_bytes"]
            ok = (mec_b is None or im2col_b is None or saving <= 0
                  or mec_b < im2col_b)
            crosscheck.append({
                "scenario": scenario,
                "algorithm": alg,
                "mec_temp_bytes": mec_b,
                "im2col_temp_bytes": im2col_b,
                "mec_saving_elems": saving,
                "ok": "yes" if ok else "no",
            })
            if not ok:
                failures.append(
                    f"{scenario}/{alg}: Eq. 4 predicts a {saving}-element "
                    f"saving but measured mec temp {mec_b}B >= "
                    f"im2col temp {im2col_b}B")
    if calibration_store is not None and calibration_store is not False:
        record_calibration(
            results, None if calibration_store is True else calibration_store,
            backend=device)
    doc = make_report(
        "memaudit", results,
        harness={
            "plans_path": str(plans_path) if plans_path else
            f"<analytic plans of {'+'.join(DEFAULT_SUITES)}>",
            "tolerances": TOLERANCES,
            "kernel_tolerance": KERNEL_TOLERANCE,
            "device": device,
            "measured": (MEASURE_SOURCE + " above live, less the output"
                         if device == "cuda" else "none (no allocator "
                                                  "statistics on the CPU)"),
        },
        crosscheck=crosscheck, backend=device)
    return doc, failures


def write_audit(plans_path=None, out_path=None, calibration_store=None,
                device: str = "cuda") -> Tuple[pathlib.Path, List[str]]:
    from repro_torch.bench.report import write_report
    doc, failures = run_audit(plans_path, calibration_store=calibration_store,
                              device=device)
    out = pathlib.Path(out_path or DEFAULT_REPORT)
    write_report(doc, out)
    return out, failures
