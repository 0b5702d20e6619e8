"""BENCH_torch_<suite>.json: schema, environment fingerprint, validation,
CSV (counterpart of ``repro.bench.report``).

The record schema is the JAX package's, field for field, so the two
packages' reports validate and diff alike: one flat record per
(scenario, algorithm) cell.  Only the environment block differs: it names
``torch``, ``cuda`` and the card (``device_kind``) where the JAX
package's names ``jax``.  Validation is hand-rolled and strict: a report
that fails it is never written.
"""
from __future__ import annotations

import json
import pathlib
import platform
from typing import Dict, List, Optional, Sequence

SCHEMA_VERSION = 1

_NUM = (int, float)
_OPT_NUM = (int, float, type(None))

# field -> allowed types; every result record must carry all of them.
RESULT_FIELDS = {
    "scenario": str,
    "algorithm": str,
    "dtype": str,
    "weight": int,
    "spec": dict,
    "run_spec": dict,
    "overhead_elems": int,
    "overhead_bytes": int,
    "flops": _NUM,
    "run_flops": _NUM,
    "auto_algorithm": str,
    "out_shape": list,
    "us_per_call": _OPT_NUM,
    "timing": (dict, type(None)),
    # Always None in the port: PyTorch has no HLO (see harness.measure).
    "hlo_flops": _OPT_NUM,
    "hlo_bytes": _OPT_NUM,
}

# Optional fields, type-checked when present.  The distributed block
# (partition present => all of it present, but for the exempt fields
# below) comes from the JAX package's ``dist`` suite; ``plan`` is the
# cell's resolved analytic ConvPlan; the serve, shardcheck and numcheck
# fields come from JAX-package suites the port reads but does not run yet.
OPTIONAL_RESULT_FIELDS = {
    "partition": str,
    "n_dev": int,
    "n_dev_axes": list,
    "halo_bytes_per_device": _NUM,
    "per_device_overhead_elems": _NUM,
    "comm_bytes_per_device": _NUM,
    "auto_partition": (str, type(None)),
    "plan": dict,
    "serve_mode": str,
    "shape_class": str,
    "n_classes": int,
    "n_requests": int,
    "p50_us": _OPT_NUM,
    "p99_us": _OPT_NUM,
    "first_request_us": _OPT_NUM,
    "throughput_rps": _OPT_NUM,
    "warmup_warnings": int,
    "plan_cache_io_errors": int,
    "shardcheck": dict,
    "numcheck": dict,
}

# Type-checked when present but outside the partition block rule.
_BLOCK_EXEMPT_FIELDS = ("n_dev_axes", "plan", "serve_mode", "shape_class",
                        "n_classes", "n_requests", "p50_us", "p99_us",
                        "first_request_us", "throughput_rps",
                        "warmup_warnings", "plan_cache_io_errors",
                        "shardcheck", "numcheck")

# Suite "memaudit" (repro_torch.analysis.memaudit): one record per audited
# (scenario, algorithm) cell, the measured temporary bytes against the
# Eq. 2-4 prediction.  measured_*/ratio/slack are None where the device
# exposes no allocator statistics (the CPU); verdict is
# "pass"/"fail"/"recorded" and policy says whether the cell was gated.
MEMAUDIT_RESULT_FIELDS = {
    "scenario": str,
    "algorithm": str,
    "dtype": str,
    "spec": dict,
    "predicted_overhead_elems": int,
    "predicted_overhead_bytes": int,
    "measured_temp_bytes": _OPT_NUM,
    "measured_argument_bytes": _OPT_NUM,
    "measured_output_bytes": _OPT_NUM,
    "ratio": _OPT_NUM,
    "slack_bytes": _OPT_NUM,
    "tolerance": dict,
    "policy": str,
    "source": (str, type(None)),
    "verdict": str,
}

# The JAX package's shardcheck and numcheck suites, so that its reports
# validate here too.
SHARDCHECK_RESULT_FIELDS = {
    "scenario": str,
    "algorithm": str,
    "dtype": str,
    "spec": dict,
    "source": str,
    "partition": str,
    "n_dev": int,
    "n_dev_axes": list,
    "directions": dict,
    "precision_flow": (dict, type(None)),
    "verdict": str,
    "skipped_reason": (str, type(None)),
    "violations": list,
}

NUMCHECK_RESULT_FIELDS = {
    "scenario": str,
    "algorithm": str,
    "dtype": str,
    "spec": dict,
    "source": str,
    "contract": (dict, type(None)),
    "directions": dict,
    "precision_flow": (dict, type(None)),
    "probe": (dict, type(None)),
    "verdict": str,
    "skipped_reason": (str, type(None)),
    "violations": list,
}

# suite name -> required per-record fields; other suites use the timing
# schema above.
RESULT_FIELDS_BY_SUITE = {"memaudit": MEMAUDIT_RESULT_FIELDS,
                          "shardcheck": SHARDCHECK_RESULT_FIELDS,
                          "numcheck": NUMCHECK_RESULT_FIELDS}

SPEC_FIELDS = ("i_n", "i_h", "i_w", "i_c", "k_h", "k_w", "k_c", "s_h", "s_w")

ENV_FIELDS = ("torch", "cuda", "numpy", "python", "backend", "device_count",
              "device_kind", "platform")


def environment_fingerprint(backend: str = "cuda") -> Dict:
    """Everything needed to judge whether two reports are comparable, for
    a run on ``backend`` ("cuda" or "cpu")."""
    import numpy as np
    import torch
    on_card = backend == "cuda"
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "numpy": np.__version__,
        "python": platform.python_version(),
        "backend": backend,
        "device_count": torch.cuda.device_count() if on_card else 1,
        "device_kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "platform": platform.platform(),
    }


def make_report(suite: str, results: Sequence[Dict], harness: Dict,
                crosscheck: Optional[List[Dict]] = None,
                backend: str = "cuda") -> Dict:
    doc = {
        "schema_version": SCHEMA_VERSION,
        "suite": suite,
        "environment": environment_fingerprint(backend),
        "harness": harness,
        "results": list(results),
    }
    if crosscheck is not None:
        doc["crosscheck"] = crosscheck
    errors = validate_report(doc)
    if errors:
        raise ValueError("refusing to emit invalid report:\n  "
                         + "\n  ".join(errors))
    return doc


def validate_report(doc: Dict) -> List[str]:
    """All schema violations (empty list == valid)."""
    errs: List[str] = []
    if not isinstance(doc, dict):
        return ["report is not a JSON object"]
    if doc.get("schema_version") != SCHEMA_VERSION:
        errs.append(f"schema_version must be {SCHEMA_VERSION}, "
                    f"got {doc.get('schema_version')!r}")
    if not isinstance(doc.get("suite"), str) or not doc.get("suite"):
        errs.append("suite must be a non-empty string")
    env = doc.get("environment")
    if not isinstance(env, dict):
        errs.append("environment must be an object")
    else:
        for k in ENV_FIELDS:
            if k not in env:
                errs.append(f"environment missing {k!r}")
    if not isinstance(doc.get("harness"), dict):
        errs.append("harness must be an object")
    results = doc.get("results")
    if not isinstance(results, list) or not results:
        return errs + ["results must be a non-empty list"]
    fields = RESULT_FIELDS_BY_SUITE.get(doc.get("suite"), RESULT_FIELDS)
    seen = set()
    for i, rec in enumerate(results):
        where = f"results[{i}]"
        if not isinstance(rec, dict):
            errs.append(f"{where} is not an object")
            continue
        for field, types in fields.items():
            if field not in rec:
                errs.append(f"{where} missing {field!r}")
            elif not isinstance(rec[field], types) \
                    or isinstance(rec[field], bool):
                errs.append(f"{where}.{field} has type "
                            f"{type(rec[field]).__name__}")
        if fields is RESULT_FIELDS:
            for field, types in OPTIONAL_RESULT_FIELDS.items():
                if field in rec and (not isinstance(rec[field], types)
                                     or isinstance(rec[field], bool)):
                    errs.append(f"{where}.{field} has type "
                                f"{type(rec[field]).__name__}")
            if "partition" in rec:
                missing = [f for f in OPTIONAL_RESULT_FIELDS
                           if f not in rec and f not in _BLOCK_EXEMPT_FIELDS]
                if missing:
                    errs.append(f"{where}: distributed cell missing "
                                f"{missing}")
        if "serve_mode" in rec:
            missing = [f for f in ("shape_class", "n_classes", "n_requests",
                                   "warmup_warnings",
                                   "plan_cache_io_errors")
                       if f not in rec]
            if missing:
                errs.append(f"{where}: serve cell missing {missing}")
        for sf in ("spec", "run_spec"):
            spec = rec.get(sf)
            if isinstance(spec, dict):
                missing = [k for k in SPEC_FIELDS
                           if not isinstance(spec.get(k), int)]
                if missing:
                    errs.append(f"{where}.{sf} missing int fields {missing}")
        key = (rec.get("scenario"), rec.get("algorithm"))
        if key in seen:
            errs.append(f"{where}: duplicate (scenario, algorithm) {key}")
        seen.add(key)
    return errs


def result_key(rec: Dict) -> str:
    return f"{rec['scenario']}/{rec['algorithm']}"


def write_report(doc: Dict, path) -> pathlib.Path:
    path = pathlib.Path(path)
    errors = validate_report(doc)
    if errors:
        raise ValueError("refusing to write invalid report:\n  "
                         + "\n  ".join(errors))
    path.write_text(json.dumps(doc, indent=2, sort_keys=False) + "\n")
    return path


def render_csv(doc: Dict) -> List[str]:
    """``table,name,us_per_call,derived`` lines, the JAX package's legacy
    table."""
    lines = ["table,name,us_per_call,derived"]
    for rec in doc["results"]:
        us = rec["us_per_call"]
        derived = (f"overhead_bytes={rec['overhead_bytes']};"
                   f"flops={rec['flops']:.3e};auto={rec['auto_algorithm']}")
        if rec["hlo_flops"] is not None:
            derived += f";hlo_flops={rec['hlo_flops']:.3e}"
        lines.append(f"{doc['suite']},{result_key(rec)},"
                     f"{0 if us is None else us:.0f},{derived}")
    return lines
