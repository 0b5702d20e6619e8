"""Regression gate: compare a BENCH_torch_<suite>.json against a baseline
(counterpart of ``repro.bench.check``).

Per-metric policy:

* **exact**: ``overhead_elems``, ``overhead_bytes``, ``flops``,
  ``run_flops``, ``out_shape``, ``spec``, ``run_spec``, ``dtype``,
  ``auto_algorithm`` (not compared when the two backends differ: the
  ``auto`` rule branches on the backend).  Analytic and deterministic:
  any drift is a behaviour change and fails.
* **tolerance**: ``us_per_call`` fails only when slower than the baseline
  by more than ``--timing-rtol`` (default 1.0, i.e. 2x).
  ``--schema-only-on-timing`` skips the timing comparison.
* **informational**: ``hlo_flops``/``hlo_bytes`` (always None in the
  port's own reports), and the environment: a different ``torch`` or
  card (``device_kind``) is a note, where the JAX package notes ``jax``.

Every baseline cell must be present in the new report; extra cells are
fine.  Autotune documents (``autotune_schema_version``) get their own
policy: exact on the decision fields, loud on newly ``skipped``
candidates, tolerance on the measured us fields, notes on the spread.

Exit status: 0 clean, 1 regression/schema failure, 2 usage error.

  PYTHONPATH=src python -m repro_torch.bench.check BENCH_torch_smoke.json \\
      --baseline base.json --schema-only-on-timing
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Dict, List, Tuple

from repro_torch.bench.report import result_key, validate_report

EXACT_FIELDS = ("dtype", "spec", "run_spec", "out_shape", "overhead_elems",
                "overhead_bytes", "flops", "run_flops", "auto_algorithm")

# Distributed-cell analytics and the serve-suite structural fields of the
# JAX package's reports: exact, but only gated when the baseline record
# carries them.
OPTIONAL_EXACT_FIELDS = ("partition", "n_dev", "n_dev_axes",
                         "halo_bytes_per_device",
                         "per_device_overhead_elems",
                         "comm_bytes_per_device", "auto_partition",
                         "serve_mode", "shape_class", "n_classes",
                         "n_requests", "shardcheck", "numcheck")

# Reports whose suite carries its own record schema gate exactly on their
# deterministic fields only (verdicts, contracts, predictions), never on
# measured bytes or errors; they have no timing fields either.
SUITE_EXACT_FIELDS = {
    "numcheck": ("dtype", "spec", "source", "contract", "verdict",
                 "skipped_reason", "violations"),
    "shardcheck": ("dtype", "spec", "source", "partition", "n_dev",
                   "n_dev_axes", "verdict", "skipped_reason",
                   "violations"),
    "memaudit": ("dtype", "spec", "predicted_overhead_elems",
                 "predicted_overhead_bytes", "policy", "verdict"),
}


def _load(path) -> Dict:
    p = pathlib.Path(path)
    try:
        return json.loads(p.read_text())
    except FileNotFoundError:
        raise SystemExit(f"[bench.check] no such file: {p}")
    except json.JSONDecodeError as e:
        raise SystemExit(f"[bench.check] {p} is not valid JSON: {e}")


# Autotune documents (bench.harness.run_autotune) carry their own
# schema; per cell these fields are deterministic given an environment +
# calibration and gate exactly, while measured decisions and anything
# us-valued follow the timing policy (noted / tolerance-checked).
AUTOTUNE_EXACT_FIELDS = ("dtype", "run_spec", "analytic_algorithm")
AUTOTUNE_SCHEMA_VERSIONS = (1, 2)


def _compare_autotune(new: Dict, baseline: Dict, timing_rtol: float,
                      schema_only_on_timing: bool
                      ) -> Tuple[List[str], List[str]]:
    """Autotune-report diff: exact on the decision fields, tolerance on
    the measured/spread fields, and loud on coverage: a candidate newly ``skipped`` relative to the
    baseline is a real loss of the race, not noise."""
    failures: List[str] = []
    notes: List[str] = []
    for label, doc in (("new report", new), ("baseline", baseline)):
        v = doc.get("autotune_schema_version")
        if v not in AUTOTUNE_SCHEMA_VERSIONS:
            failures.append(f"schema ({label}): autotune_schema_version "
                            f"{v!r} not in {AUTOTUNE_SCHEMA_VERSIONS}")
        if not isinstance(doc.get("results"), list) or not doc.get("results"):
            failures.append(f"schema ({label}): results must be a "
                            "non-empty list")
    if failures:
        return failures, notes
    if new.get("base_suite") != baseline.get("base_suite"):
        failures.append(f"base_suite mismatch: new={new.get('base_suite')!r} "
                        f"baseline={baseline.get('base_suite')!r}")
        return failures, notes
    backend_differs = (new["environment"]["backend"]
                       != baseline["environment"]["backend"])
    exact = AUTOTUNE_EXACT_FIELDS
    if backend_differs:
        notes.append(f"backend differs: new={new['environment']['backend']} "
                     f"baseline={baseline['environment']['backend']} "
                     "(analytic_algorithm not compared)")
        exact = tuple(f for f in exact if f != "analytic_algorithm")
    if (new.get("calibration") or {}).get("active") != \
            (baseline.get("calibration") or {}).get("active"):
        notes.append(
            f"calibration active differs: new="
            f"{(new.get('calibration') or {}).get('active')!r} baseline="
            f"{(baseline.get('calibration') or {}).get('active')!r} "
            "(analytic picks may legitimately move)")
        exact = tuple(f for f in exact if f != "analytic_algorithm")
    key = lambda r: f"{r['scenario']}/{r.get('dtype')}"  # noqa: E731
    new_by_key = {key(r): r for r in new["results"]}
    for base in baseline["results"]:
        k = key(base)
        rec = new_by_key.get(k)
        if rec is None:
            failures.append(f"{k}: missing from new report "
                            "(coverage regression)")
            continue
        for f in exact:
            if rec.get(f) != base.get(f):
                failures.append(f"{k}: {f} changed {base.get(f)!r} -> "
                                f"{rec.get(f)!r}")
        for f in ("measured_algorithm", "pick_agrees"):
            if rec.get(f) != base.get(f):
                notes.append(f"{k}: {f} drifted {base.get(f)!r} -> "
                             f"{rec.get(f)!r} (measured; informational)")
        new_skips = set(rec.get("skipped") or {}) \
            - set(base.get("skipped") or {})
        if new_skips:
            failures.append(
                f"{k}: candidate(s) newly skipped vs baseline: "
                + ", ".join(f"{a} ({(rec.get('skipped') or {})[a]})"
                            for a in sorted(new_skips)))
        if schema_only_on_timing:
            continue
        for f in ("measured_us", "analytic_us"):
            b_us, n_us = base.get(f), rec.get(f)
            if b_us is None or n_us is None:
                continue
            if n_us > b_us * (1.0 + timing_rtol):
                failures.append(f"{k}: {f} regressed {b_us:.0f} -> "
                                f"{n_us:.0f} (> {1.0 + timing_rtol:.1f}x "
                                "baseline)")
        b_sp, n_sp = base.get("max_rel_spread"), rec.get("max_rel_spread")
        if b_sp is not None and n_sp is not None and n_sp > b_sp * 4 \
                and n_sp > 0.25:
            notes.append(f"{k}: max_rel_spread grew {b_sp} -> {n_sp} "
                         "(noisy run; spread fields never fail)")
    extra = set(new_by_key) - {key(r) for r in baseline["results"]}
    if extra:
        notes.append(f"{len(extra)} cells not in baseline (new coverage): "
                     + ", ".join(sorted(extra)[:5])
                     + ("..." if len(extra) > 5 else ""))
    return failures, notes


def compare(new: Dict, baseline: Dict, timing_rtol: float = 1.0,
            schema_only_on_timing: bool = False) -> Tuple[List[str], List[str]]:
    """(failures, notes) from diffing ``new`` against ``baseline``."""
    failures: List[str] = []
    notes: List[str] = []
    if "autotune_schema_version" in new \
            or "autotune_schema_version" in baseline:
        return _compare_autotune(new, baseline, timing_rtol,
                                 schema_only_on_timing)
    for label, doc in (("new report", new), ("baseline", baseline)):
        for err in validate_report(doc):
            failures.append(f"schema ({label}): {err}")
    if failures:
        return failures, notes
    if new["suite"] != baseline["suite"]:
        failures.append(f"suite mismatch: new={new['suite']!r} "
                        f"baseline={baseline['suite']!r}")
        return failures, notes
    for f in ("torch", "device_kind"):
        if new["environment"][f] != baseline["environment"][f]:
            notes.append(f"{f} differs: new={new['environment'][f]} "
                         f"baseline={baseline['environment'][f]}")
    suite_schema = new["suite"] in SUITE_EXACT_FIELDS
    exact_fields = SUITE_EXACT_FIELDS.get(new["suite"], EXACT_FIELDS)
    if new["environment"]["backend"] != baseline["environment"]["backend"]:
        # auto dispatch branches on the backend, so across backends its
        # pick is expected to differ: don't gate on it.
        exact_fields = tuple(f for f in exact_fields
                             if f != "auto_algorithm")
        notes.append(f"backend differs: new="
                     f"{new['environment']['backend']} baseline="
                     f"{baseline['environment']['backend']} "
                     "(auto_algorithm not compared)")

    new_by_key = {result_key(r): r for r in new["results"]}
    for base in baseline["results"]:
        key = result_key(base)
        rec = new_by_key.get(key)
        if rec is None:
            failures.append(f"{key}: missing from new report "
                            "(coverage regression)")
            continue
        for f in exact_fields:
            if rec.get(f) != base.get(f):
                failures.append(f"{key}: {f} changed "
                                f"{base.get(f)!r} -> {rec.get(f)!r}")
        if suite_schema:
            # Suite-schema records carry no optional dist/serve block
            # and no timing fields — the exact set above is the whole
            # gate.
            continue
        for f in OPTIONAL_EXACT_FIELDS:
            if f in base and rec.get(f) != base[f]:
                failures.append(f"{key}: {f} changed "
                                f"{base[f]!r} -> {rec.get(f)!r}")
        for f in ("hlo_flops", "hlo_bytes"):
            if rec[f] != base[f]:
                notes.append(f"{key}: {f} drifted {base[f]!r} -> {rec[f]!r} "
                             "(informational)")
        if schema_only_on_timing:
            continue
        b_us, n_us = base["us_per_call"], rec["us_per_call"]
        if b_us is None or n_us is None:
            if (b_us is None) != (n_us is None):
                failures.append(f"{key}: us_per_call presence changed "
                                f"{b_us!r} -> {n_us!r}")
            continue
        if n_us > b_us * (1.0 + timing_rtol):
            failures.append(f"{key}: us_per_call regressed "
                            f"{b_us:.0f} -> {n_us:.0f} "
                            f"(> {1.0 + timing_rtol:.1f}x baseline)")
    extra = set(new_by_key) - {result_key(r) for r in baseline["results"]}
    if extra:
        notes.append(f"{len(extra)} cells not in baseline (new coverage): "
                     + ", ".join(sorted(extra)[:5])
                     + ("..." if len(extra) > 5 else ""))
    return failures, notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.bench.check",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("result", help="BENCH_<suite>.json to check")
    ap.add_argument("--baseline", required=True,
                    help="committed baseline to compare against")
    ap.add_argument("--timing-rtol", type=float, default=1.0,
                    help="allowed relative us_per_call slowdown "
                         "(default 1.0 == 2x)")
    ap.add_argument("--schema-only-on-timing", action="store_true",
                    help="skip timing comparison; schema + exact "
                         "(memory/flops) fields still gate")
    args = ap.parse_args(argv)

    new, baseline = _load(args.result), _load(args.baseline)
    failures, notes = compare(new, baseline, timing_rtol=args.timing_rtol,
                              schema_only_on_timing=args.schema_only_on_timing)
    for n in notes:
        print(f"[bench.check] note: {n}")
    if failures:
        for f in failures:
            print(f"[bench.check] FAIL: {f}", file=sys.stderr)
        print(f"[bench.check] {args.result}: {len(failures)} regression(s) "
              f"vs {args.baseline}", file=sys.stderr)
        return 1
    n_cells = len(baseline["results"])
    print(f"[bench.check] OK: {args.result} matches {args.baseline} "
          f"({n_cells} cells"
          + (", timing schema-only" if args.schema_only_on_timing else "")
          + ")")
    return 0


if __name__ == "__main__":
    sys.exit(main())
