"""Plan CLI (counterpart of ``python -m repro.plan``): build the resolved
plans for bench suites and diff them against a plans document::

  PYTHONPATH=src python -m repro_torch.plan --suites smoke,table2 \\
      [--out plans.json] [--baseline plans.json] \\
      [--calibration calibration.json] [--mode analytic|measured] \\
      [--device cuda|cpu]

  PYTHONPATH=src python -m repro_torch.plan calibrate --report|--check|--fit

Plans are made for the CUDA card unless ``--device cpu``.  The diff is
exact on the decision fields (``algorithm``, ``solution``,
``partition``, ``partition_axes``; ``algorithm`` not compared across
backends, whose ``auto`` rules differ); ``w_blk`` and ``precision`` are
noted.  ``--calibration`` pins the fitted costmodel the picks consult;
the default is the ambient store.  The ``calibrate`` subcommand is
``repro_torch.plan.calibrate.calibrate_main``.  Exit status: 0 clean, 1
drift or schema failure, 2 usage error.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Dict, List, Tuple

PLANS_SCHEMA_VERSION = 1

# Decision fields gated exactly; everything else in the plan dict is
# context (spec/dtype/backend identify the cell) or device-tuned (w_blk).
EXACT_PLAN_FIELDS = ("algorithm", "solution", "partition", "partition_axes")
NOTE_PLAN_FIELDS = ("w_blk", "precision")


def build_plans(suites, mode: str = "analytic", calibration="ambient",
                calibration_path=None, backend: str = "cuda") -> Dict:
    """The plans document of ``suites`` on ``backend``: one plan per
    scenario, on its paper geometry, single-device."""
    from repro_torch.bench.report import environment_fingerprint
    from repro_torch.bench.scenarios import resolve_suite
    from repro_torch.plan import current_calibration, plan_conv2d
    active = (current_calibration(backend) is not None
              if calibration == "ambient" else calibration is not None)
    plans: Dict[str, Dict] = {}
    for suite in suites:
        for sc in resolve_suite(suite):
            key = f"{suite}/{sc.name}"
            if key in plans:
                continue
            plans[key] = plan_conv2d(sc.spec, dtype=sc.dtype, mode=mode,
                                     backend=backend, partition="none",
                                     calibration=calibration).to_dict()
    return {
        "plans_schema_version": PLANS_SCHEMA_VERSION,
        "suites": list(suites),
        "mode": mode,
        "environment": environment_fingerprint(backend),
        "calibration": {
            "path": None if calibration_path is None
            else str(calibration_path),
            "active": active,
        },
        "plans": plans,
    }


def compare_plans(new: Dict, baseline: Dict) -> Tuple[List[str], List[str]]:
    failures: List[str] = []
    notes: List[str] = []
    for label, doc in (("new", new), ("baseline", baseline)):
        if doc.get("plans_schema_version") != PLANS_SCHEMA_VERSION:
            failures.append(f"{label}: plans_schema_version is "
                            f"{doc.get('plans_schema_version')!r}, expected "
                            f"{PLANS_SCHEMA_VERSION}")
        if not isinstance(doc.get("plans"), dict) or not doc.get("plans"):
            failures.append(f"{label}: plans must be a non-empty object")
    if failures:
        return failures, notes
    exact = EXACT_PLAN_FIELDS
    new_backend = new.get("environment", {}).get("backend")
    base_backend = baseline.get("environment", {}).get("backend")
    if new_backend != base_backend:
        # The analytic pick branches on the backend; across backends
        # algorithm drift is expected, not a regression.
        exact = tuple(f for f in exact if f != "algorithm")
        notes.append(f"backend differs: new={new_backend} "
                     f"baseline={base_backend} (algorithm not compared)")
    for key, base_plan in baseline["plans"].items():
        new_plan = new["plans"].get(key)
        if new_plan is None:
            failures.append(f"{key}: missing from new plans "
                            "(coverage regression)")
            continue
        for f in exact:
            if new_plan.get(f) != base_plan.get(f):
                failures.append(f"{key}: {f} changed "
                                f"{base_plan.get(f)!r} -> "
                                f"{new_plan.get(f)!r}")
        for f in NOTE_PLAN_FIELDS:
            if new_plan.get(f) != base_plan.get(f):
                notes.append(f"{key}: {f} drifted {base_plan.get(f)!r} -> "
                             f"{new_plan.get(f)!r} (informational)")
    extra = set(new["plans"]) - set(baseline["plans"])
    if extra:
        notes.append(f"{len(extra)} plan(s) not in baseline (new "
                     "coverage): " + ", ".join(sorted(extra)[:5])
                     + ("..." if len(extra) > 5 else ""))
    return failures, notes


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "calibrate":
        from repro_torch.plan.calibrate import calibrate_main
        return calibrate_main(argv[1:])
    ap = argparse.ArgumentParser(prog="repro_torch.plan",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--suites", default="smoke,table2",
                    help="comma-separated bench suites to plan "
                         "(default: smoke,table2)")
    ap.add_argument("--mode", choices=("analytic", "measured"),
                    default="analytic")
    ap.add_argument("--out", default=None,
                    help="write the plans document here")
    ap.add_argument("--baseline", default=None,
                    help="plans document to diff against (exact on "
                         "algorithm/solution/partition fields)")
    ap.add_argument("--calibration", default=None,
                    help="calibration JSON the picks consult; default: "
                         "the ambient store ($REPRO_TORCH_CALIBRATION or "
                         "the fingerprinted file beside the plan cache)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the backend plans are made for (default: the "
                         "CUDA card)")
    args = ap.parse_args(argv)
    suites = [s for s in args.suites.split(",") if s]
    calibration = "ambient"
    if args.calibration:
        from repro_torch.plan.calibrate import _load_file
        calibration = _load_file(pathlib.Path(args.calibration), args.device,
                                 strict_fingerprint=False)
        if calibration is None:
            # A named calibration that cannot apply here must be loud.
            print(f"[plan] --calibration {args.calibration} is missing, "
                  "unreadable, or fitted for another backend or card",
                  file=sys.stderr)
            return 2
    doc = build_plans(suites, mode=args.mode, calibration=calibration,
                      calibration_path=args.calibration, backend=args.device)
    if args.out:
        pathlib.Path(args.out).write_text(
            json.dumps(doc, indent=2, sort_keys=True) + "\n")
        print(f"[plan] {len(doc['plans'])} plans ({args.mode}) -> "
              f"{args.out}")
    if args.baseline:
        try:
            baseline = json.loads(pathlib.Path(args.baseline).read_text())
        except FileNotFoundError:
            print(f"[plan] no such baseline: {args.baseline}",
                  file=sys.stderr)
            return 2
        except json.JSONDecodeError as e:
            print(f"[plan] {args.baseline} is not valid JSON: {e}",
                  file=sys.stderr)
            return 2
        failures, notes = compare_plans(doc, baseline)
        for n in notes:
            print(f"[plan] note: {n}")
        if failures:
            for f in failures:
                print(f"[plan] FAIL: {f}", file=sys.stderr)
            print(f"[plan] {len(failures)} plan regression(s) vs "
                  f"{args.baseline}", file=sys.stderr)
            return 1
        print(f"[plan] OK: plans match {args.baseline} "
              f"({len(baseline['plans'])} cells)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
