"""CLI (counterpart of ``python -m repro.analysis``)::

  PYTHONPATH=src python -m repro_torch.analysis \\
      --suite memaudit|launch|lint|numcheck|shardcheck|all \\
      [--device cuda|cpu] [--plans plans.json] \\
      [--out BENCH_torch_memaudit.json] [--record-calibration] \\
      [--numcheck-out BENCH_torch_numcheck.json] [--dist dist.json] \\
      [--shardcheck-out BENCH_torch_shardcheck.json] \\
      [--lint-baseline PATH] [--update-lint-baseline]

* ``memaudit``: the allocator's bytes of one ``conv2d(plan=)`` call
  against Eqs. 2-4 (``analysis.memaudit``); on the CPU every cell is
  recorded, not gated.
* ``launch``: the static launch check (``analysis.launch_check``, the
  JAX package's ``pallas`` suite) of every plan, then of every kernel
  path on each plan's geometry in f32, bf16 and f16; no card needed.
* ``lint``: the port's AST lint against its baseline
  (``analysis.lint``); ``--update-lint-baseline`` rewrites the baseline
  (to shrink it, or to adopt a deliberate suppression).
* ``numcheck``: every algorithm x {f32, bf16, f16} x {fwd, grad} on the
  probe spec, the static contract and the error probe on ``--device``;
  on the card also the kernel paths on the five Table-3 layers at batch
  16 in f32 and bf16, against an f64 oracle on the card, with the budgets
  scaled to each layer's reductions.  Writes ``BENCH_torch_numcheck.json``.
* ``shardcheck``: the collective contract (``analysis.shardcheck``) of
  every partitioned record of the dist baseline (``--dist``, default
  ``benchmarks/baselines/dist.json``) and every partitioned plan of
  ``--plans`` under a 2-way axis a component, each run forward and
  backward on gloo ranks (spawned, as many as the largest cell needs, at
  most 8; on the card they share it), and the precision flow of the
  rank's body.  Writes ``BENCH_torch_shardcheck.json`` in the JAX
  package's schema; skips are recorded, a ``fail`` exits 1.
* ``all``: the four before ``shardcheck``, which spawns ranks and runs
  alone.

Runs on the CUDA card unless ``--device cpu``.  Exit status is non-zero
on any violation.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

SUITES = ("memaudit", "launch", "lint", "numcheck", "shardcheck", "all")
DEFAULT_NUMCHECK = "BENCH_torch_numcheck.json"
#: the numcheck suite's full-width cells on the card: the Table-3 layers
#: at this batch, in these dtypes, through the kernel paths
NUMCHECK_TABLE3_BATCH = 16
NUMCHECK_TABLE3_DTYPES = ("float32", "bfloat16")


def _run_memaudit(args) -> int:
    from repro_torch.analysis.memaudit import write_audit
    out, failures = write_audit(
        plans_path=args.plans, out_path=args.out,
        calibration_store=True if args.record_calibration else None,
        device=args.device)
    print(f"memaudit: report written to {out}")
    if args.record_calibration:
        print("memaudit: gated ratios recorded to the calibration store "
              "(repro_torch.plan.calibrate)")
    if failures:
        print(f"memaudit: {len(failures)} gate failure(s):")
        for f in failures:
            print(f"  {f}")
        return 1
    print("memaudit: all gated cells within tolerance")
    return 0


def _run_launch(args) -> int:
    """Every plan as built (or as ``--plans`` holds it), then every kernel
    path on each plan's geometry with the executor's own block, in each
    contract dtype: the plans are mostly K1, so the variants are what
    reads K2-K4's mirror."""
    from repro_torch.analysis.launch_check import (KERNEL_ALGORITHMS,
                                                   check_geometry, check_plan)
    from repro_torch.analysis.memaudit import DEFAULT_SUITES, load_plans
    from repro_torch.bench.scenarios import resolve_suite
    from repro_torch.core.numerics import CONTRACT_DTYPES
    from repro_torch.plan import plan_conv2d
    # the card's analytic plans, made without the card
    plans = load_plans(args.plans) if args.plans else {
        f"{suite}/{sc.name}": plan_conv2d(sc.spec, dtype=sc.dtype,
                                          backend="cuda", partition="none")
        for suite in DEFAULT_SUITES for sc in resolve_suite(suite)}
    bad = cells = 0
    for name, plan in plans.items():
        result = check_plan(plan)
        if not result.ok:
            bad += 1
            print(f"launch: {name} (as planned): {result.render()}")
        for alg in KERNEL_ALGORITHMS:
            for dtype in CONTRACT_DTYPES:
                variant = check_geometry(plan.spec, alg, None, dtype)
                cells += 1
                if not variant.ok:
                    bad += 1
                    print(f"launch: {name} as {alg} {dtype}: "
                          f"{variant.render()}")
    if bad:
        print(f"launch: {bad} rejected geometry(ies)")
        return 1
    print(f"launch: {len(plans)} plan(s) + {cells} kernel variant "
          f"geometries accepted")
    return 0


def _run_lint(args) -> int:
    from repro_torch.analysis.lint import (DEFAULT_BASELINE, apply_baseline,
                                           lint_tree, load_baseline,
                                           repo_root, write_baseline)
    root = repo_root()
    findings = lint_tree(root)
    baseline_path = pathlib.Path(args.lint_baseline or root / DEFAULT_BASELINE)
    if args.update_lint_baseline:
        write_baseline(findings, baseline_path)
        print(f"lint: baseline rewritten with {len(findings)} finding(s) "
              f"-> {baseline_path}")
        return 0
    baseline = load_baseline(baseline_path) if baseline_path.exists() else []
    split = apply_baseline(findings, baseline)
    for f in split["new"]:
        print(f"lint: NEW {f.render()}")
    if split["fixed"]:
        print(f"lint: {len(split['fixed'])} baseline entry(ies) no longer "
              f"fire; shrink the baseline with --update-lint-baseline:")
        for key in split["fixed"]:
            print(f"  fixed: {key}")
    if split["new"]:
        print(f"lint: {len(split['new'])} new finding(s) "
              f"({len(split['grandfathered'])} grandfathered)")
        return 1
    print(f"lint: clean ({len(split['grandfathered'])} grandfathered)")
    return 0


def _numcheck_cells(device: str):
    """(scenario, algorithm, spec, dtype, source, probe kwargs) of the
    numcheck sweep on ``device``."""
    from repro_torch.analysis.numcheck import (KERNEL_PATHS,
                                               NUMCHECK_ALGORITHMS,
                                               NUMCHECK_DTYPES, probe_spec)
    spec = probe_spec()
    for alg in NUMCHECK_ALGORITHMS:
        for dtype in NUMCHECK_DTYPES:
            yield (f"numprobe_{dtype}", alg, spec, dtype, "probe-spec",
                   {"oracle": "numpy", "scaled": False})
    if device != "cuda":
        return
    from repro_torch.bench.scenarios import RESNET101_WEIGHTS, layer_spec
    for layer in RESNET101_WEIGHTS:
        lspec = layer_spec(layer, batch=NUMCHECK_TABLE3_BATCH)
        for alg in KERNEL_PATHS:
            for dtype in NUMCHECK_TABLE3_DTYPES:
                yield (f"table3/{layer}_{dtype}", alg, lspec, dtype,
                       "table3-full-width", {"oracle": "torch", "scaled": True})


def run_numcheck(device: str = "cuda"):
    """The numcheck sweep's report document and its count of failed
    cells."""
    import dataclasses
    from repro_torch.analysis.numcheck import check_numerics
    from repro_torch.bench.harness import require_device
    from repro_torch.bench.report import make_report
    require_device(device)
    results = []
    n_fail = n_skip = 0
    for scenario, alg, spec, dtype, source, kw in _numcheck_cells(device):
        chk = check_numerics(spec, alg, dtype, device=device, **kw)
        rec = dict(chk.record)
        rec.update({"scenario": scenario, "algorithm": alg,
                    "spec": dataclasses.asdict(spec), "source": source})
        results.append(rec)
        if rec["verdict"] == "fail":
            n_fail += 1
            print(f"numcheck: FAIL {scenario}/{alg}:")
            for v in rec["violations"]:
                print(f"  {v}")
        elif rec["verdict"] == "skipped":
            n_skip += 1
            print(f"numcheck: skip {scenario}/{alg}: {rec['skipped_reason']}")
    doc = make_report("numcheck", results,
                      harness={"directions": ["fwd", "grad"],
                               "probe_seed": 0, "device": device,
                               "reference": "numpy-f64 (probe spec); "
                                            "torch-f64 on the card "
                                            "(Table 3)"},
                      backend=device)
    return doc, n_fail, n_skip


def _run_numcheck(args) -> int:
    from repro_torch.bench.report import write_report
    doc, n_fail, n_skip = run_numcheck(args.device)
    out = pathlib.Path(args.numcheck_out or DEFAULT_NUMCHECK)
    write_report(doc, out)
    print(f"numcheck: report written to {out}")
    verified = len(doc["results"]) - n_fail - n_skip
    if n_fail:
        print(f"numcheck: {n_fail} cell(s) broke their numeric contract")
        return 1
    print(f"numcheck: {verified} cell(s) verified, {n_skip} skipped, "
          f"0 contract violations")
    return 0


DEFAULT_DIST = "benchmarks/baselines/dist.json"
DEFAULT_SHARDCHECK = "BENCH_torch_shardcheck.json"


def _run_shardcheck(args) -> int:
    from repro_torch.analysis.lint import repo_root
    from repro_torch.analysis.shardcheck import SHARDCHECK_MAX_RANKS, run_suite
    from repro_torch.bench.harness import require_device
    from repro_torch.bench.report import make_report, write_report
    require_device(args.device)
    dist_path = pathlib.Path(args.dist or repo_root() / DEFAULT_DIST)
    results = run_suite(args.device, dist_path, args.plans)
    n_fail = n_skip = 0
    for rec in results:
        where = f"{rec['scenario']}/{rec['algorithm']}"
        if rec["verdict"] == "fail":
            n_fail += 1
            print(f"shardcheck: FAIL {where}:")
            for v in rec["violations"]:
                print(f"  {v}")
        elif rec["verdict"] == "skipped":
            n_skip += 1
            print(f"shardcheck: skip {where}: {rec['skipped_reason']}")
    out = pathlib.Path(args.shardcheck_out or DEFAULT_SHARDCHECK)
    doc = make_report("shardcheck", results,
                      harness={"max_ranks": SHARDCHECK_MAX_RANKS,
                               "dist_baseline": str(dist_path),
                               "directions": ["fwd", "grad"],
                               "device": args.device},
                      backend=args.device)
    write_report(doc, out)
    print(f"shardcheck: report written to {out}")
    if n_fail:
        print(f"shardcheck: {n_fail} cell(s) broke their contract")
        return 1
    print(f"shardcheck: {len(results) - n_skip} cell(s) verified, "
          f"{n_skip} skipped, 0 contract violations")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Analysis suites (memaudit, launch, lint, numcheck, "
                    "shardcheck)")
    parser.add_argument("--suite", choices=SUITES, default="all")
    parser.add_argument("--plans", default=None,
                        help="plans document to audit or check (default: "
                             "the analytic plans of smoke and table2)")
    parser.add_argument("--out", default=None,
                        help="memaudit report path "
                             "(default: BENCH_torch_memaudit.json)")
    parser.add_argument("--record-calibration", action="store_true",
                        help="record gated measured/predicted ratios "
                             "into the fitted-costmodel store")
    parser.add_argument("--numcheck-out", default=None,
                        help=f"numcheck report path (default: "
                             f"{DEFAULT_NUMCHECK})")
    parser.add_argument("--dist", default=None,
                        help=f"dist baseline the shardcheck suite checks "
                             f"(default: {DEFAULT_DIST})")
    parser.add_argument("--shardcheck-out", default=None,
                        help=f"shardcheck report path (default: "
                             f"{DEFAULT_SHARDCHECK})")
    parser.add_argument("--lint-baseline", default=None,
                        help="lint baseline JSON (default: "
                             "src/repro_torch/analysis/lint_baseline.json)")
    parser.add_argument("--update-lint-baseline", action="store_true",
                        help="rewrite the lint baseline from the tree")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where to run (default: the CUDA card)")
    args = parser.parse_args(argv)
    rc = 0
    if args.suite in ("lint", "all"):
        rc |= _run_lint(args)
    if args.suite in ("launch", "all"):
        rc |= _run_launch(args)
    if args.suite in ("memaudit", "all"):
        rc |= _run_memaudit(args)
    if args.suite in ("numcheck", "all"):
        rc |= _run_numcheck(args)
    if args.suite == "shardcheck":
        rc |= _run_shardcheck(args)
    return rc


if __name__ == "__main__":
    sys.exit(main())
