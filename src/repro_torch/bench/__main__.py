"""CLI (counterpart of ``python -m repro.bench``)::

  PYTHONPATH=src python -m repro_torch.bench --suite smoke \\
      [--out BENCH_torch_smoke.json] [--format csv] [--crosscheck] \\
      [--iters N] [--warmup N] [--no-timing] [--device cuda|cpu]

Runs on the CUDA card unless ``--device cpu``.  The default output is
``BENCH_torch_<suite>.json`` in the working directory, never a JAX
package ``BENCH_*.json``.  ``--suite autotune`` runs the analytic-vs-
measured pick comparison (``harness.run_autotune``) over the scenarios of
``--base-suite`` and writes its own document; ``--suite serve`` raises
(the conv service is ROADMAP Queue 1 item 10).  The JAX package's
``--interpret`` and ``--no-hlo`` have no meaning here.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.bench.harness import (DEVICES, run_autotune, run_serve,
                                       run_suite)
from repro_torch.bench.report import render_csv, write_report
from repro_torch.bench.scenarios import SUITES


def default_out(suite: str) -> str:
    return f"BENCH_torch_{suite}.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--suite", required=True,
                    choices=sorted(SUITES) + ["autotune", "serve"])
    ap.add_argument("--base-suite", default="smoke", choices=sorted(SUITES),
                    help="scenarios the autotune comparison runs over")
    ap.add_argument("--out", default=None,
                    help="report path (default: BENCH_torch_<suite>.json "
                         "in the working directory for json format)")
    ap.add_argument("--format", choices=("json", "csv"), default="json",
                    help="csv prints the table,name,us,derived lines")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--no-timing", action="store_true",
                    help="analytic fields only (fast, deterministic)")
    ap.add_argument("--crosscheck", action="store_true",
                    help="cross-validate the auto pick against the "
                         "measurements (adds a 'crosscheck' section)")
    ap.add_argument("--device", choices=DEVICES, default="cuda",
                    help="where to run (default: the CUDA card)")
    args = ap.parse_args(argv)

    def progress(msg):
        print(msg, file=sys.stderr)

    if args.suite == "autotune":
        doc = run_autotune(args.base_suite, iters=args.iters,
                           warmup=args.warmup, progress=progress,
                           device=args.device)
        out = args.out or default_out("autotune")
        with open(out, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
        wins = sum(1 for r in doc["results"]
                   if r["speedup"] and r["speedup"] >= 1.0)
        print(f"[bench] autotune over {args.base_suite}: "
              f"{len(doc['results'])} cells, measured pick <= analytic on "
              f"{wins} -> {out}")
        return 0
    if args.suite == "serve":
        run_serve(progress=progress, device=args.device)
    doc = run_suite(args.suite, iters=args.iters, warmup=args.warmup,
                    with_timing=not args.no_timing,
                    crosscheck=args.crosscheck, progress=progress,
                    device=args.device)
    if args.format == "csv":
        for line in render_csv(doc):
            print(line)
        if args.out:
            write_report(doc, args.out)
        return 0
    out = args.out or default_out(args.suite)
    write_report(doc, out)
    print(f"[bench] {args.suite}: {len(doc['results'])} cells -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
