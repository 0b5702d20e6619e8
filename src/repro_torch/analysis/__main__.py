"""CLI (counterpart of ``python -m repro.analysis``)::

  PYTHONPATH=src python -m repro_torch.analysis --suite memaudit \\
      [--plans plans.json] [--out BENCH_torch_memaudit.json] \\
      [--record-calibration] [--device cuda|cpu]

``memaudit`` is the only suite ported; the JAX package's other suites
raise, naming the ROADMAP Queue 1 item that ports them.  Runs on the
CUDA card unless ``--device cpu`` (where every cell is recorded, not
gated).  Exit status is non-zero on any gate failure.
"""
from __future__ import annotations

import argparse
import sys

# The JAX package's suites that are not ported yet, and their item.
NOT_PORTED = {"pallas": 9, "lint": 9, "numcheck": 9, "shardcheck": 11,
              "all": 9}


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Analysis suites (memaudit)")
    parser.add_argument("--suite", choices=("memaudit", *NOT_PORTED),
                        default="memaudit")
    parser.add_argument("--plans", default=None,
                        help="plans document to audit (default: the "
                             "analytic plans of smoke and table2, built "
                             "for --device)")
    parser.add_argument("--out", default=None,
                        help="memaudit report path "
                             "(default: BENCH_torch_memaudit.json)")
    parser.add_argument("--record-calibration", action="store_true",
                        help="record gated measured/predicted ratios "
                             "into the fitted-costmodel store")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where to run (default: the CUDA card)")
    args = parser.parse_args(argv)
    if args.suite in NOT_PORTED:
        raise NotImplementedError(
            f"--suite {args.suite}: not ported yet: ROADMAP Queue 1 item "
            f"{NOT_PORTED[args.suite]}")
    return _run_memaudit(args)


if __name__ == "__main__":
    sys.exit(main())
