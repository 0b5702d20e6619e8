"""Read a cell's numbers compared, for the program and for the control, on
several seeds in one process: the readings its limits are set from.

    python mecbench/control.py --workload NAME --seeds 1,2,3 --seconds 5 \\
        [--out FILE]

Each seed runs the cell as ``run.py`` does (set-up, a short window at the
cell's own load, the comparison), and then the control: the reference
computed in the precision just below the traffic's, put in the program's
place, judged by the same comparison.  Prints one JSON line a seed
(``program`` and ``control``: each number compared) and appends them to
``--out``.  The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

from mecbench import run as bench_run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return bench_run.EXIT_NO_CARD
    bench = bench_run.load_bench()
    base = Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
    tmp = Path(tempfile.mkdtemp(prefix="mecbench-control-", dir=base))
    try:
        bench_run.set_environment(tmp)
        for seed in [int(s) for s in args.seeds.split(",")]:
            ns = argparse.Namespace(workload=args.workload, seed=seed,
                                    seconds=args.seconds, trace=0)
            ctx = bench_run.make_context(ns, bench)
            ctx.t_start = time.perf_counter()
            ctx.control = True
            res = bench_run.load_driver(ctx.config).run(ctx)
            row = {"workload": args.workload, "seed": seed,
                   "program": {c.name: c.value for c in res.checks},
                   "control": {c.name: c.value for c in res.control},
                   "limits": {c.name: c.limit for c in res.checks},
                   "attempted": res.attempted,
                   "memory_peak_bytes": res.memory_peak_bytes}
            print(json.dumps(row), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(row) + "\n")
            del res, ctx
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
