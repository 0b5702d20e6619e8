"""Benchmark driver: one section per paper table or figure, plus the
device-memory traffic model (counterpart of ``benchmarks/run.py``).
Default output is the ``table,name,us_per_call,derived`` CSV; ``--format
json`` passes through to ``repro_torch.bench``'s reports.  A section that
raises does not stop the others; the driver then exits non-zero naming
every failed section.

  PYTHONPATH=src python -m repro_torch.benchmarks.run            # on the card
  PYTHONPATH=src python -m repro_torch.benchmarks.run --only fig4b_memory --device cpu

``roofline`` costs the LM architectures' cells on the (16, 16) mesh at
the card's data-sheet constants (analytic, no device).
"""
from __future__ import annotations

import sys
import traceback

from repro_torch.benchmarks import (_cli, conv_memory, conv_runtime,
                                    hbm_traffic, ks_sweep, resnet101,
                                    roofline)

SECTIONS = {
    "fig4b_memory": conv_memory.main,        # Fig 4(b,e): memory overhead
    "fig4cd_runtime": conv_runtime.main,     # Fig 4(c,d): runtime
    "fig4a_ks_sweep": ks_sweep.main,         # Fig 4(a): k/s sweep
    "table3_resnet101": resnet101.main,      # Table 3: ResNet-101 weighted
    "hbm_traffic": hbm_traffic.main,         # the kernels' traffic model
    "roofline": roofline.main,               # LM cells: three roofline terms
}
# sections that run nothing on a device take no --device
_ANALYTIC = ("hbm_traffic", "roofline")


def main(argv=None, emit=print) -> dict:
    args = _cli.parse(__doc__, argv,
                      only={"default": None, "choices": sorted(SECTIONS)})
    failures, results = [], {}
    for name, fn in SECTIONS.items():
        if args.only and name != args.only:
            continue
        emit(f"# === {name} ===")
        kw = {} if name in _ANALYTIC else {"device": args.device}
        try:
            results[name] = fn(emit=emit, fmt=args.format, **kw)
        except Exception:
            traceback.print_exc()
            failures.append(name)
            print(f"# === {name}: FAILED ===", file=sys.stderr)
    if failures:
        raise SystemExit(f"{len(failures)} benchmark section(s) failed: "
                         + ", ".join(failures))
    return results


if __name__ == "__main__":
    main()
