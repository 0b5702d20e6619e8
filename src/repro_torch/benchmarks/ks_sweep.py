"""Fig. 4(a): cv1 with its 11x11 kernel, stride swept 1..10: both the
memory-overhead ratio (analytic) and the runtime ratio (measured) of MEC
against im2col grow with k/s (Eq. 4).

Thin over the ``repro_torch.bench`` ``ks_sweep`` suite (counterpart of
``benchmarks/ks_sweep.py``); ``--format json`` emits its report.

    PYTHONPATH=src python -m repro_torch.benchmarks.ks_sweep [--device cpu]
"""
from __future__ import annotations

import json

from repro_torch.bench.harness import run_suite
from repro_torch.benchmarks import _cli


def main(emit=print, fmt: str = "csv", iters: int = 3, device: str = "cuda"):
    doc = run_suite("ks_sweep", iters=iters, device=device)
    if fmt == "json":
        emit(json.dumps(doc, indent=2))
        return doc
    by_scenario = {}
    for r in doc["results"]:
        by_scenario.setdefault(r["scenario"], {})[r["algorithm"]] = r
    emit("table,name,us_per_call,derived")
    mem_ratio = None
    for algs in by_scenario.values():
        mec, i2c = algs["mecA"], algs["im2col"]
        s_ = mec["spec"]["s_h"]
        mem_ratio = i2c["overhead_elems"] / mec["overhead_elems"]
        emit(f"fig4a_ks_sweep,s={s_},{mec['us_per_call']:.0f},"
             f"mem_ratio={mem_ratio:.2f}x;"
             f"runtime_ratio={i2c['us_per_call'] / mec['us_per_call']:.2f}x;"
             f"k_over_s={mec['spec']['k_h'] / s_:.1f}")
    return mem_ratio


if __name__ == "__main__":
    a = _cli.parse(__doc__, iters={"type": int, "default": 3})
    main(fmt=a.format, iters=a.iters, device=a.device)
