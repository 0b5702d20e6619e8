"""Table 3: ResNet-101's weighted memory and runtime of MEC against
im2col.

Memory is analytic (f32, batch 1, the paper's Mobile setting); runtime
is each layer's measured time weighted by the paper's occurrence counts.
The paper: 3.2x memory, 1.2x runtime.  Thin over the
``repro_torch.bench`` ``resnet101`` suite (counterpart of
``benchmarks/resnet101.py``), at the paper's sizes.  Beside the JAX
package's ratio (the plain MEC, Solutions A and B), the last line gives
the ratio against the fastest MEC path, kernels K1-K4 included
(``runtime_ratio_any_mec``).  ``--format json`` emits the suite's report.

    PYTHONPATH=src python -m repro_torch.benchmarks.resnet101 [--device cpu]
"""
from __future__ import annotations

import json

from repro_torch.bench.harness import run_suite
from repro_torch.benchmarks import _cli

#: every MEC path of the suite: the plain Solutions and the kernel paths
MEC_PATHS = ("mecA", "mecB", "mec_lowered", "mec_fused", "mec_fused2")


def summarize(doc) -> dict:
    """Table 3 from a ``resnet101`` suite report: per layer, and the
    weighted sums with ``mem_ratio`` and ``runtime_ratio`` (plain MEC)
    and ``runtime_ratio_any_mec`` (the fastest MEC path a layer)."""
    by_scenario = {}
    for r in doc["results"]:
        by_scenario.setdefault(r["scenario"], {})[r["algorithm"]] = r
    layers = {}
    mem_i2c = mem_mec = t_i2c = t_mec = t_any = 0.0
    for name, algs in by_scenario.items():
        w = algs["im2col"]["weight"]
        best_mec = min(algs["mecA"]["us_per_call"],
                       algs["mecB"]["us_per_call"])
        best_any = min(algs[a]["us_per_call"] for a in MEC_PATHS
                       if a in algs)
        layers[name] = {
            "weight": w, "mem_im2col_mb": algs["im2col"]["overhead_bytes"]
            / 2 ** 20, "mem_mec_mb": algs["mecA"]["overhead_bytes"] / 2 ** 20,
            "t_im2col_us": algs["im2col"]["us_per_call"],
            "t_mec_us": best_mec, "t_any_mec_us": best_any}
        mem_i2c += w * layers[name]["mem_im2col_mb"]
        mem_mec += w * layers[name]["mem_mec_mb"]
        t_i2c += w * algs["im2col"]["us_per_call"]
        t_mec += w * best_mec
        t_any += w * best_any
    return {"layers": layers, "t_im2col_us": t_i2c, "t_mec_us": t_mec,
            "t_any_mec_us": t_any, "mem_ratio": mem_i2c / mem_mec,
            "runtime_ratio": t_i2c / t_mec,
            "runtime_ratio_any_mec": t_i2c / t_any}


def main(emit=print, fmt: str = "csv", iters: int = 3, device: str = "cuda"):
    doc = run_suite("resnet101", iters=iters, device=device)
    if fmt == "json":
        emit(json.dumps(doc, indent=2))
        return doc
    t3 = summarize(doc)
    emit("table,name,us_per_call,derived")
    for name, row in t3["layers"].items():
        emit(f"table3_resnet101,{name},{row['t_mec_us']:.0f},"
             f"weight={row['weight']};mem_im2col={row['mem_im2col_mb']:.1f}MB;"
             f"mem_mec={row['mem_mec_mb']:.1f}MB;"
             f"t_im2col={row['t_im2col_us']:.0f}us;"
             f"t_any_mec={row['t_any_mec_us']:.0f}us")
    emit(f"table3_resnet101,SUM,{t3['t_mec_us']:.0f},"
         f"mem_ratio={t3['mem_ratio']:.2f}x (paper 3.2x);"
         f"runtime_ratio={t3['runtime_ratio']:.2f}x (paper 1.2x);"
         f"runtime_ratio_any_mec={t3['runtime_ratio_any_mec']:.2f}x")
    return t3


if __name__ == "__main__":
    a = _cli.parse(__doc__, iters={"type": int, "default": 3})
    main(fmt=a.format, iters=a.iters, device=a.device)
