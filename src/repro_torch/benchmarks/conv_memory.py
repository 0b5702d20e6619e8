"""Fig. 4(b,e): the memory overhead of each convolution algorithm on
cv1-cv12, analytic (f32 bytes, batch 1, as on Mobile).  The paper's
headline: MEC ~3.2x less overhead than im2col on average.

Thin over ``repro_torch.bench`` (counterpart of
``benchmarks/conv_memory.py``): specs come from the ``table2`` suite;
``--format json`` emits the suite's report without timing (memory needs
none).  ``auto`` is the costmodel's pick on ``--device``.

    PYTHONPATH=src python -m repro_torch.benchmarks.conv_memory [--device cpu]
"""
from __future__ import annotations

import json

import numpy as np

from repro_torch.bench.harness import run_suite
from repro_torch.bench.scenarios import CV_LAYERS, layer_spec
from repro_torch.benchmarks import _cli
from repro_torch.core.memory import ALL_OVERHEADS
from repro_torch.launch.costmodel import pick_conv2d_algorithm


def rows(batch: int = 1, device: str = "cuda"):
    out = []
    for name in CV_LAYERS:
        s = layer_spec(name, batch=batch)
        mb = {alg: fn(s) * 4 / 2 ** 20 for alg, fn in ALL_OVERHEADS.items()}
        mb["ratio_im2col_mec"] = mb["im2col"] / mb["mec"]
        mb["name"] = name
        mb["auto"] = pick_conv2d_algorithm(s, device)
        out.append(mb)
    return out


def main(emit=print, fmt: str = "csv", device: str = "cuda"):
    if fmt == "json":
        doc = run_suite("table2", with_timing=False, device=device)
        emit(json.dumps(doc, indent=2))
        return doc
    rs = rows(device=device)
    emit("table,name,us_per_call,derived")
    ratios = []
    for r in rs:
        ratios.append(r["ratio_im2col_mec"])
        emit(f"fig4b_memory,{r['name']},0,"
             f"im2col={r['im2col']:.2f}MB;mec={r['mec']:.2f}MB;"
             f"fft={r['fft']:.2f}MB;wino={r['winograd']:.2f}MB;"
             f"ratio={r['ratio_im2col_mec']:.2f}x;auto={r['auto']}")
    emit(f"fig4b_memory,geomean,0,"
         f"im2col/mec={float(np.exp(np.mean(np.log(ratios)))):.2f}x"
         f" (paper: ~3.2x avg)")
    return rs


if __name__ == "__main__":
    a = _cli.parse(__doc__)
    main(fmt=a.format, device=a.device)
