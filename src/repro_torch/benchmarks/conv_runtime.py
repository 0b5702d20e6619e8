"""Fig. 4(c,d): convolution runtime per algorithm on cv1-cv12, at the
paper's sizes, on the card's device timer.

Thin over ``repro_torch.bench`` (counterpart of
``benchmarks/conv_runtime.py``): every cell is timed by
``repro_torch.bench.harness.measure``.  The JAX package capped channels
at 16 on its CPU; here the paper's sizes are the default, and
``--channel-cap N`` caps them (geometry kept) for a quick run on the CPU.
``--format json`` emits the ``table2`` suite's report instead of the CSV
lines.

    PYTHONPATH=src python -m repro_torch.benchmarks.conv_runtime [--device cpu --channel-cap 8]
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

from repro_torch.bench.harness import measure, run_suite
from repro_torch.bench.report import make_report
from repro_torch.bench.scenarios import (CV_LAYERS, Scenario,
                                         eligible_algorithms, layer_spec,
                                         resolve_suite)
from repro_torch.benchmarks import _cli

# The variants Fig 4(c,d) compares (the kernels are the table2 suite's
# other cells and hbm_traffic's model).
_FIG4_ALGS = ("direct", "im2col", "mecA", "mecB", "fft", "winograd")


def _run_spec(name: str, batch: int, channel_cap: Optional[int]):
    spec = layer_spec(name, batch=batch)
    if channel_cap is None:
        return spec
    return dataclasses.replace(spec, i_c=min(spec.i_c, channel_cap),
                               k_c=min(spec.k_c, channel_cap))


def run_layer(name: str, channel_cap: Optional[int] = None, batch: int = 1,
              iters: int = 3, device: str = "cuda"):
    """{algorithm: us_per_call} for one Table 2 layer."""
    spec = layer_spec(name, batch=batch)
    sc = Scenario(name=name, spec=spec,
                  run_spec=_run_spec(name, batch, channel_cap),
                  algorithms=eligible_algorithms(spec, _FIG4_ALGS))
    return {alg: measure(sc, alg, iters=iters, device=device)["us_per_call"]
            for alg in sc.algorithms}


def main(emit=print, fmt: str = "csv", channel_cap: Optional[int] = None,
         iters: int = 3, device: str = "cuda"):
    if fmt == "json":
        if channel_cap is None:
            doc = run_suite("table2", iters=iters, device=device)
        else:
            scenarios = [dataclasses.replace(
                sc, run_spec=_run_spec(sc.name, 1, channel_cap))
                for sc in resolve_suite("table2")]
            recs = [measure(sc, alg, iters=iters, device=device)
                    for sc in scenarios for alg in sc.algorithms]
            doc = make_report("table2", recs,
                              {"iters": iters, "channel_cap": channel_cap,
                               "device": device}, backend=device)
        emit(json.dumps(doc, indent=2))
        return doc
    emit("table,name,us_per_call,derived")
    speedups = []
    for name in CV_LAYERS:
        r = run_layer(name, channel_cap=channel_cap, iters=iters,
                      device=device)
        best_mec = min(r["mecA"], r["mecB"])
        sp = r["im2col"] / best_mec
        speedups.append(sp)
        extra = (f";wino={r['winograd']:.0f}us" if "winograd" in r else "")
        emit(f"fig4cd_runtime,{name},{best_mec:.0f},"
             f"im2col={r['im2col']:.0f}us;direct={r['direct']:.0f}us;"
             f"fft={r['fft']:.0f}us{extra};mec_vs_im2col={sp:.2f}x")
    gm = 1.0
    for s_ in speedups:
        gm *= s_
    gm **= 1.0 / len(speedups)
    emit(f"fig4cd_runtime,geomean,0,mec_vs_im2col={gm:.2f}x "
         f"(paper Mobile: ~1.2x, Server-CPU: up to 8.8x)")
    return speedups


if __name__ == "__main__":
    a = _cli.parse(__doc__, **{
        "channel-cap": {"type": int, "default": None, "dest": "channel_cap"},
        "iters": {"type": int, "default": 3}})
    main(fmt=a.format, channel_cap=a.channel_cap, iters=a.iters,
         device=a.device)
