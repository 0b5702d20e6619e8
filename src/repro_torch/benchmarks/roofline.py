"""Roofline table: three terms per (arch x shape) cell on a mesh of H100s
(counterpart of ``benchmarks/roofline.py``).

The terms come from the analytic cost model (``launch.costmodel``
``cell_cost``) at the card's data-sheet constants
(``launch.hlo_analysis``): compute over the bf16 tensor-core peak, device
memory over its bandwidth, collectives over NVLink.  ``roofline_frac`` is
the useful model compute's time over the dominant term, the share of the
step's roofline.  With ``--results DIR`` each row also carries the dry
run's per-device counts of the same cell (``launch.dryrun`` records,
``{arch}__{shape}__pod.json``) as ``raw_*`` fields; without it nothing
is read, whatever lies on disk.  Nothing here is measured.

  PYTHONPATH=src python -m repro_torch.benchmarks.roofline [--format json]
      [--results results/dryrun_torch]
"""
from __future__ import annotations

import argparse
import json
import pathlib
from typing import Optional

from repro_torch.configs.archs import ARCHS
from repro_torch.configs.shapes import SHAPES, cell_applicable
from repro_torch.launch.costmodel import MeshShape, cell_cost
from repro_torch.launch.hlo_analysis import HBM_BW, ICI_BW, PEAK_FLOPS


def _raw(results: pathlib.Path, arch: str, shape: str) -> dict:
    f = pathlib.Path(results) / f"{arch}__{shape}__pod.json"
    if not f.exists():
        return {}
    r = json.loads(f.read_text())
    coll = r["per_device"]["collectives"]
    return {"raw_flops_dev": r["per_device"]["flops"],
            "raw_coll_dev": coll["total"],
            "raw_coll_mix": {k: v for k, v in coll.items()
                             if isinstance(v, int) and v
                             and k not in ("total", "count")},
            "peak_bytes_dev": r["per_device"]["memory"]["peak_bytes"]}


def analyze_cell(arch: str, shape: str, mesh: MeshShape = MeshShape(),
                 results: Optional[pathlib.Path] = None,
                 overrides: Optional[dict] = None) -> dict:
    """The three terms, the dominant one and the roofline share of one
    cell, its config with ``overrides``."""
    cfg = ARCHS[arch].with_(**(overrides or {}))
    cell = SHAPES[shape]
    c = cell_cost(cfg, cell.kind, cell.global_batch, cell.seq_len, mesh)
    t_c = c["flops"] / (mesh.chips * PEAK_FLOPS)
    t_m = c["hbm_bytes_chip"] / HBM_BW
    t_x = c["coll_bytes_chip"] / ICI_BW
    dom = max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))[1]
    t_model = c["model_flops"] / (mesh.chips * PEAK_FLOPS)
    raw = {} if results is None else _raw(results, arch, shape)
    return {"arch": arch, "shape": shape, "kind": cell.kind,
            "t_compute_s": t_c, "t_memory_s": t_m, "t_collective_s": t_x,
            "dominant": dom, "roofline_frac": t_model / max(t_c, t_m, t_x),
            "useful_flop_ratio": c["model_flops"] / max(c["flops"], 1.0),
            **raw}


def all_rows(mesh: MeshShape = MeshShape(),
             results: Optional[pathlib.Path] = None) -> list:
    return [analyze_cell(arch, shape, mesh, results)
            for arch in ARCHS for shape in SHAPES
            if cell_applicable(arch, shape)]


def main(emit=print, fmt: str = "csv",
         results: Optional[pathlib.Path] = None) -> list:
    rows = all_rows(results=results)
    if fmt == "json":
        emit(json.dumps(rows, indent=2))
        return rows
    emit("table,name,us_per_call,derived")
    for r in rows:
        emit(f"roofline,{r['arch']}__{r['shape']},"
             f"{max(r['t_compute_s'], r['t_memory_s'], r['t_collective_s'])*1e6:.0f},"
             f"tc={r['t_compute_s']*1e6:.0f}us;tm={r['t_memory_s']*1e6:.0f}us;"
             f"tx={r['t_collective_s']*1e6:.0f}us;dominant={r['dominant']};"
             f"useful={r['useful_flop_ratio']:.2f};"
             f"frac={r['roofline_frac']:.3f}")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--format", choices=("csv", "json"), default="csv")
    ap.add_argument("--results", default=None,
                    help="dry-run records to attach as raw_* fields")
    args = ap.parse_args()
    main(fmt=args.format,
         results=None if args.results is None
         else pathlib.Path(args.results))
