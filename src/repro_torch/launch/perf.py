"""Perf-iteration harness (counterpart of ``repro.launch.perf``): run one
dry-run cell (``launch.dryrun``, fake process group, full size) with
config overrides and attach the analytic terms of the same overrides at
the card's data-sheet constants (``benchmarks.roofline.analyze_cell``),
for before/after comparisons of a change's collective mix, FLOPs and peak
bytes a device.  Nothing is measured.

  PYTHONPATH=src python -m repro_torch.launch.perf --arch qwen3-4b \\
      --shape decode_32k --set kv_cache_int8=True --tag int8

Writes ``results/perf_torch/{arch}__{shape}__{pod|multipod}__{tag}.json``
(git-ignored).
"""
import argparse
import ast
import json
import pathlib

from repro_torch.benchmarks.roofline import analyze_cell
from repro_torch.launch.costmodel import MeshShape
from repro_torch.launch.dryrun import RESULTS, run_cell

PERF_DIR = RESULTS.parent / "perf_torch"


def parse_override(kv: str):
    k, v = kv.split("=", 1)
    try:
        return k, ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return k, v


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--set", action="append", default=[],
                    help="config override, e.g. seq_parallel=True")
    ap.add_argument("--tag", default="base")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=str(PERF_DIR))
    args = ap.parse_args(argv)
    overrides = dict(parse_override(kv) for kv in args.set)
    out_dir = pathlib.Path(args.out)
    run_cell(args.arch, args.shape, args.multi_pod, out_dir,
             overrides=overrides or None, tag_suffix=f"__{args.tag}")
    row = analyze_cell(args.arch, args.shape,
                       MeshShape(pod=2 if args.multi_pod else 1),
                       overrides=overrides)
    analytic = {k: row[k] for k in ("t_compute_s", "t_memory_s",
                                    "t_collective_s", "roofline_frac")}
    tag = (f"{args.arch}__{args.shape}__"
           f"{'multipod' if args.multi_pod else 'pod'}__{args.tag}")
    path = out_dir / f"{tag}.json"
    data = json.loads(path.read_text())
    data["analytic"] = analytic
    path.write_text(json.dumps(data, indent=2))
    print(f"[perf] {tag}: frac={analytic['roofline_frac']:.3f} "
          f"tc={analytic['t_compute_s']:.3f}s "
          f"tm={analytic['t_memory_s']:.3f}s "
          f"tx={analytic['t_collective_s']:.3f}s")
    return data


if __name__ == "__main__":
    main()
