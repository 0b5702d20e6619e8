"""Quickstart (counterpart of ``examples/quickstart.py``): the MEC
convolution engine (Cho & Brand, ICML 2017), every algorithm through the
one ``conv2d`` front-end, the paper's memory model, and a plan made,
explained, round-tripped through JSON and replayed.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Runs on the card unless ``--device cpu``, where the kernel paths run
their plain versions.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import conv2d, conv2d_spec
from repro_torch.core.memory import ALL_OVERHEADS
from repro_torch.launch.costmodel import pick_conv2d_algorithm
from repro_torch.plan import ConvPlan, plan_conv2d

ALGORITHMS = [
    ("mec (Solution A)", dict(algorithm="mec", solution="A")),
    ("mec (Solution B)", dict(algorithm="mec", solution="B")),
    ("im2col", dict(algorithm="im2col")),
    ("fft", dict(algorithm="fft")),
    ("winograd F(2x2,3x3)", dict(algorithm="winograd")),
    ("MEC kernel K1 (fused)", dict(algorithm="mec_fused")),
    ("MEC kernel K4 (fused2)", dict(algorithm="mec_fused2")),
    ("MEC kernels K2+K3 (lowered)", dict(algorithm="mec_lowered")),
]


def main(argv=None, emit=print) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("quickstart runs on the CUDA card by default and "
                         "none is available; pass --device cpu")
    torch.backends.cuda.matmul.allow_tf32 = False

    # --- a cv7-like layer: 3x3 kernel, stride 1, SAME padding ------------
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, 56, 56, 8).astype(np.float32)) \
        .to(args.device)
    k = torch.from_numpy(rng.randn(3, 3, 8, 16).astype(np.float32)) \
        .to(args.device)
    ref = conv2d(x, k, padding="SAME", algorithm="direct")
    emit(f"output: {tuple(ref.shape)} on {args.device}")
    errors = {}
    for name, kwargs in ALGORITHMS:
        y = conv2d(x, k, padding="SAME", **kwargs)
        errors[name] = float((y - ref).abs().max())
        emit(f"  {name:28s} max|err| vs direct = {errors[name]:.2e}")

    # --- the paper's memory story (Eqs. 2-4) ------------------------------
    spec = conv2d_spec(x, k, padding="SAME")
    auto = pick_conv2d_algorithm(spec, args.device)
    emit(f"\nauto dispatch on this geometry ({args.device}) -> {auto!r}")
    emit("lowered-matrix overhead (f32 MB):")
    overhead_mb = {alg: f(spec) * 4 / 2 ** 20
                   for alg, f in ALL_OVERHEADS.items()}
    for alg, mb in overhead_mb.items():
        emit(f"  {alg:10s} {mb:8.2f} MB")

    # --- the planner: inspect, serialize, replay --------------------------
    plan = plan_conv2d(spec, backend=args.device)   # analytic policy
    emit("\n" + plan.explain())
    replayed = ConvPlan.from_json(plan.to_json())   # plans are values
    out = conv2d(x, k, padding="SAME", plan=replayed)
    same = bool(torch.equal(out, conv2d(x, k, padding="SAME",
                                        algorithm="auto")))
    emit(f"replayed-plan output matches auto kwargs: {same}")
    return {"errors": errors, "scale": float(ref.abs().max()), "auto": auto,
            "overhead_mb": overhead_mb,
            "plan": plan, "replayed": replayed, "replay_matches_auto": same}


if __name__ == "__main__":
    main()
