"""Operator CLI (counterpart of ``python -m repro.serving``): audit what
a conv service will run before deploying.

  PYTHONPATH=src python -m repro_torch.serving --warmup-report \\
      --kernel 3x3x4x8 --stride 2 --padding 1 \\
      --shape-classes 1x12x12,2x16x16 [--device cpu]

  PYTHONPATH=src python -m repro_torch.serving --warmup-report \\
      --frontend whisper --shape-classes 1x24x1,2x64x1 [--device cpu]

``--warmup-report`` builds the service on ``--device`` (the CUDA card by
default), warms every shape class through the persistent plan cache, and
prints the resolved :class:`~repro_torch.plan.ConvPlan` table per class
(:meth:`ConvPlan.explain`) with the warning and plan-cache I/O counters.
Exit status is 1 when any class failed to warm (the service would still
run, degraded), 0 otherwise.
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.serving.conv_service import (ConvService, parse_shape_classes,
                                              whisper_frontend_service)


def _parse_kernel(text: str):
    dims = text.split("x")
    if len(dims) != 4:
        raise argparse.ArgumentTypeError(
            f"kernel {text!r} is not KHxKWxICxOC")
    return tuple(int(d) for d in dims)


def _parse_padding(text: str):
    if text.upper() == "VALID":
        return "VALID"
    parts = [int(p) for p in text.split(",")]
    if len(parts) == 1:
        return parts[0]
    if len(parts) == 4:
        return ((parts[0], parts[1]), (parts[2], parts[3]))
    raise argparse.ArgumentTypeError(
        f"padding {text!r} is not VALID, P, or HLO,HHI,WLO,WHI")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serving",
        description="Plan-driven conv serving")
    ap.add_argument("--warmup-report", action="store_true", required=True,
                    help="warm the service and print the per-class "
                         "resolved-plan table")
    ap.add_argument("--shape-classes", required=True,
                    help="comma-separated NxHxW padded classes, e.g. "
                         "1x32x32,4x64x64")
    ap.add_argument("--frontend", choices=("whisper",), default=None,
                    help="audit a named conv frontend instead of a bare "
                         "kernel (whisper: the two-layer mel frontend)")
    ap.add_argument("--kernel", type=_parse_kernel, default=(3, 3, 4, 8),
                    help="KHxKWxICxOC kernel geometry (default 3x3x4x8)")
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--padding", type=_parse_padding, default="VALID",
                    help="VALID, a single int, or HLO,HHI,WLO,WHI")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16", "float16"),
                    help="the bare kernel's dtype (the whisper frontend "
                         "is f32)")
    ap.add_argument("--plan-mode", choices=("cached", "analytic"),
                    default="cached")
    ap.add_argument("--n-mels", type=int, default=80,
                    help="whisper frontend: mel bins")
    ap.add_argument("--d-model", type=int, default=64,
                    help="whisper frontend: model width")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the service runs (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("python -m repro_torch.serving runs on the CUDA "
                         "card by default and none is available; pass "
                         "--device cpu")

    classes = parse_shape_classes(args.shape_classes)
    generator = torch.Generator(device=args.device)
    generator.manual_seed(0)
    if args.frontend == "whisper":
        _, services = whisper_frontend_service(
            generator, args.n_mels, args.d_model, classes,
            plan_mode=args.plan_mode, device=args.device)
        labels = ["conv1 (stride 1)", "conv2 (stride 2)"]
    else:
        k_h, k_w, i_c, k_c = args.kernel
        kernel = (torch.randn((k_h, k_w, i_c, k_c), generator=generator,
                              device=args.device)
                  * (k_h * k_w * i_c) ** -0.5).to(getattr(torch, args.dtype))
        svc = ConvService(kernel, stride=args.stride, padding=args.padding,
                          classes=classes, plan_mode=args.plan_mode)
        svc.warm()
        services, labels = [svc], [f"conv {args.kernel}"]

    rc = 0
    for label, svc in zip(labels, services):
        print(f"== {label} ==")
        print(svc.warmup.render())
        if len(svc.warmup.plans) < len(svc.classes):
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
