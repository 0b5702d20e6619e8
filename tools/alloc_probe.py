#!/usr/bin/env python3
"""Where one conv2d call's device memory goes: the allocations live at
the peak of the call, each with its size and where it was made.

    python3 tools/alloc_probe.py [--cells table2/cv11:im2col,...] [--cpp]

Runs on a CUDA card.  Each cell is a scenario of the memory auditor's
default plans (``repro_torch.analysis.memaudit``: the smoke and Table-2
suites) and an algorithm; without ``--cells``, every plan under every
algorithm that is not a kernel path.  Per cell, after the auditor's own
protocol (a warm-up call, then an emptied cache), the measured call runs
under ``torch.cuda.memory._record_memory_history``; the trace is replayed
to find the peak, and the blocks live at that moment (the output
included) are printed as one JSON line: size and the innermost frames of
the port or of torch (``--cpp`` adds C++ frames, which take longer to
symbolise).  The same cell's ``measured_temp_bytes`` from the auditor
stands beside them.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


_ALLOCATOR_FRAMES = ("unwind", "CapturedTraceback", "gather", "Allocator",
                     "c10::", "at::detail::empty", "at::empty")


def _frames(ev, cpp: bool, keep: int = 3):
    """The innermost Python frames of the port or of torch, and with
    ``cpp`` the innermost C++ frames below the allocator's own."""
    py, native = [], []
    for f in ev.get("frames", []):
        name = f.get("filename", "")
        if name.endswith(".py"):
            if ("repro_torch" in name or "/torch/" in name) and len(py) < keep:
                py.append(f"{Path(name).name}:{f.get('line')} {f.get('name')}")
        elif cpp and f.get("name") and len(native) < keep and not any(
                t in f["name"] for t in _ALLOCATOR_FRAMES):
            native.append(f["name"][:100])
    return py + native


def live_at_peak(trace):
    """Replay alloc/free events: the peak of the allocated bytes and the
    allocation events live at that moment."""
    live, cur, peak, at_peak = {}, 0, 0, {}
    for ev in trace:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
            cur += ev["size"]
            if cur > peak:
                peak, at_peak = cur, dict(live)
        elif ev["action"] == "free_requested" and ev["addr"] in live:
            cur -= live.pop(ev["addr"])["size"]
    return peak, list(at_peak.values())


def probe(plan, cpp: bool):
    from repro_torch.bench.harness import make_arrays
    from repro_torch.core.conv_api import conv2d
    s = plan.spec
    inp, ker = make_arrays(s, plan.dtype, device="cuda")

    def call():
        with torch.no_grad():
            return conv2d(inp, ker, stride=(s.s_h, s.s_w), plan=plan)

    call()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.memory._record_memory_history(
        enabled="all", context="alloc", stacks="all" if cpp else "python")
    try:
        out = call()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    trace = snap["device_traces"][torch.cuda.current_device()]
    peak, blocks = live_at_peak(trace)
    out_bytes = out.numel() * out.element_size()
    blocks.sort(key=lambda ev: -ev["size"])
    return {"peak_bytes": peak, "output_bytes": out_bytes,
            "temp_bytes": peak - out_bytes,
            "live": [{"bytes": ev["size"], "at": _frames(ev, cpp)}
                     for ev in blocks]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", default=None,
                    help="comma-separated scenario:algorithm pairs")
    ap.add_argument("--cpp", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("alloc_probe: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.analysis import memaudit
    from repro_torch.plan.__main__ import build_plans
    from repro_torch.plan.convplan import eligible_candidates
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    plans = memaudit.plans_of(build_plans(memaudit.DEFAULT_SUITES,
                                          backend="cuda"))
    if args.cells:
        cells = [tuple(c.split(":")) for c in args.cells.split(",")]
    else:
        cells = [(name, alg) for name, plan in plans.items()
                 for alg in eligible_candidates(plan.spec)
                 if alg not in memaudit.KERNEL_ALGORITHMS]
    for name, alg in cells:
        plan = memaudit._companion_plan(plans[name], alg)
        rec, _ = memaudit.audit_plan(name, plan)
        row = {"cell": f"{name}/{alg}",
               "predicted_bytes": rec["predicted_overhead_bytes"],
               "measured_temp_bytes": rec["measured_temp_bytes"],
               "library_workspace_bytes": rec["library_workspace_bytes"],
               "verdict": rec["verdict"], **probe(plan, args.cpp)}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
