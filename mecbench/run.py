"""Run one cell of the benchmark of ``repro_torch`` on the card.

    python mecbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the repository's root.  ``BENCHMARK.json`` names the cell: its
configuration (``configs/<config>.json``, whose ``driver`` names
``drivers/<driver>.py``), its traffic (``traffic/<traffic>.json``) and
the metrics it reports.  The driver makes the weights and inputs on the
device from the seed, warms up (set-up), measures for ``--seconds``, then
compares what the timed path produced with the configuration's plain
reference (``reference/<config>.py``).  With ``--trace 1`` the run
reports the cell's per-layer metrics instead of its end-to-end ones,
each read from the run's record by ``metrics/<name>.py``.

The last line of standard output is one JSON object; the numbers
compared, each beside its limit, are the last lines of standard error.
The run exits 2, and prints no result, without a CUDA card (or with fewer
than the cell asks for), and 3 if a forbidden module (``jax``,
``jaxlib``, ``flax``, ``repro``, by top-level name) is loaded once the
window has closed.  Kernel builds go to the checkout's ``build/``; the
plan cache and calibration of ``conv2d(algorithm="auto")`` to a fresh
directory under ``$TMPDIR``, removed at exit, so every run resolves the
same analytic plan.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from mecbench.common import (Context, Result, forbidden_loaded,  # noqa: E402
                             stderr)

EXIT_NO_CARD = 2
EXIT_FORBIDDEN = 3


def load_module(path: Path, name: str):
    """The module in ``path``, loaded by file (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def load_config(name: str, root: Path = ROOT) -> dict:
    return json.loads((root / "mecbench" / "configs" / f"{name}.json")
                      .read_text())


def load_traffic(name: str, root: Path = ROOT) -> dict:
    return json.loads((root / "mecbench" / "traffic" / f"{name}.json")
                      .read_text())


def load_driver(config: dict, root: Path = ROOT):
    driver = config["driver"]
    return load_module(root / "mecbench" / "drivers" / f"{driver}.py",
                       f"mecbench_driver_{driver}")


def load_reference(config_name: str, root: Path = ROOT):
    return load_module(root / "mecbench" / "reference" / f"{config_name}.py",
                       "mecbench_reference_" + config_name.replace("-", "_"))


def cell_metrics(bench: dict, workload: str, kind: str) -> list:
    """The entries of ``bench[kind]`` that ``workload`` reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def per_layer_values(bench: dict, workload: str, trace: dict,
                     root: Path = ROOT) -> dict:
    """Each per-layer metric of the cell read from ``trace`` by its own
    reader; a reader that finds nothing returns None and the metric is
    left out."""
    out = {}
    for m in cell_metrics(bench, workload, "per_layer"):
        reader = load_module(root / "mecbench" / "metrics" / f"{m['name']}.py",
                             "mecbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(trace)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(bench: dict, workload: str, res: Result, trace: bool,
                device: dict, root: Path = ROOT) -> dict:
    """The run's last line: end-to-end metrics, or with ``trace`` the
    per-layer ones; the comparisons last."""
    correct = (res.attempted > 0 and res.failed == 0
               and all(c.ok for c in res.checks))
    if trace:
        metrics = per_layer_values(bench, workload, res.trace, root)
        device = dict(device, busy_s=res.trace["profile"]["busy_s"],
                      window_s=res.trace["profile"]["window_s"])
    else:
        metrics = {m["name"]: {"value": float(res.metrics[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell_metrics(bench, workload, "end_to_end")}
    line = {"correct": correct, "attempted": res.attempted,
            "failed": res.failed, "metrics": metrics, "device": device}
    if trace:
        line["breakdown"] = res.trace["profile"]["breakdown"]
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in res.checks}
    return line


def set_environment(tmp: Path) -> None:
    """Fresh plan cache and calibration under ``tmp``; kernel caches in
    the checkout's ``build/`` at fixed paths."""
    os.environ["REPRO_TORCH_PLAN_CACHE_DIR"] = str(tmp / "plans")
    os.environ["REPRO_TORCH_CALIBRATION"] = str(tmp / "calibration.json")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def make_context(args, bench: dict, root: Path = ROOT,
                 device: str = "cuda") -> Context:
    cell = find_cell(bench, args.workload)
    config = load_config(cell["config"], root)
    return Context(workload=args.workload, config_name=cell["config"],
                   config=config, traffic=load_traffic(cell["traffic"], root),
                   seed=args.seed, seconds=float(args.seconds),
                   trace=bool(args.trace), device=device, t_start=T_PROCESS,
                   reference=load_reference(cell["config"], root))


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it ("" if it
    cannot)."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.strip().splitlines()[0] if out.strip() else ""


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    bench = load_bench()
    cell = find_cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available():
        stderr("mecbench: no CUDA card; the benchmark never runs on the CPU")
        return EXIT_NO_CARD
    if torch.cuda.device_count() < cell["chips"]:
        stderr(f"mecbench: {args.workload} needs {cell['chips']} cards, "
               f"{torch.cuda.device_count()} found")
        return EXIT_NO_CARD
    base = Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
    tmp = Path(tempfile.mkdtemp(prefix="mecbench-", dir=base))
    try:
        set_environment(tmp)
        ctx = make_context(args, bench)
        res = load_driver(ctx.config).run(ctx)
        bad = forbidden_loaded(list(sys.modules))
        if bad:
            stderr(f"mecbench: forbidden modules loaded: {bad}")
            return EXIT_FORBIDDEN
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": cell["chips"],
                  "memory_peak_bytes": int(res.memory_peak_bytes),
                  "power_limit": power_limit()}
        line = result_line(bench, args.workload, res, ctx.trace, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for c in res.checks:
        stderr(f"check {c.name}: {c.value!r} limit {c.limit!r} "
               f"{'ok' if c.ok else 'FAILED'}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
