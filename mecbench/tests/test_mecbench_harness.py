"""The harness on the CPU: its files load by name, ``BENCHMARK.json`` keeps
to the benchmark's contract, the drivers' arithmetic and the result line
have their shape at smoke size, a run refuses without a card, and the
import check refuses the JAX package by its top-level name.

    python -m pytest -q mecbench/tests

Cases that need the card are marked ``cuda`` and decide inside the test.
"""
import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mecbench import common, run as bench_run
from mecbench.yardstick import conv, peaks

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

#: smoke size of the configuration
SMOKE_LAYERS = {
    "cv9": dict(i_h=10, i_w=10, i_c=8, k_h=3, k_w=3, k_c=8, stride=1, count=2),
    "cv4": dict(i_h=12, i_w=12, i_c=4, k_h=5, k_w=5, k_c=8, stride=2, count=1),
}
SMOKE_TRAFFIC = {
    "resnet101.infer.bf16.b64": dict(batch=2),
    "resnet101.train.f32.b128": dict(batch=2),
}


def smoke_context(workload: str, seed: int = 2 ** 33 + 7,
                  seconds: float = 0.3, trace: bool = False):
    """The cell's context at smoke size on the CPU (the look for a card
    skipped)."""
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds,
                              trace=int(trace))
    ctx = bench_run.make_context(args, BENCH, device="cpu")
    ctx.config = dict(ctx.config, layers=SMOKE_LAYERS)
    ctx.traffic = dict(ctx.traffic, **SMOKE_TRAFFIC[workload])
    return ctx


def run_smoke(ctx):
    return bench_run.load_driver(ctx.config).run(ctx)


# --------------------------------------------------------------- the files

@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_loads_by_name(cfg):
    data = bench_run.load_config(cfg["name"])
    assert (ROOT / cfg["file"]).resolve() == (
        ROOT / "mecbench/configs" / f"{cfg['name']}.json").resolve()
    assert data["name"] == cfg["name"] and data["driver"] == "conv_stack"
    assert data["reduced"] == cfg["reduced"]
    assert bench_run.load_reference(cfg["name"]).scaled_error
    assert bench_run.load_driver(data).run


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_traffic_loads_by_name(cell):
    traffic = bench_run.load_traffic(cell["traffic"])
    assert traffic["why"] and traffic["batch"] > 0
    assert set(traffic["limits"]) and all(v > 0 for v in
                                          traffic["limits"].values())


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_loads_and_finds_nothing_in_an_empty_trace(metric):
    reader = bench_run.load_module(
        ROOT / "mecbench/metrics" / f"{metric['name']}.py", "m")
    assert reader.read({}) is None


# ------------------------------------------------------------ the contract

def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["mecbench"]
    assert BENCH["command"][1] == "mecbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert [w["name"] for w in BENCH["workloads"]][:1] == [
        "resnet101.infer.bf16.b64"]
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_benchmark_json_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"images_per_s", "peak_mem_gib", "setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    assert e2e["setup_s"]["bound"] <= 0.25
    layers = set()
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        layers.add(m["layer"])
        for w in m["workloads"]:
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or w in moved["workloads"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in cells:
        reported = [m for m in BENCH["end_to_end"]
                    if "workloads" not in m or w in m["workloads"]]
        assert len(reported) >= 2
        assert any(w in m["workloads"] for m in BENCH["per_layer"])
    assert layers <= {"conv front end", "kernels", "device", "whole step"}


def test_benchmark_json_cells():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {w["config"] for w in BENCH["workloads"]} == configs


# ---------------------------------------------------------- the import check

def test_import_check_compares_whole_top_level_names():
    mods = ["repro_torch", "repro_torch.kernels.ops", "repro", "repro.core",
            "jax", "jaxlib.xla_client", "flax", "reproduce", "jaxtyping",
            "mecbench.run"]
    assert common.forbidden_loaded(mods) == ["flax", "jax",
                                             "jaxlib.xla_client", "repro",
                                             "repro.core"]


def test_the_harness_imports_no_forbidden_module():
    """The drivers, references and readers load in a fresh process
    without jax, jaxlib, flax or the JAX package."""
    code = (
        "import sys; sys.path[:0] = ['.', 'src']\n"
        "from mecbench import run as r\n"
        "b = r.load_bench()\n"
        "for c in b['configs']:\n"
        "    d = r.load_config(c['name']); r.load_driver(d); "
        "r.load_reference(c['name'])\n"
        "for m in b['per_layer']:\n"
        "    r.load_module(r.HERE / 'metrics' / (m['name'] + '.py'), 'x')\n"
        "import repro_torch.core.conv_api, repro_torch.kernels.build\n"
        "from mecbench.common import forbidden_loaded\n"
        "print(forbidden_loaded(list(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# ------------------------------------------------------------------ a run

def test_run_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal path is not reachable")
    out = subprocess.run(
        [sys.executable, "mecbench/run.py", "--workload",
         "resnet101.infer.bf16.b64", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "TMPDIR": str(tmp_path),
                          "HOME": str(tmp_path)})
    assert out.returncode == bench_run.EXIT_NO_CARD
    assert out.stdout == ""
    assert "no CUDA card" in out.stderr


def test_run_fails_with_only_the_benchmark_files(tmp_path):
    """A checkout holding only BENCHMARK.json and mecbench/ exits non-zero
    and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "mecbench", tmp_path / "mecbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "mecbench/run.py", "--workload",
         "resnet101.infer.bf16.b64", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "TMPDIR": str(tmp_path),
             "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout == ""


@pytest.mark.parametrize("workload", sorted(SMOKE_TRAFFIC))
def test_driver_at_smoke_size_and_the_result_line(workload):
    """A run at smoke size on the CPU: its end-to-end metrics, the line
    the driver reads and its checks; with a trace, the readers of the
    cell's per-layer metrics that need no device trace."""
    ctx = smoke_context(workload, trace=True)
    res = run_smoke(ctx)
    assert res.attempted > 0 and res.failed == 0
    assert all(c.ok for c in res.checks), res.checks
    device = {"platform": "gpu", "kind": "test", "count": 1,
              "memory_peak_bytes": 0}
    line = bench_run.result_line(BENCH, workload, res, False, device)
    assert list(line)[-1] == "checks" and line["correct"] is True
    e2e = {m["name"] for m in bench_run.cell_metrics(BENCH, workload,
                                                     "end_to_end")}
    assert set(line["metrics"]) == e2e
    assert all(v["value"] > 0 for k, v in line["metrics"].items()
               if k != "peak_mem_gib")
    json.dumps(line)
    res.trace["profile"] = {"kernels": {}, "busy_s": 0.5, "window_s": 1.0,
                            "breakdown": {"device_ops": [], "idle_gaps": []}}
    line = bench_run.result_line(BENCH, workload, res, True, device)
    assert line["device"]["busy_s"] == 0.5
    names = {m["name"] for m in bench_run.cell_metrics(BENCH, workload,
                                                       "per_layer")}
    assert set(line["metrics"]) <= names
    t = res.trace
    per_unit = t["window_s"] / t["steps"] * t["profiled_steps"]
    for k in line["metrics"]:
        value = line["metrics"][k]["value"]
        if k.startswith("device_idle_pct"):
            assert value == pytest.approx(100.0 * (1 - 0.5 / per_unit))
        if k.endswith("_mfu"):
            assert 0 < value < 100


def test_kernel_time_matches_whole_identifiers():
    trace = {"profile": {"kernels": {
        "void (anonymous namespace)::fused_kernel<float, 1>(P)": {
            "device_s": 1.0, "count": 2},
        "void (anonymous namespace)::fused2_kernel<float, 1>(P)": {
            "device_s": 3.0, "count": 1}}}}
    assert common.kernel_time(trace, "fused_kernel") == (1.0, 2)
    assert common.kernel_time(trace, "fused2_kernel") == (3.0, 1)


@pytest.mark.parametrize("name,train,kernel", [
    ("k1_roofline", False, "fused_kernel"),
    ("k4_roofline", True, "fused2_kernel")])
def test_roofline_readers(name, train, kernel):
    """A kernel's share: the stack's forward bound a step, times the
    profiled steps, over the kernel's profiled seconds; nothing where the
    kernel did not run or the cell is the other loop."""
    reader = bench_run.load_module(ROOT / "mecbench/metrics" / f"{name}.py",
                                   "m")
    geoms = [(64, 56, 56, 64, 3, 3, 64, 1, 1)] * 3
    dtype = "float32" if train else "bfloat16"
    trace = {"geoms": geoms, "dtype": dtype, "train": train,
             "profiled_steps": 4, "profile": {"kernels": {
                 f"void {kernel}<1>(P)": {"device_s": 0.25, "count": 12}}}}
    bound = 3 * max(conv.flops(geoms[0]) / peaks.PEAK_FLOPS[dtype],
                    conv.forward_bytes(geoms[0], dtype)
                    / peaks.HBM_BYTES_PER_S)
    assert reader.read(trace) == pytest.approx(100.0 * bound * 4 / 0.25)
    assert reader.read(dict(trace, train=not train)) is None
    trace["profile"]["kernels"] = {"void other<1>(P)": {"device_s": 0.25,
                                                        "count": 12}}
    assert reader.read(trace) is None


def test_profile_reads_a_cpu_trace():
    """``profile`` on the CPU: no device events, the window timed."""
    out = common.profile(lambda: torch.ones(8).sum(), lambda: None)
    assert out["busy_s"] == 0.0 and out["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_a_short_run_on_the_card(workload, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "mecbench/run.py", "--workload", workload, "--seed",
         str(2 ** 31 + 11), "--seconds", "2", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
