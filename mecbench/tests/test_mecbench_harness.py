"""The harness on the CPU: its files load by name, ``BENCHMARK.json`` keeps
to the benchmark's contract, the drivers' arithmetic and the result line
have their shape at smoke size (each configuration's and traffic's own
``smoke`` sizes), a configuration with a driver of its own comes in as new
files only, a run refuses without a card, and the import check refuses the
JAX package by its top-level name.

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

#: the end-to-end metrics allowed; each cell reports exactly one of the
#: rates.  The LM rates enter with the first cell that reports them (a
#: metric's ``workloads`` may not be empty), with bounds no wider than
#: those read for them on the card (PERF.md section 2).
RATES = ("images_per_s", "prefill_tokens_per_s", "decode_tokens_per_s")
END_TO_END = set(RATES) | {"peak_mem_gib", "setup_s"}
LM_RATE_BOUNDS = {"prefill_tokens_per_s": 0.01, "decode_tokens_per_s": 0.077}
#: the layers of PERF.md's list
LAYERS = {"conv front end", "conv backward (MEC VJP)", "kernels", "device",
          "whole step", "model blocks", "serving"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def smoke_context(workload: str, seed: int = 2 ** 33 + 7,
                  seconds: float = 0.3, trace: bool = False,
                  bench: dict = BENCH, root: Path = ROOT):
    """The cell's context on the CPU at the sizes its configuration's and
    its traffic's ``smoke`` keys give (the look for a card skipped)."""
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds,
                              trace=int(trace))
    ctx = bench_run.make_context(args, bench, root=root, device="cpu")
    ctx.config = dict(ctx.config, **ctx.config["smoke"])
    ctx.traffic = dict(ctx.traffic, **ctx.traffic["smoke"])
    return ctx


def run_smoke(ctx):
    return bench_run.load_driver(ctx.config).run(ctx)


# --------------------------------------------------------------- the files

@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_loads_by_name(cfg):
    data = bench_run.load_config(cfg["name"])
    assert (ROOT / cfg["file"]).resolve() == (
        ROOT / "mecbench/configs" / f"{cfg['name']}.json").resolve()
    assert data["name"] == cfg["name"]
    assert (ROOT / "mecbench/drivers" / f"{data['driver']}.py").is_file()
    assert data["reduced"] == cfg["reduced"] and data["smoke"]
    assert bench_run.load_reference(cfg["name"])
    assert callable(bench_run.load_driver(data).run)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_traffic_loads_by_name(cell):
    traffic = bench_run.load_traffic(cell["traffic"])
    assert traffic["why"] and traffic["batch"] > 0 and traffic["smoke"]
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


def check_metrics(bench: dict) -> None:
    """The end-to-end and per-layer metrics keep to the contract: the
    end-to-end names among the five, each cell under exactly one rate,
    every ``workloads`` list a non-empty list of cells, bounds, units,
    layers and ``moves``."""
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and set(e2e) <= END_TO_END
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
        if "workloads" in m:
            assert m["workloads"] and set(m["workloads"]) <= cells
    assert e2e["setup_s"]["bound"] <= 0.25
    for name, bound in LM_RATE_BOUNDS.items():
        assert name not in e2e or e2e[name]["bound"] <= bound
    for w in cells:
        assert sum(w in e2e[r]["workloads"] for r in RATES if r in e2e) == 1
    layers = set()
    for m in bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert m["workloads"] and set(m["workloads"]) <= cells
        layers.add(m["layer"])
        for w in m["workloads"]:
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or w in moved["workloads"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in cells:
        reported = [m for m in bench["end_to_end"]
                    if "workloads" not in m or w in m["workloads"]]
        assert len(reported) >= 2
        assert any(w in m["workloads"] for m in bench["per_layer"])
    assert layers <= LAYERS


def check_cells(bench: dict) -> None:
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {w["config"] for w in bench["workloads"]} == configs


def test_benchmark_json_metrics():
    check_metrics(BENCH)


def test_benchmark_json_cells():
    check_cells(BENCH)


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


@pytest.mark.parametrize("workload", CELLS)
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


def test_token_window_counts_tokens_step_by_step():
    """Every step's tokens are counted, a step that counts none (a decode
    batch's prefill) adds only its time, and the window covers them all."""
    def step(i):
        return 0 if i % 4 == 0 else 3

    steps, tokens, window_s = common.token_window(step, 0.05, "cpu")
    assert steps > 4 and window_s >= 0.05
    assert tokens == 3 * (steps - (steps + 3) // 4)


#: a second configuration with a driver of its own, as a later PR adds one:
#: greedy decode over a seeded embedding, judged by its own reference
TOY_DRIVER = """
import time
import torch
from mecbench.common import Check, Result, seed_stream, token_window


def run(ctx):
    c, t = ctx.config, ctx.traffic
    gen = torch.Generator().manual_seed(seed_stream(ctx.seed, 0))
    emb = torch.randn(c["vocab"], c["d_model"], generator=gen)
    state = {"tok": torch.randint(0, c["vocab"], (t["batch"],),
                                  generator=gen)}
    setup_s = time.perf_counter() - ctx.t_start

    def step(i):
        state["prev"] = state["tok"]
        state["tok"] = (emb[state["tok"]] @ emb.T).argmax(-1)
        return t["batch"]

    steps, tokens, window_s = token_window(step, ctx.seconds, ctx.device)
    want = ctx.reference.next_tokens(emb, state["prev"])
    wrong = int((want != state["tok"]).sum())
    return Result(
        metrics={"decode_tokens_per_s": tokens / window_s,
                 "peak_mem_gib": 0.0, "setup_s": setup_s},
        checks=[Check("tokens_wrong", wrong, t["limits"]["tokens_wrong"])],
        attempted=tokens, failed=0, memory_peak_bytes=0,
        trace={"step_ms": 1e3 * window_s / steps} if ctx.trace else None)
"""
TOY_REFERENCE = """
def next_tokens(emb, tok):
    return (emb[tok].double() @ emb.T.double()).argmax(-1)
"""
TOY_READER = """
def read(trace):
    return trace.get("step_ms")
"""


def _toy_checkout(root: Path) -> dict:
    """``root`` as a checkout with the toy configuration added as new files
    and entries only: the benchmark's files copied, one configuration, one
    traffic file, a driver, a reader, a reference, the cell, and the
    ``decode_tokens_per_s`` entry that lists it."""
    shutil.copytree(ROOT / "mecbench", root / "mecbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    files = {
        "configs/toy-lm.json": json.dumps({
            "name": "toy-lm", "driver": "toy_lm", "reduced": [],
            "vocab": 64, "d_model": 32, "smoke": {"d_model": 8}}),
        "traffic/decode.toy.json": json.dumps({
            "why": "greedy decode, closed loop", "batch": 16,
            "limits": {"tokens_wrong": 0}, "smoke": {"batch": 2}}),
        "drivers/toy_lm.py": TOY_DRIVER,
        "reference/toy-lm.py": TOY_REFERENCE,
        "metrics/toy_step_ms.py": TOY_READER,
    }
    for name, text in files.items():
        (root / "mecbench" / name).write_text(text)
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({
        "name": "toy-lm", "source": "https://arxiv.org/abs/1706.06873",
        "file": "mecbench/configs/toy-lm.json", "reduced": [],
        "why": "a configuration whose driver is not conv_stack"})
    bench["workloads"].append({
        "name": "toy-lm.decode", "config": "toy-lm", "traffic": "decode.toy",
        "chips": 1, "why": "greedy decode at batch 16, closed loop"})
    bench["end_to_end"].append({
        "name": "decode_tokens_per_s", "unit": "tokens/s", "better": "higher",
        "bound": LM_RATE_BOUNDS["decode_tokens_per_s"],
        "source": "host_clock", "workloads": ["toy-lm.decode"]})
    bench["per_layer"].append({
        "name": "toy_step_ms", "unit": "ms", "better": "lower",
        "source": "host_clock", "layer": "serving",
        "moves": "decode_tokens_per_s", "workloads": ["toy-lm.decode"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return bench


def test_a_configuration_with_its_own_driver_comes_in_as_new_files(tmp_path):
    """A cell under ``decode_tokens_per_s`` whose configuration names a
    driver of its own runs through ``make_context``, ``load_driver`` and
    ``result_line`` with no file of the harness edited: its line holds
    that rate, ``peak_mem_gib`` and ``setup_s``, and the ResNet cells'
    lines are unchanged.  A ``workloads`` list left empty is refused."""
    bench = _toy_checkout(tmp_path)
    assert bench == bench_run.load_bench(tmp_path)
    check_metrics(bench)
    check_cells(bench)
    ctx = smoke_context("toy-lm.decode", trace=True, bench=bench,
                        root=tmp_path)
    assert (ctx.config["d_model"], ctx.traffic["batch"]) == (8, 2)
    res = bench_run.load_driver(ctx.config, tmp_path).run(ctx)
    device = {"platform": "gpu", "kind": "test", "count": 1,
              "memory_peak_bytes": 0}
    line = bench_run.result_line(bench, "toy-lm.decode", res, False, device,
                                 tmp_path)
    assert line["correct"] is True and list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"decode_tokens_per_s", "peak_mem_gib",
                                    "setup_s"}
    assert line["metrics"]["decode_tokens_per_s"]["unit"] == "tokens/s"
    res.trace["profile"] = {"busy_s": 0.5, "window_s": 1.0,
                            "breakdown": {"device_ops": [], "idle_gaps": []}}
    line = bench_run.result_line(bench, "toy-lm.decode", res, True, device,
                                 tmp_path)
    assert set(line["metrics"]) == {"toy_step_ms"}
    for w in CELLS:
        names = [[m["name"] for m in bench_run.cell_metrics(b, w, kind)]
                 for b in (bench, BENCH) for kind in ("end_to_end",
                                                      "per_layer")]
        assert names[:2] == names[2:]
        assert set(names[0]) == {"images_per_s", "peak_mem_gib", "setup_s"}
    bench["end_to_end"][-1]["workloads"] = []
    with pytest.raises(AssertionError):
        check_metrics(bench)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
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
