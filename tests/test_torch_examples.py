"""The port's quickstart and paper-figure drivers
(``repro_torch.examples.quickstart``, ``repro_torch.benchmarks``) against
the JAX package's (``examples/quickstart.py``, ``benchmarks/``), on the
CPU at small sizes.  On the card ``chip_smoke.py`` runs them at the
paper's sizes."""
import dataclasses
import importlib.util
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.plan as jplan                                   # noqa: E402
from repro.bench.scenarios import layer_spec as j_layer_spec  # noqa: E402
from repro.core import memory as jmemory                     # noqa: E402

import repro_torch.plan as plan_mod                          # noqa: E402
from repro_torch import benchmarks                           # noqa: E402
from repro_torch.bench import harness, scenarios             # noqa: E402
from repro_torch.bench.report import validate_report         # noqa: E402
from repro_torch.benchmarks import (conv_memory, conv_runtime,  # noqa: E402
                                    hbm_traffic, resnet101, run)
from repro_torch.core import numerics                        # noqa: E402
from repro_torch.examples import quickstart                  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


def _jax_driver(name):
    """A script of the JAX package's ``benchmarks/``, loaded from its
    file."""
    spec = importlib.util.spec_from_file_location(
        f"jax_benchmarks_{name}", REPO / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def plan_env(tmp_path, monkeypatch):
    for prefix in ("REPRO", "REPRO_TORCH"):
        monkeypatch.setenv(f"{prefix}_PLAN_CACHE_DIR", str(tmp_path / prefix))
        monkeypatch.setenv(f"{prefix}_CALIBRATION",
                           str(tmp_path / f"{prefix}-calibration-off.json"))
    for mod in (plan_mod, jplan):
        mod.reset_global_plan_cache()
        mod.reset_calibration_cache()
    yield tmp_path
    for mod in (plan_mod, jplan):
        mod.reset_global_plan_cache()
        mod.reset_calibration_cache()


def test_quickstart_on_the_cpu():
    lines = []
    out = quickstart.main(["--device", "cpu"], emit=lines.append)
    assert set(out["errors"]) == {n for n, _ in quickstart.ALGORITHMS}
    # every algorithm within twice its f32 contract of direct, scaled
    for name, kw in quickstart.ALGORITHMS:
        tol = numerics.fwd_tolerance(kw["algorithm"], "float32", 3 * 3 * 8)
        assert out["errors"][name] <= 2 * tol * out["scale"], name
    assert out["replayed"] == out["plan"] and out["replay_matches_auto"]
    assert out["auto"] == "mec"
    assert any(line.startswith("ConvPlan[analytic]") for line in
               "\n".join(lines).splitlines())
    assert out["overhead_mb"]["im2col"] > out["overhead_mb"]["mec"]


def test_conv_memory_rows_equal_the_jax_drivers():
    mine = conv_memory.rows(device="cpu")
    ref = _jax_driver("conv_memory").rows()
    assert [r["name"] for r in mine] == [r["name"] for r in ref]
    for a, b in zip(mine, ref):
        assert a == b
    lines = []
    conv_memory.main(emit=lines.append, device="cpu")
    jlines = []
    _jax_driver("conv_memory").main(emit=jlines.append)
    assert lines == jlines


def test_conv_runtime_times_every_fig4_algorithm_on_a_capped_layer():
    r = conv_runtime.run_layer("cv12", channel_cap=8, iters=1, device="cpu")
    assert set(r) == {"direct", "im2col", "mecA", "mecB", "fft", "winograd"}
    assert all(us > 0 for us in r.values())
    spec = conv_runtime._run_spec("cv12", 1, 8)
    assert (spec.i_c, spec.k_c, spec.i_h, spec.k_h) == (8, 8, 7, 3)
    assert conv_runtime._run_spec("cv12", 1, None) == \
        scenarios.layer_spec("cv12")


def test_resnet101_summary_is_the_jax_drivers_arithmetic():
    doc = harness.run_suite("resnet101", with_timing=False, device="cpu")
    rng = np.random.RandomState(0)
    for r in doc["results"]:
        r["us_per_call"] = float(rng.uniform(10, 100))
    t3 = resnet101.summarize(doc)
    mem_i2c = mem_mec = t_i2c = t_mec = 0.0
    for name, w in scenarios.RESNET101_WEIGHTS.items():
        algs = {r["algorithm"]: r for r in doc["results"]
                if r["scenario"] == name}
        mem_i2c += w * algs["im2col"]["overhead_bytes"] / 2 ** 20
        mem_mec += w * algs["mecA"]["overhead_bytes"] / 2 ** 20
        t_i2c += w * algs["im2col"]["us_per_call"]
        t_mec += w * min(algs["mecA"]["us_per_call"],
                         algs["mecB"]["us_per_call"])
    assert t3["mem_ratio"] == pytest.approx(mem_i2c / mem_mec, rel=1e-12)
    assert t3["runtime_ratio"] == pytest.approx(t_i2c / t_mec, rel=1e-12)
    assert t3["runtime_ratio_any_mec"] >= t3["runtime_ratio"]
    # the paper's 3.2x memory ratio is analytic: the JAX package's model
    weights = scenarios.RESNET101_WEIGHTS.items()
    ref = sum(w * jmemory.im2col_overhead(j_layer_spec(n)) for n, w in weights)
    ref /= sum(w * jmemory.mec_overhead(j_layer_spec(n)) for n, w in weights)
    assert t3["mem_ratio"] == pytest.approx(ref, rel=1e-12)


def test_hbm_traffic_models_the_launch_geometry():
    rows = hbm_traffic.rows()
    jrows = {r["name"]: r for r in _jax_driver("tpu_traffic").rows()}
    assert [r["name"] for r in rows] == list(scenarios.CV_LAYERS)
    for r in rows:
        # im2col's flow is the JAX model's; the kernels' come from the
        # launch geometry, and stage at least I, K and O once
        assert r["im2col"] == jrows[r["name"]]["im2col"]
        s = scenarios.layer_spec(r["name"], batch=hbm_traffic.BATCH)
        floor = 4 * (s.i_n * s.i_h * s.i_w * s.i_c
                     + s.i_n * s.o_h * s.o_w * s.k_c)
        for flow in ("lowered", "fused", "fused2"):
            assert r[flow] >= floor
        assert r["bound"] in ("bytes", "operations")
    lines = []
    hbm_traffic.main(emit=lines.append)
    assert lines[0] == "table,name,us_per_call,derived" and len(lines) == 13


def test_run_drives_sections_and_names_failures(monkeypatch):
    lines = []
    out = run.main(["--only", "fig4b_memory", "--device", "cpu"],
                   emit=lines.append)
    assert lines[0] == "# === fig4b_memory ===" and "fig4b_memory" in out
    doc_lines = []
    run.main(["--only", "fig4b_memory", "--device", "cpu", "--format",
              "json"], emit=doc_lines.append)
    assert validate_report(json.loads(doc_lines[1])) == []

    def broken(**kw):
        raise RuntimeError("a broken section")

    monkeypatch.setitem(run.SECTIONS, "hbm_traffic", broken)
    with pytest.raises(SystemExit, match="1 benchmark section"):
        run.main(["--only", "hbm_traffic"], emit=lambda *_: None)


def test_package_reexports_convbench():
    jbench = _jax_driver("convbench")
    for name in ("CV_LAYERS", "RESNET101_WEIGHTS", "make_arrays",
                 "time_compiled", "layer_spec", "spec", "time_us"):
        assert hasattr(benchmarks, name) and hasattr(jbench, name)
    assert benchmarks.CV_LAYERS == jbench.CV_LAYERS
    assert dataclasses.astuple(benchmarks.spec("cv9", 2)) == \
        dataclasses.astuple(jbench.spec("cv9", 2))
    assert benchmarks.time_us(lambda: torch.zeros(3), iters=2) > 0
