"""The port's benchmark subsystem (``repro_torch.bench``), the report-
reading half of its calibration (``repro_torch.plan.calibrate``) and its
plan CLI (``repro_torch.plan.__main__``) against the JAX package's, on
the CPU.

Both packages plan for the CPU here, so ``auto_algorithm`` and the plans'
decision fields are held equal.  Reports, corruptions of one report,
calibrations and plans documents go through both packages' validators,
gates and fits; their failures (not their notes, which name each
package's own versions) are held equal.  The committed JAX-package
documents (``BENCH_autotune.json``, ``benchmarks/baselines/
calibration.json`` and ``plans.json``) are read as fixtures, never
written.
"""
import copy
import dataclasses
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

import repro.plan as jplan                                # noqa: E402
from repro.bench import check as jcheck                   # noqa: E402
from repro.bench import harness as jharness               # noqa: E402
from repro.bench import report as jreport                 # noqa: E402
from repro.bench import scenarios as jscen                # noqa: E402
from repro.plan import __main__ as jplan_cli              # noqa: E402
from repro.plan import calibrate as jcal                  # noqa: E402

import repro_torch.plan as plan_mod                       # noqa: E402
from repro_torch.bench import __main__ as bench_cli       # noqa: E402
from repro_torch.bench import check, harness, report, scenarios  # noqa: E402
from repro_torch.plan import __main__ as plan_cli         # noqa: E402
from repro_torch.plan import calibrate as cal             # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
AUTOTUNE = REPO / "BENCH_autotune.json"
CALIBRATION = REPO / "benchmarks" / "baselines" / "calibration.json"
PLANS = REPO / "benchmarks" / "baselines" / "plans.json"
DECISION_FIELDS = ("algorithm", "solution", "partition", "partition_axes")


@pytest.fixture(autouse=True)
def plan_env(tmp_path, monkeypatch):
    """Both packages' plan caches and calibrations under tmp_path (the
    calibration file does not exist: the paper's constants)."""
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


# ---------------------------------------------------------------- registry

def test_registry_constants_equal_the_jax_package():
    assert scenarios.CV_LAYERS == jscen.CV_LAYERS
    assert scenarios.RESNET101_WEIGHTS == jscen.RESNET101_WEIGHTS
    assert scenarios.ALGORITHM_VARIANTS == jscen.ALGORITHM_VARIANTS
    assert scenarios.CORE_VARIANTS == jscen.CORE_VARIANTS
    assert set(scenarios.SUITES) == set(jscen.SUITES)
    assert [dataclasses.asdict(c) for c in scenarios.serve_cells()] == \
        [dataclasses.asdict(c) for c in jscen.serve_cells()]
    for name in scenarios.CV_LAYERS:
        assert dataclasses.asdict(scenarios.layer_spec(name, batch=3)) == \
            dataclasses.asdict(jscen.layer_spec(name, batch=3))


@pytest.mark.parametrize("suite", sorted(jscen.SUITES))
def test_suite_equals_the_jax_package_at_full_width(suite):
    """Names, paper specs, algorithms, weights, dtypes, partitions and
    tuning candidates as the JAX package's; the timed spec is the paper
    spec (the JAX package caps channels for its CPU)."""
    mine, ref = scenarios.resolve_suite(suite), jscen.resolve_suite(suite)
    assert [s.name for s in mine] == [s.name for s in ref]
    for m, r in zip(mine, ref):
        assert dataclasses.asdict(m.spec) == dataclasses.asdict(r.spec)
        assert m.run_spec == m.spec
        assert (m.algorithms, m.dtype, m.weight, m.partition, m.n_dev,
                m.tune_candidates) == \
            (r.algorithms, r.dtype, r.weight, r.partition, r.n_dev,
             r.tune_candidates)


def test_unknown_suite_rejected():
    with pytest.raises(KeyError):
        scenarios.resolve_suite("nope")


# ----------------------------------------------------------------- records

def _pairs(suite):
    return list(zip(scenarios.resolve_suite(suite),
                    jscen.resolve_suite(suite)))


@pytest.mark.parametrize("suite,index", [("table2", i) for i in range(12)]
                         + [("smoke", i) for i in range(4)])
def test_measure_analytics_equal_the_jax_package(suite, index):
    """overhead, flops, ``auto`` and the plan's decision fields of every
    variant of a scenario, with no timing, against the JAX package's
    ``measure(with_hlo=False, with_timing=False)``."""
    sc, jsc = _pairs(suite)[index]
    for alg in sc.algorithms:
        mine = harness.measure(sc, alg, with_timing=False, device="cpu")
        ref = jharness.measure(jsc, alg, with_hlo=False, with_timing=False)
        for f in ("overhead_elems", "overhead_bytes", "flops",
                  "auto_algorithm", "spec", "dtype", "weight", "scenario",
                  "algorithm"):
            assert mine[f] == ref[f], (sc.name, alg, f)
        for f in DECISION_FIELDS:
            assert mine["plan"][f] == ref["plan"][f], (sc.name, alg, f)
        assert mine["run_spec"] == mine["spec"]
        assert mine["out_shape"] == list(sc.spec.out_shape)
        assert mine["run_flops"] == mine["flops"]
        assert (mine["us_per_call"], mine["timing"], mine["hlo_flops"],
                mine["hlo_bytes"]) == (None, None, None, None)


@pytest.fixture(scope="module")
def smoke_doc():
    """A timed smoke suite on the CPU, one iteration a cell."""
    return harness.run_suite("smoke", iters=1, crosscheck=True, device="cpu")


def test_timed_smoke_suite_on_the_cpu_validates(smoke_doc):
    assert report.validate_report(smoke_doc) == []
    assert report.validate_report(json.loads(json.dumps(smoke_doc))) == []
    assert {r["algorithm"] for r in smoke_doc["results"]} == \
        set(scenarios.ALGORITHM_VARIANTS)
    assert all(r["us_per_call"] > 0 and r["timing"]["iters"] == 1
               for r in smoke_doc["results"])
    env = smoke_doc["environment"]
    assert (env["backend"], env["device_kind"], env["torch"]) == \
        ("cpu", "cpu", torch.__version__)
    assert [c["scenario"] for c in smoke_doc["crosscheck"]] == \
        [s.name for s in scenarios.resolve_suite("smoke")]
    for c in smoke_doc["crosscheck"]:
        assert c["measured_best"] in scenarios.ALGORITHM_VARIANTS
        assert isinstance(c["auto_matches_best"], bool)
    untimed = harness.run_suite("smoke", with_timing=False, device="cpu")
    assert check.compare(smoke_doc, untimed, schema_only_on_timing=True) \
        == ([], [])


def test_crosscheck_equals_the_jax_package(smoke_doc):
    by_scenario = {}
    for rec in smoke_doc["results"]:
        by_scenario.setdefault(rec["scenario"], []).append(rec)
    for recs in by_scenario.values():
        assert harness.crosscheck_scenario(recs) == \
            jharness.crosscheck_scenario(recs)


def test_unported_cells_and_a_missing_card_raise(monkeypatch):
    (sc,) = [s for s in scenarios.resolve_suite("dist")
             if s.name == "smoke2_batch"]
    with pytest.raises(NotImplementedError, match="item 11"):
        harness.measure(sc, "mecB", with_timing=False, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    table2 = scenarios.resolve_suite("table2")[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        harness.measure(table2, "direct", with_timing=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        harness.run_autotune("smoke")
    with pytest.raises(RuntimeError, match="CUDA"):
        harness.run_serve()


def test_bench_cli_writes_its_own_report_name(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert bench_cli.main(["--suite", "smoke", "--device", "cpu",
                           "--iters", "1", "--crosscheck"]) == 0
    assert sorted(p.name for p in tmp_path.glob("*.json")) == \
        ["BENCH_torch_smoke.json"]
    doc = json.loads((tmp_path / "BENCH_torch_smoke.json").read_text())
    assert report.validate_report(doc) == [] and "crosscheck" in doc
    capsys.readouterr()
    assert bench_cli.main(["--suite", "smoke", "--device", "cpu",
                           "--no-timing", "--format", "csv"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "table,name,us_per_call,derived"
    assert len(lines) == 1 + len(doc["results"])


def test_autotune_on_the_cpu_validates_and_ingests(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert bench_cli.main(["--suite", "autotune", "--base-suite", "smoke",
                           "--device", "cpu", "--iters", "1"]) == 0
    doc = json.loads((tmp_path / "BENCH_torch_autotune.json").read_text())
    assert doc["autotune_schema_version"] == 2
    assert doc["environment"]["backend"] == "cpu"
    assert [r["scenario"] for r in doc["results"]] == \
        [s.name for s in scenarios.resolve_suite("smoke")]
    for rec in doc["results"]:
        assert rec["n_skipped"] == 0, rec["skipped"]
        assert rec["plan"]["backend"] == "cpu"
    assert check.compare(doc, doc) == jcheck.compare(doc, doc)
    assert check.compare(doc, doc)[0] == []
    calib = cal.Calibration.for_current_env("cpu")
    jcalib = jcal.Calibration.for_current_env()
    assert cal.ingest_autotune(calib, doc) == \
        jcal.ingest_autotune(jcalib, doc) > 0


# ------------------------------------------------- validate and compare

def _env_both(doc):
    """One document both packages validate: the port's environment block
    with the JAX package's ``jax`` key beside it."""
    doc = copy.deepcopy(doc)
    doc["environment"]["jax"] = "0.0.0"
    return doc


def _set(path, value):
    def corrupt(d):
        node = d
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = value(node[path[-1]]) if callable(value) else value
    return corrupt


def _delete(path):
    def corrupt(d):
        node = d
        for k in path[:-1]:
            node = node[k]
        del node[path[-1]]
    return corrupt


CORRUPTIONS = {
    "intact": lambda d: None,
    "missing_field": _delete(["results", 0, "overhead_bytes"]),
    "wrong_type": _set(["results", 0, "flops"], "lots"),
    "bool_is_not_int": _set(["results", 0, "weight"], True),
    "schema_version": _set(["schema_version"], 99),
    "no_results": _set(["results"], []),
    "results_not_list": _set(["results"], {}),
    "empty_suite": _set(["suite"], ""),
    "harness_not_object": _set(["harness"], None),
    "env_missing_backend": _delete(["environment", "backend"]),
    "spec_missing_int": _set(["results", 0, "spec", "k_h"], 3.0),
    "duplicate_cell": lambda d: d["results"].append(
        copy.deepcopy(d["results"][0])),
    "overhead_drift": _set(["results", 1, "overhead_bytes"], lambda v: v + 4),
    "flops_drift": _set(["results", 2, "flops"], lambda v: v * 2),
    "auto_drift": _set(["results", 0, "auto_algorithm"], "direct"),
    "lost_cell": lambda d: d["results"].pop(0),
    "slower_10x": _set(["results", 0, "us_per_call"], lambda v: v * 10),
    "untimed": _set(["results", 0, "us_per_call"], None),
    "hlo_drift": _set(["results", 0, "hlo_bytes"], 12345.0),
    "partition_block": _set(["results", 0, "partition"], "spatial"),
    "serve_block": _set(["results", 0, "serve_mode"], "warm"),
    "optional_type": _set(["results", 0, "plan"], "mec"),
    "suite_mismatch": _set(["suite"], "table2"),
    "backend_and_auto": lambda d: (
        d["environment"].__setitem__("backend", "tpu"),
        d["results"][0].__setitem__("auto_algorithm", "mec_fused")),
}


@pytest.mark.parametrize("name", sorted(CORRUPTIONS))
def test_validate_and_compare_fail_as_the_jax_package(smoke_doc, name):
    base = _env_both(smoke_doc)
    bad = copy.deepcopy(base)
    CORRUPTIONS[name](bad)
    assert report.validate_report(bad) == jreport.validate_report(bad)
    for only in (False, True):
        for new, old in ((bad, base), (base, bad)):
            mine = check.compare(copy.deepcopy(new), copy.deepcopy(old),
                                 schema_only_on_timing=only)
            ref = jcheck.compare(copy.deepcopy(new), copy.deepcopy(old),
                                 schema_only_on_timing=only)
            assert mine[0] == ref[0], (name, only)
    if name == "intact":
        assert report.validate_report(bad) == []


def test_compare_notes_name_torch_and_the_card(smoke_doc):
    other = copy.deepcopy(smoke_doc)
    other["environment"].update(torch="0.0", device_kind="another card")
    failures, notes = check.compare(smoke_doc, other)
    assert failures == []
    assert any("torch differs" in n for n in notes)
    assert any("device_kind differs" in n for n in notes)


AUTOTUNE_CORRUPTIONS = {
    "intact": lambda d: None,
    "analytic_flip": _set(["results", 0, "analytic_algorithm"], "direct"),
    "newly_skipped": _set(["results", 1, "skipped"], {"fft": "boom"}),
    "measured_slower": _set(["results", 2, "measured_us"], lambda v: v * 5),
    "measured_drift": _set(["results", 0, "measured_algorithm"], "fft"),
    "lost_cell": lambda d: d["results"].pop(),
    "base_suite": _set(["base_suite"], "table2"),
    "schema": _set(["autotune_schema_version"], 7),
    "backend": _set(["environment", "backend"], "tpu"),
    "calibration_off": _set(["calibration", "active"], False),
}


@pytest.mark.parametrize("name", sorted(AUTOTUNE_CORRUPTIONS))
def test_autotune_compare_fails_as_the_jax_package(name):
    base = json.loads(AUTOTUNE.read_text())
    bad = copy.deepcopy(base)
    AUTOTUNE_CORRUPTIONS[name](bad)
    for only in (False, True):
        for new, old in ((bad, base), (base, bad)):
            assert check.compare(new, old, schema_only_on_timing=only)[0] \
                == jcheck.compare(new, old, schema_only_on_timing=only)[0]


def test_render_csv_equals_the_jax_package(smoke_doc):
    assert report.render_csv(smoke_doc) == jreport.render_csv(smoke_doc)


# ----------------------------------------------------------- calibration

def _fits_equal(mine, ref):
    assert json.loads(json.dumps(mine)) == json.loads(json.dumps(ref))


def test_ingest_committed_reports_fit_as_the_jax_package():
    autotune = json.loads(AUTOTUNE.read_text())
    memaudit = json.loads((REPO / "BENCH_memaudit.json").read_text())
    calib = cal.Calibration.for_current_env("cpu")
    jcalib = jcal.Calibration.for_current_env()
    assert cal.ingest_autotune(calib, autotune) == \
        jcal.ingest_autotune(jcalib, autotune)
    assert cal.ingest_memaudit(calib, memaudit) == \
        jcal.ingest_memaudit(jcalib, memaudit)
    assert calib.time_samples == jcalib.time_samples
    assert calib.mem_samples == jcalib.mem_samples
    _fits_equal(calib.fit(), jcalib.fit())


def _tamper(path, factor):
    return _set(path, lambda v: v * factor)


CALIBRATION_CORRUPTIONS = {
    "intact": lambda d: None,
    "decision": _set(["fitted", "decisions", "1x16x16x3-k5x5x8-s2x2",
                      "calibrated"], "mec"),
    "mem_ratio": _tamper(["fitted", "mem_ratio", "mec", "ratio"], 1.2),
    "mem_ratio_small": _tamper(["fitted", "mem_ratio", "mec", "ratio"], 1.01),
    "time_constant": _tamper(["fitted", "time_constants", "direct", "c0"],
                             1.5),
    "time_cell": _tamper(["fitted", "time_cells", "1x16x16x3-k5x5x8-s2x2",
                          "direct"], 2.0),
    "time_cell_lost": _delete(["fitted", "time_cells",
                               "1x16x16x3-k5x5x8-s2x2", "direct"]),
    "coverage": _delete(["fitted", "mem_ratio", "im2col"]),
    "no_fit": _delete(["fitted"]),
    "version": _set(["calibration_file_version"], 9),
}


@pytest.mark.parametrize("name", sorted(CALIBRATION_CORRUPTIONS))
def test_check_calibration_fails_as_the_jax_package(name):
    doc = json.loads(CALIBRATION.read_text())
    CALIBRATION_CORRUPTIONS[name](doc)
    mine = cal.check_calibration(copy.deepcopy(doc))
    ref = jcal.check_calibration(copy.deepcopy(doc))
    if name == "no_fit":      # the hint names each package's CLI
        assert len(mine) == len(ref) == 1 and "fitted" in mine[0]
    else:
        assert mine == ref
    # a 1% nudge is inside the 5% coefficient tolerance
    assert (mine == []) == (name in ("intact", "mem_ratio_small"))


def test_render_report_equals_the_jax_package():
    doc = json.loads(CALIBRATION.read_text())
    lines = cal.render_report(cal.Calibration.from_dict(doc))
    assert lines == jcal.render_report(jcal.Calibration.from_dict(doc))
    assert any("<-- flip" in ln for ln in lines)


def test_calibrate_cli_fits_checks_and_reports(tmp_path, monkeypatch,
                                               capsys):
    """``calibrate --fit`` on the committed reports equals the JAX
    package's fit; ``--check`` passes it and fails a tampered copy;
    ``--report`` prints it; nothing is written outside the paths given
    or the working directory."""
    monkeypatch.chdir(tmp_path)
    memaudit = REPO / "BENCH_memaudit.json"
    out = tmp_path / "fit.json"
    args = ["--fit", "--autotune", str(AUTOTUNE), "--memaudit", str(memaudit)]
    assert cal.calibrate_main(args + ["--out", str(out), "--device",
                                      "cpu"]) == 0
    jout = tmp_path / "jfit.json"
    assert jcal.calibrate_main(args + ["--out", str(jout)]) == 0
    mine, ref = json.loads(out.read_text()), json.loads(jout.read_text())
    assert mine["backend"] == ref["backend"] == "cpu"
    _fits_equal(mine["fitted"], ref["fitted"])
    assert cal.calibrate_main(["--check", "--baseline", str(out)]) == 0
    assert cal.calibrate_main(["--report", "--baseline", str(out),
                               "--device", "cpu"]) == 0
    assert "calibrated=direct" in capsys.readouterr().out
    mine["fitted"]["mem_ratio"]["mec"]["ratio"] *= 1.2
    out.write_text(json.dumps(mine))
    assert cal.calibrate_main(["--check", "--baseline", str(out)]) == 1
    assert cal.calibrate_main(["--check", "--rtol", "0.5",
                               "--baseline", str(out)]) == 0
    assert cal.calibrate_main(["--fit", "--device", "cpu"]) == 2
    assert cal.calibrate_main(["--check"]) == 2      # no file in the cwd
    assert cal.calibrate_main(args + ["--device", "cpu"]) == 0
    assert (tmp_path / cal.DEFAULT_CALIBRATION).exists()


# ------------------------------------------------------------------ plans

def _loaded_calibrations():
    mine = cal._load_file(CALIBRATION, "cpu", strict_fingerprint=False)
    ref = jcal._load_file(CALIBRATION, strict_fingerprint=False)
    assert mine is not None and ref is not None
    return mine, ref


@pytest.mark.parametrize("calibrated", [False, True])
def test_build_plans_equals_the_jax_package(calibrated):
    mine_cal, ref_cal = _loaded_calibrations() if calibrated \
        else (None, None)
    mine = plan_cli.build_plans(["smoke", "table2"], calibration=mine_cal,
                                backend="cpu")
    ref = jplan_cli.build_plans(["smoke", "table2"], calibration=ref_cal)
    assert sorted(mine["plans"]) == sorted(ref["plans"])
    for key, plan in mine["plans"].items():
        for f in DECISION_FIELDS + ("spec", "dtype", "backend", "mode"):
            assert plan[f] == ref["plans"][key][f], (key, f)
    assert mine["calibration"]["active"] == calibrated
    assert plan_cli.compare_plans(mine, ref)[0] == []
    committed = json.loads(PLANS.read_text())
    assert (plan_cli.compare_plans(mine, committed)[0] == []) == calibrated
    assert plan_cli.compare_plans(mine, committed)[0] == \
        jplan_cli.compare_plans(ref, committed)[0]


PLAN_CORRUPTIONS = {
    "algorithm": _set(["plans", "smoke/s3x3", "algorithm"], "direct"),
    "solution": _set(["plans", "table2/cv7", "solution"], "B"),
    "lost": _delete(["plans", "table2/cv1"]),
    "w_blk_note": _set(["plans", "table2/cv2", "w_blk"], 64),
    "schema": _set(["plans_schema_version"], 2),
    "empty": _set(["plans"], {}),
    "backend": _set(["environment", "backend"], "tpu"),
}


@pytest.mark.parametrize("name", sorted(PLAN_CORRUPTIONS))
def test_compare_plans_fails_as_the_jax_package(name):
    committed = json.loads(PLANS.read_text())
    bad = copy.deepcopy(committed)
    PLAN_CORRUPTIONS[name](bad)
    for new, old in ((bad, committed), (committed, bad)):
        assert plan_cli.compare_plans(new, old) == \
            jplan_cli.compare_plans(new, old)


def test_plan_cli_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "plans.json"
    assert plan_cli.main(["--device", "cpu", "--calibration",
                          str(CALIBRATION), "--baseline", str(PLANS),
                          "--out", str(out)]) == 0
    assert "OK: plans match" in capsys.readouterr().out
    doc = json.loads(out.read_text())
    assert doc["environment"]["backend"] == "cpu"
    assert doc["calibration"] == {"path": str(CALIBRATION), "active": True}
    # the paper's constants (no calibration) keep s5x5 on mec: one flip
    assert plan_cli.main(["--device", "cpu", "--baseline", str(PLANS)]) == 1
    assert plan_cli.main(["--device", "cpu", "--calibration",
                          str(tmp_path / "absent.json")]) == 2
    assert plan_cli.main(["calibrate", "--check", "--baseline",
                          str(CALIBRATION)]) == 0
