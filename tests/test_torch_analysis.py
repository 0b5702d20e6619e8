"""The port's memory auditor (``repro_torch.analysis.memaudit``) and its
CLI against the JAX package's (``repro.analysis.memaudit``), on the CPU.

The CPU exposes no allocator statistics, so the port records every CPU
cell.  What is held equal here: the audited cells and their Eq. 2-4
predictions (against the committed ``BENCH_memaudit.json``, from the
same plans), and the verdict the gate gives for the same (predicted,
measured) pair, the JAX package's measurement replaced by that number.
The kernel rule the port adds on the card (no temporary for the fused
kernels, exactly the Eq. 3 L for the lowered path, 2 MiB of slack) is
held on its own; on the card the cells themselves run in
``tests/test_torch_cuda.py``.
"""
import dataclasses
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

import repro.plan as jplan                                # noqa: E402
from repro.analysis import memaudit as jaudit             # noqa: E402
from repro.plan.convplan import ConvPlan as JPlan         # noqa: E402

import repro_torch.plan as plan_mod                       # noqa: E402
from repro_torch.analysis import __main__ as analysis_cli  # noqa: E402
from repro_torch.analysis import memaudit                 # noqa: E402
from repro_torch.bench.report import validate_report      # noqa: E402
from repro_torch.core.convspec import ConvSpec            # noqa: E402
from repro_torch.plan import calibrate as cal             # noqa: E402
from repro_torch.plan.__main__ import build_plans         # noqa: E402
from repro_torch.plan.convplan import ConvPlan            # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
CALIBRATION = REPO / "benchmarks" / "baselines" / "calibration.json"
SMALL = ConvSpec(1, 12, 12, 3, 3, 3, 4, 1, 1)
MIB = 1 << 20


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


def _calibrated_cpu_plans():
    """The port's analytic CPU plans of smoke and table2 under the
    committed calibration: the plans the committed BENCH_memaudit.json
    audited."""
    calib = cal._load_file(CALIBRATION, "cpu", strict_fingerprint=False)
    return memaudit.plans_of(build_plans(memaudit.DEFAULT_SUITES,
                                         calibration=calib, backend="cpu"))


def test_audit_cells_equal_the_committed_report():
    committed = json.loads((REPO / "BENCH_memaudit.json").read_text())
    doc, failures = memaudit.run_audit(plans=_calibrated_cpu_plans(),
                                       device="cpu")
    assert failures == [] and validate_report(doc) == []
    assert doc["environment"]["backend"] == "cpu"
    fields = ("scenario", "algorithm", "dtype", "spec",
              "predicted_overhead_elems", "predicted_overhead_bytes",
              "tolerance")
    assert [{f: r[f] for f in fields} for r in doc["results"]] == \
        [{f: r[f] for f in fields} for r in committed["results"]]
    for rec in doc["results"]:
        assert (rec["policy"], rec["verdict"], rec["source"]) == \
            ("recorded", "recorded", None)
        assert rec["measured_temp_bytes"] is rec["ratio"] is None
    drop = ("mec_temp_bytes", "im2col_temp_bytes", "algorithm")
    assert [{k: v for k, v in c.items() if k not in drop}
            for c in doc["crosscheck"]] == \
        [{k: v for k, v in c.items() if k not in drop}
         for c in committed["crosscheck"]]


def _jax_verdict(monkeypatch, algorithm, measured):
    """The JAX package's audit of one SMALL cell whose measured
    temporary bytes are ``measured`` (its compile replaced by that
    number)."""
    monkeypatch.setattr(jaudit, "lower_plan", lambda plan: None)
    stats = None if measured is None else {
        "temp_bytes": measured, "argument_bytes": 0, "output_bytes": 0,
        "source": "memory_analysis"}
    monkeypatch.setattr(jaudit, "memory_analysis", lambda compiled: stats)
    plan = JPlan(spec=jaudit.ConvSpec(**dataclasses.asdict(SMALL)),
                 dtype="float32", algorithm=algorithm,
                 solution="A" if algorithm == "mec" else "auto")
    return jaudit.audit_plan("unit/cell", plan)


# measured / predicted ratios around each band's edges, None (no stats)
RATIOS = (None, 0.0, 0.5, 0.95, 0.98, 1.0, 1.15, 1.5, 1.9, 2.0, 2.1, 3.0)


@pytest.mark.parametrize("algorithm", ["im2col", "mec", "fft", "winograd",
                                       "direct"])
def test_gate_verdicts_equal_the_jax_package(algorithm, monkeypatch):
    predicted = memaudit.memory.algorithm_overhead(SMALL, algorithm) * 4
    measures = [None if r is None else int(r * predicted) for r in RATIOS]
    if algorithm == "direct":          # predicts 0: gated on slack
        measures = [None, 0, 100, 4096, 4097, 1 << 20]
    for measured in measures:
        ref, ref_fails = _jax_verdict(monkeypatch, algorithm, measured)
        mine, fails = memaudit.gate("unit/cell", algorithm, predicted,
                                    measured)
        assert ref["predicted_overhead_bytes"] == predicted
        for f in ("ratio", "slack_bytes", "tolerance", "policy", "verdict"):
            assert mine[f] == ref[f], (algorithm, measured, f)
        assert fails == ref_fails


@pytest.mark.parametrize("algorithm,predicted", [("mec_fused", 0),
                                                 ("mec_fused2", 0),
                                                 ("mec_lowered", 5_000_000)])
def test_kernel_gate_is_the_eq3_rule(algorithm, predicted):
    """A kernel path passes with predicted <= measured <= predicted +
    2 MiB; below the prediction (a lost L) or past the slack it fails;
    with no statistics it is recorded."""
    for slack, verdict in ((0, "pass"), (2 * MIB, "pass"), (-1, "fail"),
                           (2 * MIB + 1, "fail")):
        rec, fails = memaudit.gate("unit/k", algorithm, predicted,
                                   predicted + slack)
        assert (rec["verdict"], rec["policy"], rec["slack_bytes"]) == \
            (verdict, "gated", slack), (algorithm, slack)
        assert bool(fails) == (verdict == "fail")
        assert rec["tolerance"] == memaudit.KERNEL_TOLERANCE
    rec, fails = memaudit.gate("unit/k", algorithm, predicted, None)
    assert (rec["verdict"], rec["policy"], fails) == \
        ("recorded", "recorded", [])


def test_card_plans_are_audited_under_every_algorithm():
    """A CUDA plan brings every other algorithm the planner may pick,
    with a crosscheck for each mec cell (plain mec and mec_lowered); a
    CPU plan only the JAX package's im2col companion of a mec plan."""
    plan = ConvPlan(spec=SMALL, dtype="float32", algorithm="mec_fused",
                    backend="cuda")
    assert [p.algorithm for p in memaudit._audited_plans(plan)] == \
        ["mec_fused", "direct", "im2col", "fft", "winograd", "mec",
         "mec_lowered", "mec_fused2"]
    cpu = dataclasses.replace(plan, backend="cpu")
    assert [p.algorithm for p in memaudit._audited_plans(cpu)] == \
        ["mec_fused"]
    doc, failures = memaudit.run_audit(plans={"unit/k": cpu}, device="cpu")
    assert failures == [] and [r["algorithm"] for r in doc["results"]] == \
        ["mec_fused"] and doc["crosscheck"] == []
    mec = dataclasses.replace(cpu, algorithm="mec", solution="A")
    doc, _ = memaudit.run_audit(plans={"unit/m": mec}, device="cpu")
    assert [r["algorithm"] for r in doc["results"]] == ["mec", "im2col"]
    (cc,) = doc["crosscheck"]
    assert (cc["ok"], cc["algorithm"], cc["mec_saving_elems"]) == \
        ("yes", "mec", memaudit.memory.mec_saving(SMALL))


def test_record_calibration_takes_gated_ratios_only(tmp_path):
    store = cal.CalibrationStore(tmp_path / "c.json", backend="cpu")
    records = [
        {"policy": "gated", "ratio": 1.0, "algorithm": "mec_lowered",
         "dtype": "float32", "spec": dataclasses.asdict(SMALL)},
        {"policy": "gated", "ratio": None, "algorithm": "mec_fused",
         "dtype": "float32", "spec": dataclasses.asdict(SMALL)},
        {"policy": "recorded", "ratio": 3.0, "algorithm": "im2col",
         "dtype": "float32", "spec": dataclasses.asdict(SMALL)},
    ]
    assert memaudit.record_calibration(records, store) == 1
    assert store.pending.mem_ratios() == {"mec": {"ratio": 1.0, "n": 1}}


def test_analysis_cli_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert analysis_cli.main(["--suite", "memaudit", "--device", "cpu"]) == 0
    doc = json.loads((tmp_path / memaudit.DEFAULT_REPORT).read_text())
    assert validate_report(doc) == [] and doc["suite"] == "memaudit"
    assert "all gated cells within tolerance" in capsys.readouterr().out
    plans = tmp_path / "plans.json"
    plans.write_text(json.dumps(build_plans(["smoke"], backend="cpu")))
    out = tmp_path / "audit.json"
    assert analysis_cli.main(["--plans", str(plans), "--out", str(out),
                              "--device", "cpu"]) == 0
    assert {r["scenario"] for r in json.loads(out.read_text())["results"]} \
        == {f"smoke/{n}" for n in ("s3x3", "s5x5", "s11x11", "w520")}
    # the suites of ROADMAP item 9 run (tests/test_torch_numcheck.py,
    # test_torch_lint.py, test_torch_launch_check.py); shardcheck runs on
    # spawned gloo ranks, here over the dist baseline's smoke cells (their
    # largest mesh: 4 ranks), in the JAX package's report schema
    base = json.loads((REPO / "benchmarks" / "baselines" / "dist.json")
                      .read_text())
    smoke = dict(base, results=[r for r in base["results"]
                                if r["scenario"].startswith("smoke")])
    trimmed, sc_out = tmp_path / "dist_smoke.json", tmp_path / "sc.json"
    trimmed.write_text(json.dumps(smoke))
    assert analysis_cli.main(["--suite", "shardcheck", "--device", "cpu",
                              "--dist", str(trimmed),
                              "--shardcheck-out", str(sc_out)]) == 0
    doc = json.loads(sc_out.read_text())
    assert validate_report(doc) == [] and doc["suite"] == "shardcheck"
    committed = {(r["scenario"], r["algorithm"]): r["verdict"] for r in
                 json.loads((REPO / "BENCH_shardcheck.json").read_text())[
                     "results"]}
    assert len(doc["results"]) == 12
    for r in doc["results"]:
        assert r["verdict"] == committed[(r["scenario"], r["algorithm"])] \
            == "pass"
    assert "12 cell(s) verified, 0 skipped" in capsys.readouterr().out


@pytest.mark.parametrize("own,verdict", [(0, "pass"), (4096, "pass"),
                                         (4097, "fail")])
def test_direct_is_gated_on_its_own_bytes_beside_the_librarys(
        monkeypatch, own, verdict):
    """``direct`` is cuDNN's convolution: what the library allocates in
    the one ``F.conv2d`` call (workspace, its KRSC copy of the kernel) is
    measured apart and recorded; the 4,096 B slack holds the rest.  Every
    other algorithm has no library field and is gated on its whole
    bytes."""
    library = 19_026_432

    def stats(plan):
        lib = library if plan.algorithm == "direct" else None
        return {"temp_bytes": (lib or 0) + own, "block_bytes": 0,
                "argument_bytes": 1,
                "output_bytes": 1, "library_workspace_bytes": lib,
                "source": memaudit.MEASURE_SOURCE}

    monkeypatch.setattr(memaudit, "measure_plan", stats)
    plan = ConvPlan(spec=SMALL, dtype="float32", algorithm="direct",
                    backend="cuda")
    rec, failures = memaudit.audit_plan("s", plan)
    assert rec["library_workspace_bytes"] == library
    assert rec["measured_temp_bytes"] == library + own
    assert rec["slack_bytes"] == own and rec["verdict"] == verdict
    assert bool(failures) == (verdict == "fail")
    mec = dataclasses.replace(plan, algorithm="mec", solution="A")
    rec, _ = memaudit.audit_plan("s", mec)
    assert rec["library_workspace_bytes"] is None
    assert rec["measured_temp_bytes"] == own


def test_library_bytes_are_the_operands_direct_hands_cudnn():
    """The auditor's bare library call and ``direct_conv2d`` hand
    ``F.conv2d`` the same operands: the NHWC input as a channels-last
    view (no copy) and the HWIO kernel as an OIHW view."""
    from repro_torch.core.direct import cudnn_operands, direct_conv2d
    x = torch.randn(2, 7, 9, 3)
    k = torch.randn(3, 3, 3, 5)
    xv, kv = cudnn_operands(x, k)
    assert xv.data_ptr() == x.data_ptr() and kv.data_ptr() == k.data_ptr()
    assert xv.is_contiguous(memory_format=torch.channels_last)
    y = torch.nn.functional.conv2d(xv, kv)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y.permute(0, 2, 3, 1), direct_conv2d(x, k))
