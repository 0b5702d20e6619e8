"""The port's numerics contract checker (``repro_torch.analysis.numcheck``)
against the JAX package's (``repro.analysis.numcheck``), on the CPU.

Held equal: the f64 oracle (to the bit, on the same numpy inputs), the
error probe's verdict (within budget wherever the JAX package's is), the
static verdict and the number of output narrows of every algorithm x
dtype (the committed ``BENCH_numcheck.json``), and the bench records'
``numcheck`` field (the committed ``benchmarks/baselines/smoke.json``).
Each static rule is held to catch a planted program of its class.  On
the card, the kernel paths' probes run in ``tests/test_torch_cuda.py``.
"""
import copy
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.plan as jplan                                   # noqa: E402
from repro.analysis import numcheck as jnum                  # noqa: E402

import repro_torch.plan as plan_mod                          # noqa: E402
from repro_torch.analysis import __main__ as analysis_cli    # noqa: E402
from repro_torch.analysis import numcheck as N               # noqa: E402
from repro_torch.bench import check, harness                 # noqa: E402
from repro_torch.bench.report import validate_report         # noqa: E402
from repro_torch.core import numerics                        # noqa: E402
from repro_torch.core.convspec import ConvSpec               # noqa: E402
from repro_torch.plan import convplan                        # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
CELLS = [(a, d) for a in N.NUMCHECK_ALGORITHMS for d in N.NUMCHECK_DTYPES]
IDS = [f"{a}-{d}" for a, d in CELLS]


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


@pytest.fixture(scope="module")
def committed():
    doc = json.loads((REPO / "BENCH_numcheck.json").read_text())
    return {(r["algorithm"], r["dtype"]): r for r in doc["results"]}


@pytest.mark.parametrize("stride", [(1, 1), (2, 2), (2, 3)])
def test_f64_oracle_equals_the_jax_packages(stride):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 11, 13, 3)
    k = rng.randn(3, 4, 3, 5)
    out = N.f64_conv2d(x, k, *stride)
    assert np.array_equal(out, jnum.f64_conv2d(x, k, *stride))
    g = rng.randn(*out.shape)
    for mine, ref in zip(N.f64_conv2d_grads(x, k, g, *stride),
                         jnum.f64_conv2d_grads(x, k, g, *stride)):
        assert np.array_equal(mine, ref)
    assert N._rel_err(out + 1e-3, out) == jnum._rel_err(out + 1e-3, out)


@pytest.mark.parametrize("algorithm,dtype", CELLS, ids=IDS)
def test_error_probe_within_budget_wherever_the_jax_packages_is(algorithm,
                                                                 dtype):
    spec = N.probe_spec()
    mine = N.error_probe(spec, algorithm, dtype)
    ref = jnum.error_probe(jnum.probe_spec(), algorithm, dtype,
                           interpret=True)
    budgets = N.probe_budgets(spec, algorithm, dtype, scaled=False)
    for key, tol in zip(("fwd_err", "din_err", "dk_err"), budgets):
        if ref[key] <= tol:
            assert mine[key] <= tol, (key, mine, ref)
    assert budgets == (numerics.CONTRACTS[algorithm].tolerance(dtype, "fwd"),
                       numerics.CONTRACTS[algorithm].tolerance(dtype, "grad"),
                       numerics.CONTRACTS[algorithm].tolerance(dtype, "grad"))


@pytest.mark.parametrize("algorithm,dtype", CELLS, ids=IDS)
def test_static_contract_as_the_jax_package_reports(algorithm, dtype,
                                                     committed):
    """Every cell's static verdict is the committed JAX report's (pass),
    and the forward narrows to the input dtype as often (once below f32,
    never in f32)."""
    chk = N.check_numerics(N.probe_spec(), algorithm, dtype, probe=False)
    ref = committed[(algorithm, dtype)]
    assert chk.ok and chk.record["verdict"] == ref["verdict"] == "pass"
    # the backward differs in structure (autograd against a VJP jaxpr);
    # the contract's count is the forward's
    assert chk.record["directions"]["fwd"]["narrows_to_input"] == \
        ref["directions"]["fwd"]["narrows_to_input"]
    kernel = algorithm in N.KERNEL_PATHS
    assert (chk.record["directions"]["fwd"]["kernel_dots"] > 0) == kernel
    assert chk.record["contract"] == ref["contract"]


# ------------------------------------------------------- planted rules

def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _planted():
    a16 = _meta((4, 8), torch.bfloat16)
    b16 = _meta((8, 3), torch.bfloat16)
    a32 = _meta((4, 8))
    b32 = _meta((8, 3))
    return {
        "accumulation": lambda: torch.mm(a16, b16),
        "output-cast-count": lambda: (torch.mm(a32, b32).to(torch.bfloat16)
                                      .to(torch.float32) * 2
                                      ).to(torch.bfloat16),
        "narrow-widen": lambda: torch.mm(
            a32.to(torch.bfloat16).t().to(torch.float32).t(), b32),
        "f64-leak": lambda: torch.mm(a32.double(), b32.double()),
        "disallowed-dtype": lambda: torch.mm(a32.half().float(), b32),
    }


@pytest.mark.parametrize("rule", sorted(_planted()))
def test_each_static_rule_catches_a_planted_program(rule):
    sig = N.trace(_planted()[rule])
    contract = numerics.CONTRACTS["im2col"]
    rules = {v.rule for v in N.signature_findings(sig, contract, "fwd",
                                                  "bfloat16")}
    if rule == "disallowed-dtype":
        rules = {v.rule for v in N.signature_findings(sig, contract, "fwd",
                                                      "float32")}
    assert rule in rules, rules


def test_a_loop_counts_its_line_once():
    """Like a scan body in a jaxpr, a line run many times is one cast."""
    x = _meta((4, 8))

    def program():
        for _ in range(5):
            x.to(torch.bfloat16)

    sig = N.trace(program)
    assert len(sig["casts"]) == 5
    findings = N.signature_findings(sig, numerics.CONTRACTS["im2col"], "fwd",
                                    "bfloat16")
    assert findings == []


def test_kernel_nodes_declare_their_accumulator(monkeypatch):
    spec = N.probe_spec()
    sig = N.trace_signature(spec, "mec_fused", "bfloat16")
    (node,) = [d for d in sig["dots"] if d["kernel"]]
    assert node["op"] == "kernel:mec_fused" and node["accum"] == "float32"
    assert node["operands"] == ["bfloat16", "bfloat16"]
    (narrow,) = [c for c in sig["casts"] if c["kind"] == "narrow"]
    assert narrow["kernel"] and narrow["dst"] == "bfloat16"
    monkeypatch.setitem(N.KERNEL_ACCUM, "mec_fused", "bfloat16")
    sig = N.trace_signature(spec, "mec_fused", "bfloat16")
    rules = {v.rule for v in N.signature_findings(
        sig, numerics.CONTRACTS["mec_fused"], "fwd", "bfloat16")}
    assert "kernel-accum" in rules


def test_refused_kernel_geometries_and_unknown_dtypes_skip():
    refused = ConvSpec(1, 40, 120, 32, 33, 33, 64, 1, 1)
    chk = N.check_numerics(refused, "mec_fused", probe=False)
    assert chk.skipped and "launch check" in chk.skipped and chk.ok
    assert N.check_numerics(N.probe_spec(), "im2col", "float64",
                            probe=False).record["verdict"] == "skipped"
    wino = N.check_numerics(ConvSpec(1, 9, 9, 2, 5, 5, 2), "winograd",
                            probe=False)
    assert wino.record["verdict"] == "skipped"


# --------------------------------------------------------- the wiring

def test_plan_conv2d_runs_assert_plan_numerics(monkeypatch):
    spec = ConvSpec(1, 10, 10, 3, 3, 3, 4)
    plan = plan_mod.plan_conv2d(spec, dtype="bfloat16", backend="cpu")
    assert plan.algorithm in N.NUMCHECK_ALGORITHMS
    broken = numerics.NumericContract(
        plan.algorithm, fwd_output_narrows=2,
        error_budget=numerics.CONTRACTS[plan.algorithm].error_budget)
    monkeypatch.setitem(numerics.CONTRACTS, plan.algorithm, broken)
    N._static_check.cache_clear()
    try:
        with pytest.raises(N.NumCheckError, match="output-cast-count"):
            plan_mod.plan_conv2d(spec, dtype="bfloat16", backend="cpu")
        with pytest.raises(N.NumCheckError):
            plan_mod.plan_conv2d(spec, dtype="bfloat16", backend="cpu",
                                 mode="measured", iters=1,
                                 candidates=(plan.algorithm,))
    finally:
        monkeypatch.undo()
        N._static_check.cache_clear()
    assert convplan.plan_conv2d(spec, dtype="bfloat16", backend="cpu") == plan


def test_bench_records_carry_the_jax_baselines_numcheck():
    """The smoke suite's records carry the field the JAX package's
    committed baseline does, cell for cell, and ``bench.check`` compares
    it."""
    base = json.loads((REPO / "benchmarks/baselines/smoke.json").read_text())
    ref = {(r["scenario"], r["algorithm"]): r["numcheck"]
           for r in base["results"]}
    doc = harness.run_suite("smoke", with_timing=False, device="cpu")
    assert {(r["scenario"], r["algorithm"]): r["numcheck"]
            for r in doc["results"]} == ref
    assert validate_report(doc) == []
    bad = copy.deepcopy(doc)
    bad["results"][0]["numcheck"]["verdict"] = "fail"
    failures, _ = check.compare(bad, doc, schema_only_on_timing=True)
    assert any("numcheck" in f for f in failures)


def test_numcheck_suite_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "numcheck.json"
    assert analysis_cli.main(["--suite", "numcheck", "--device", "cpu",
                              "--numcheck-out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert validate_report(doc) == [] and doc["suite"] == "numcheck"
    assert len(doc["results"]) == len(CELLS)
    assert {r["verdict"] for r in doc["results"]} == {"pass"}
    assert "24 cell(s) verified, 0 skipped" in capsys.readouterr().out
