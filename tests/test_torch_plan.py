"""The port's planner (``repro_torch.plan``) against the JAX package's
(``repro.plan``), and its executor, plan cache, calibration store and
measured policy on the CPU; FFT and Winograd against the JAX package.

Every test points both packages' plan-cache directories and calibration
files at its own ``tmp_path`` (the calibration file does not exist, so
analytic picks see the paper's constants unless a test fits one).  Plans
are compared field for field through their JSON; picks, solutions and
fits exactly; convolutions as scale-normalized max errors against the
JAX package (2 x the contract's forward tolerance, each side being held
to it on its own) and against an f64 oracle (the contract's tolerance).
FFT and Winograd in bf16 and f16 are held to the contract's error budget
only: the JAX package's cast-count checks of those paths fail in this
container (fault F3), so only the budget is a claim here.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                              # noqa: E402

import repro.plan as jplan                           # noqa: E402
from repro.bench.scenarios import CV_LAYERS          # noqa: E402
from repro.core import conv2d as j_conv2d            # noqa: E402
from repro.core.convspec import ConvSpec as JSpec    # noqa: E402

import repro_torch.plan as plan_mod                  # noqa: E402
from repro_torch.bench import harness                # noqa: E402
from repro_torch.core import conv2d, conv2d_spec     # noqa: E402
from repro_torch.core.conv_api import apply_padding  # noqa: E402
from repro_torch.core.convspec import ConvSpec       # noqa: E402
from repro_torch.core.numerics import fwd_tolerance  # noqa: E402
from repro_torch.kernels import mec_conv as K, ops   # noqa: E402
from repro_torch.kernels.ref import conv2d_f64, scaled_error  # noqa: E402
from repro_torch.plan import cache as cache_mod      # noqa: E402
from repro_torch.plan import calibrate               # noqa: E402
from repro_torch.plan import convplan                # noqa: E402
from repro_torch.plan.convplan import ConvPlan, plan_conv2d  # noqa: E402

ALGOS = ("direct", "im2col", "fft", "winograd", "mec", "mec_lowered",
         "mec_fused", "mec_fused2")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}
# (n, ih, iw, ic, kh, kw, kc, stride): a 3x3 stride-1 conv (every
# algorithm), and odd sizes at strides 2 and (2, 3)
GEOMS = {"k3s1": (2, 10, 11, 3, 3, 3, 5, 1),
         "k3s2": (2, 11, 13, 3, 3, 3, 5, 2),
         "k4x3s23": (2, 11, 13, 3, 4, 3, 5, (2, 3))}


@pytest.fixture(autouse=True)
def plan_env(tmp_path, monkeypatch):
    """Both packages' plan caches and calibrations under tmp_path."""
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


def _spec(n, ih, iw, ic, kh, kw, kc, stride):
    s_h, s_w = (stride, stride) if isinstance(stride, int) else stride
    return ConvSpec(n, ih, iw, ic, kh, kw, kc, s_h, s_w)


def _jspec(spec: ConvSpec) -> JSpec:
    return JSpec(**dataclasses.asdict(spec))


def _operands(geom, dtype="float32", seed=0):
    n, ih, iw, ic, kh, kw, kc, _ = geom
    rng = np.random.RandomState(seed)
    x = rng.randn(n, ih, iw, ic).astype(np.float32)
    k = (rng.randn(kh, kw, ic, kc) * (kh * kw * ic) ** -0.5).astype(np.float32)
    jd, td = DTYPES[dtype]
    return (jnp.asarray(x, jd), jnp.asarray(k, jd),
            torch.from_numpy(x).to(td), torch.from_numpy(k).to(td))


def _plan_for(spec, algorithm, backend="cpu", dtype="float32", **kw):
    return ConvPlan(spec=spec, dtype=dtype, algorithm=algorithm,
                    solution=kw.pop("solution", "auto"),
                    w_blk=convplan._kernel_w_blk(spec, algorithm),
                    backend=backend, **kw)


# ---------------------------------------------------------------------------
# plans: JSON, analytic picks, the measured rule, calibration fits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["cpu", "cuda"])
@pytest.mark.parametrize("algorithm", ALGOS)
def test_port_plan_loads_in_the_reference(algorithm, backend):
    spec = ConvSpec(16, 14, 14, 256, 3, 3, 256, 1, 1)
    plan = _plan_for(spec, algorithm, backend, precision="HIGHEST",
                     solution="B" if algorithm == "mec" else "auto",
                     mode="measured")
    loaded = jplan.ConvPlan.from_json(plan.to_json())
    assert loaded.to_json() == plan.to_json()
    assert ConvPlan.from_json(loaded.to_json()) == plan


@pytest.mark.parametrize("name", list(CV_LAYERS))
def test_reference_plan_loads_in_the_port(name):
    ih, iw, ic, kh, kw, kc, s = CV_LAYERS[name]
    jspec = JSpec(1, ih, iw, ic, kh, kw, kc, s, s)
    jp = jplan.plan_conv2d(jspec, dtype="bfloat16", backend="cpu")
    plan = ConvPlan.from_json(jp.to_json())
    assert plan.to_dict() == jp.to_dict()
    assert plan.spec == ConvSpec(1, ih, iw, ic, kh, kw, kc, s, s)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CV_LAYERS) + ["k1x1"])
def test_analytic_plan_matches_the_reference_on_cpu(name, dtype):
    """The Table-2 layers (and a 1x1 conv) at batch 1: the port's analytic
    CPU plan is the JAX package's, field for field."""
    geom = CV_LAYERS.get(name, (8, 8, 4, 1, 1, 4, 1))
    ih, iw, ic, kh, kw, kc, s = geom
    spec = ConvSpec(1, ih, iw, ic, kh, kw, kc, s, s)
    plan = plan_conv2d(spec, dtype=dtype, backend="cpu")
    jp = jplan.plan_conv2d(_jspec(spec), dtype=dtype, backend="cpu")
    assert plan.to_dict() == jp.to_dict()
    assert plan.algorithm in ("mec", "direct")


def test_analytic_plan_on_cuda_is_the_fused_kernel():
    """On CUDA the analytic plan is K1 with the launcher's own block,
    whatever a calibration says; 1x1 convs stay direct."""
    for name in ("cv4", "cv9", "cv10", "cv11", "cv12"):
        ih, iw, ic, kh, kw, kc, s = CV_LAYERS[name]
        spec = ConvSpec(16, ih, iw, ic, kh, kw, kc, s, s)
        plan = plan_conv2d(spec, backend="cuda")
        assert (plan.algorithm, plan.backend) == ("mec_fused", "cuda")
        assert plan.w_blk == ops.pick_fused_w_blk(spec.o_w, kc, 16, spec.o_h)
        calib = calibrate.Calibration.for_current_env("cuda")
        calib.add_time(spec, "float32", "mec_fused2", 1.0)
        calib.add_time(spec, "float32", "mec_fused", 100.0)
        assert plan_conv2d(spec, backend="cuda",
                           calibration=calib).algorithm == "mec_fused"
    assert plan_conv2d(ConvSpec(1, 8, 8, 4, 1, 1, 4)).algorithm == "direct"


PICK_CASES = {
    "analytic_fastest": ({"mec": 10.0, "direct": 12.0}, "mec", None, 0.05),
    "within_margin": ({"mec": 10.4, "direct": 10.0}, "mec", None, 0.05),
    "beyond_margin": ({"mec": 10.6, "direct": 10.0}, "mec", None, 0.05),
    "analytic_untimed": ({"fft": 3.0, "direct": 2.0}, "mec", None, 0.05),
    "spread_widens": ({"mec": 13.0, "direct": 10.0}, "mec",
                      {"mec": 0.4, "direct": 0.01}, 0.05),
    "spread_capped": ({"mec": 250.0, "direct": 100.0}, "mec",
                      {"direct": 7.0}, 0.05),
    "spread_below_floor": ({"mec": 10.6, "direct": 10.0}, "mec",
                           {"mec": 0.01}, 0.05),
    "custom_margin": ({"mec_fused": 1.2, "mec_fused2": 1.0}, "mec_fused",
                      None, 0.25),
}


@pytest.mark.parametrize("case", list(PICK_CASES))
def test_pick_measured_matches_the_reference(case):
    times, analytic, spreads, margin = PICK_CASES[case]
    assert plan_mod.pick_measured(times, analytic, margin, spreads) == \
        jplan.pick_measured(times, analytic, margin, spreads)


def _samples(seed):
    """(spec, dtype, algorithm, solution, w_blk, us) time samples and
    (spec, dtype, algorithm, ratio) memory samples on small specs."""
    rng = np.random.RandomState(seed)
    specs = [(2, 12, 12, 4, 3, 3, 8, 1), (1, 20, 20, 8, 5, 5, 8, 2),
             (4, 9, 9, 3, 3, 3, 6, 1), (2, 16, 16, 8, 1, 1, 8, 1)]
    times, mems = [], []
    for i, geom in enumerate(specs):
        for alg in ("mec", "direct", "im2col", "fft", "mec_fused"):
            for _ in range(3):
                times.append((geom, "float32", alg,
                              "A" if alg == "mec" else "auto",
                              None if alg != "mec_fused" else 8,
                              float(rng.uniform(5, 50) * (1 + i))))
        mems.append((geom, "float32", "mec", float(rng.uniform(1.0, 1.5))))
        mems.append((geom, "float32", "im2col", 1.0))
    return times, mems


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_calibration_fit_matches_the_reference(seed):
    """Identical samples give the same decisions, cells, ratios and time
    constants in both packages (on the CPU backend)."""
    times, mems = _samples(seed)
    ours = calibrate.Calibration.for_current_env("cpu")
    theirs = jplan.Calibration(backend="cpu", device_kind="cpu",
                               fingerprint="x")
    for geom, dtype, alg, sol, blk, us in times:
        ours.add_time(_spec(*geom), dtype, alg, us, solution=sol, w_blk=blk)
        theirs.add_time(_jspec(_spec(*geom)), dtype, alg, us, solution=sol,
                        w_blk=blk)
    for geom, dtype, alg, ratio in mems:
        ours.add_memory(_spec(*geom), dtype, alg, ratio)
        theirs.add_memory(_jspec(_spec(*geom)), dtype, alg, ratio)
    fit, jfit = ours.fit(), theirs.fit()
    assert fit["decisions"] == jfit["decisions"]
    assert fit["time_cells"] == jfit["time_cells"]
    assert fit["mem_ratio"] == jfit["mem_ratio"]
    assert fit["time_constants"].keys() == jfit["time_constants"].keys()
    for alg, c in fit["time_constants"].items():
        assert c == pytest.approx(jfit["time_constants"][alg], rel=1e-6,
                                  abs=1e-9)
    spec = _spec(*times[0][0])
    for alg in ("mec", "direct", "fft"):
        assert ours.time_estimate(spec, alg) == pytest.approx(
            theirs.time_estimate(_jspec(spec), alg), rel=1e-6)
    # and the round trip through the file format
    # and the round trip through the file format (which sorts the samples,
    # so least squares sees its rows in another order)
    again = calibrate.Calibration.from_dict(json.loads(json.dumps(ours.to_dict())))
    refit = again.fit()
    assert {k: refit[k] for k in ("decisions", "time_cells", "mem_ratio")} == \
        {k: fit[k] for k in ("decisions", "time_cells", "mem_ratio")}
    for alg, c in fit["time_constants"].items():
        assert refit["time_constants"][alg] == pytest.approx(c, rel=1e-6)


def test_calibrated_cpu_pick_defers_to_cell_evidence():
    """On the CPU a cell whose evidence covers the analytic pick and a
    rival flips through the noise margin, in both packages alike; a
    calibration of the other backend is ignored."""
    spec = ConvSpec(2, 12, 12, 4, 3, 3, 8, 1, 1)
    calib = calibrate.Calibration.for_current_env("cpu")
    calib.add_time(spec, "float32", "mec", 30.0)
    calib.add_time(spec, "float32", "direct", 10.0)
    jcal = jplan.Calibration(backend="cpu", device_kind="cpu", fingerprint="x")
    jcal.add_time(_jspec(spec), "float32", "mec", 30.0)
    jcal.add_time(_jspec(spec), "float32", "direct", 10.0)
    from repro.launch.costmodel import pick_conv2d_algorithm as j_pick
    from repro_torch.launch.costmodel import pick_conv2d_algorithm
    assert pick_conv2d_algorithm(spec, "cpu", calibration=None) == "mec"
    assert pick_conv2d_algorithm(spec, "cpu", calibration=calib) == \
        j_pick(_jspec(spec), "cpu", calibration=jcal) == "direct"
    calib.backend = "cuda"
    assert pick_conv2d_algorithm(spec, "cpu", calibration=calib) == "mec"


def test_ambient_calibration_reads_the_env_file(plan_env, monkeypatch):
    spec = ConvSpec(2, 12, 12, 4, 3, 3, 8, 1, 1)
    calib = calibrate.Calibration.for_current_env("cpu")
    calib.add_time(spec, "float32", "mec", 30.0)
    calib.add_time(spec, "float32", "direct", 10.0)
    path = plan_env / "calibration.json"
    path.write_text(json.dumps(calib.to_dict()))
    monkeypatch.setenv(calibrate.CALIBRATION_ENV, str(path))
    assert plan_conv2d(spec, backend="cpu").algorithm == "direct"
    assert plan_conv2d(spec, backend="cpu",
                       calibration=None).algorithm == "mec"
    info = calibrate.calibration_info("cpu")
    assert info["active"] and info["cells"] == 1
    assert calibrate.current_calibration("cuda") is None
    path.write_text("{ not json")
    assert calibrate.current_calibration("cpu") is None


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------

def _kwargs_and_plan_cases():
    for gname, geom in GEOMS.items():
        for alg in ALGOS:
            if alg == "winograd" and gname != "k3s1":
                continue
            for padding in ("VALID", "SAME"):
                yield gname, alg, padding


@pytest.mark.parametrize("gname,algorithm,padding",
                         list(_kwargs_and_plan_cases()))
def test_conv2d_plan_is_bit_identical_to_the_kwargs_path(gname, algorithm,
                                                         padding):
    geom = GEOMS[gname]
    _, _, tx, tk = _operands(geom, seed=3)
    stride = geom[7]
    spec = conv2d_spec(tx, tk, stride=stride, padding=padding)
    solution = "B" if algorithm == "mec" else "auto"
    plan = _plan_for(spec, algorithm, solution=solution)
    want = conv2d(tx, tk, stride=stride, padding=padding,
                  algorithm=algorithm, solution=solution)
    # the plan's decision wins over contrary kwargs
    got = conv2d(tx, tk, stride=stride, padding=padding, plan=plan,
                 algorithm="direct" if algorithm != "direct" else "mec")
    assert torch.equal(got, want)


def test_conv2d_plan_w_blk_reaches_the_launcher(monkeypatch):
    """The plan's w_blk is what the launcher is given (K1 and K4 on the
    CPU ignore it; the wrapper sees it)."""
    seen = []
    real = ops.mec_conv2d_cuda

    def spy(inp, kernel, stride=1, mode="fused", w_blk=None):
        seen.append((mode, w_blk))
        return real(inp, kernel, stride, mode, w_blk)

    monkeypatch.setattr(ops, "mec_conv2d_cuda", spy)
    _, _, tx, tk = _operands(GEOMS["k3s1"])
    spec = conv2d_spec(tx, tk)
    for alg in ("mec_fused", "mec_fused2", "mec_lowered"):
        plan = dataclasses.replace(_plan_for(spec, alg), w_blk=3)
        conv2d(tx, tk, plan=plan)
    conv2d(tx, tk, algorithm="mec_fused")
    assert seen == [("fused", 3), ("fused2", 3), ("lowered", 3),
                    ("fused", None)]


def test_plan_on_the_wrong_call_raises():
    _, _, tx, tk = _operands(GEOMS["k3s2"])
    spec = conv2d_spec(tx, tk, stride=2)
    plan = _plan_for(spec, "mec_fused")
    assert conv2d(tx, tk, stride=2, plan=plan).shape == spec.out_shape
    with pytest.raises(ValueError, match="geometry mismatch"):
        conv2d(tx, tk, stride=1, plan=plan)
    with pytest.raises(ValueError, match="geometry mismatch"):
        conv2d(tx, tk, stride=2, padding="SAME", plan=plan)
    with pytest.raises(ValueError, match="dtype mismatch"):
        conv2d(tx.bfloat16(), tk, stride=2, plan=plan)
    with pytest.raises(ValueError, match="backend mismatch"):
        conv2d(tx, tk, stride=2, plan=dataclasses.replace(plan, backend="cuda"))
    with pytest.raises(ValueError, match="kernel on"):
        conv2d(tx, tk.to("meta"), stride=2, plan=plan)
    with pytest.raises(TypeError, match="ConvPlan"):
        conv2d(tx, tk, plan=plan.to_dict())


def test_plan_rejects_what_the_port_does_not_run():
    spec = ConvSpec(1, 8, 8, 2, 3, 3, 4)
    with pytest.raises(ValueError, match="resolved algorithm"):
        ConvPlan(spec=spec, dtype="float32", algorithm="auto")
    with pytest.raises(ValueError, match="solution"):
        ConvPlan(spec=spec, dtype="float32", algorithm="mec", solution="C")
    with pytest.raises(ValueError, match="precision"):
        ConvPlan(spec=spec, dtype="float32", algorithm="mec", precision="LOW")
    # A partitioned plan is a value (normalised, serialised as the JAX
    # package's); planning a partition with no installed mesh raises.
    part = ConvPlan(spec=spec, dtype="float32", algorithm="mec",
                    partition="batch+spatial",
                    partition_axes=["data", "model"])
    assert (part.partition, part.partition_axes) == \
        (("batch", "spatial"), ("data", "model"))
    assert ConvPlan.from_json(part.to_json()) == part
    with pytest.raises(ValueError, match="axis"):
        ConvPlan(spec=spec, dtype="float32", algorithm="mec",
                 partition=("batch",), partition_axes=("data", "model"))
    with pytest.raises(ValueError, match="installed mesh"):
        plan_conv2d(spec, backend="cpu", partition="batch")
    with pytest.raises(ValueError, match="plan mode"):
        plan_conv2d(spec, mode="fastest")
    with pytest.raises(ValueError, match="backend"):
        plan_conv2d(spec, backend="tpu")
    with pytest.raises(ValueError, match="plan_version"):
        ConvPlan.from_dict({**_plan_for(spec, "mec").to_dict(),
                            "plan_version": 2})
    assert plan_conv2d(spec, backend="cpu", precision="highest").precision \
        == "HIGHEST"
    assert "<- plan" in _plan_for(spec, "mec_fused").explain()


def test_conv2d_auto_equals_its_cached_plan():
    _, _, tx, tk = _operands(GEOMS["k3s2"], seed=5)
    spec = conv2d_spec(tx, tk, stride=2, padding="SAME")
    y = conv2d(tx, tk, stride=2, padding="SAME")
    hit = plan_mod.global_plan_cache().get(
        convplan.plan_cache_key(spec, "float32", "cpu"))
    assert hit is not None and hit == plan_conv2d(spec, backend="cpu")
    assert torch.equal(y, conv2d(tx, tk, stride=2, padding="SAME", plan=hit))


# ---------------------------------------------------------------------------
# the plan cache
# ---------------------------------------------------------------------------

def test_cached_mode_hits_are_deterministic(monkeypatch):
    spec = ConvSpec(2, 12, 12, 4, 3, 3, 8)
    first = plan_conv2d(spec, mode="cached", backend="cpu")
    calls = []
    real = convplan.plan_conv2d

    def counting(*a, **kw):
        calls.append(kw.get("mode"))
        return real(*a, **kw)

    monkeypatch.setattr(convplan, "plan_conv2d", counting)
    for _ in range(3):
        assert real(spec, mode="cached", backend="cpu") is first
    assert calls == []           # no recompute on a hit
    assert first.mode == "analytic" and first.algorithm == "mec"


def test_plan_cache_survives_a_fresh_cache_on_disk():
    spec = ConvSpec(2, 12, 12, 4, 3, 3, 8)
    plan = plan_conv2d(spec, mode="cached", backend="cuda")
    path = plan_mod.global_plan_cache().path()
    assert path.is_file() and path.parent == cache_mod.plan_cache_dir()
    fresh = plan_mod.PlanCache()
    assert fresh.get(plan.cache_key()) == plan
    assert fresh.io_errors == 0
    doc = json.loads(path.read_text())
    assert doc["plans"][plan.cache_key()] == plan.to_dict()
    # the two packages keep their own files
    assert not (plan_mod.plan_cache_dir() == jplan.plan_cache_dir())


def test_plan_cache_lru_and_corruption(tmp_path):
    path = tmp_path / "plans.json"
    cache = plan_mod.PlanCache(path, max_entries=2)
    plans = [_plan_for(ConvSpec(1, 8 + i, 8, 2, 3, 3, 4), "mec")
             for i in range(3)]
    for p in plans:
        cache.put(p.cache_key(), p)
    assert len(cache) == 2 and cache.get(plans[0].cache_key()) is None
    assert plan_mod.PlanCache(path).get(plans[2].cache_key()) == plans[2]
    path.write_text("{ not json")
    broken = plan_mod.PlanCache(path)
    assert broken.get(plans[2].cache_key()) is None and broken.io_errors == 1
    broken.put(plans[1].cache_key(), plans[1])       # rewrites a good file
    assert plan_mod.PlanCache(path).get(plans[1].cache_key()) == plans[1]
    # a stale entry never poisons the rest
    doc = json.loads(path.read_text())
    doc["plans"]["bad"] = {"plan_version": 1, "spec": {}, "dtype": "float32",
                           "algorithm": "nope"}
    path.write_text(json.dumps(doc))
    assert plan_mod.PlanCache(path).get(plans[1].cache_key()) == plans[1]
    unwritable = plan_mod.PlanCache(tmp_path / "plans.json" / "x.json")
    unwritable.put(plans[0].cache_key(), plans[0])
    assert unwritable.io_errors >= 1
    assert unwritable.get(plans[0].cache_key()) == plans[0]


def test_cached_mode_never_serves_a_conflicting_hit():
    spec = ConvSpec(2, 12, 12, 4, 3, 3, 8)
    plain = plan_conv2d(spec, mode="cached", backend="cpu")
    highest = plan_conv2d(spec, mode="cached", backend="cpu",
                          precision="HIGHEST")
    assert (plain.precision, highest.precision) == (None, "HIGHEST")
    key = plain.cache_key()
    assert plan_mod.global_plan_cache().get(key) == highest  # latest wins
    assert plan_conv2d(spec, mode="cached", backend="cpu") == plain


def test_a_changed_block_pick_invalidates_a_hit(monkeypatch):
    spec = ConvSpec(16, 14, 14, 256, 3, 3, 256)
    first = plan_conv2d(spec, mode="cached", backend="cuda")
    assert first.algorithm == "mec_fused"
    monkeypatch.setattr(ops, "pick_fused_w_blk",
                        lambda o_w, k_c, i_n, o_h: 5)
    again = plan_conv2d(spec, mode="cached", backend="cuda")
    assert again.w_blk == 5 != first.w_blk
    assert plan_mod.global_plan_cache().get(first.cache_key()) == again


# ---------------------------------------------------------------------------
# the measured policy, on the CPU
# ---------------------------------------------------------------------------

def test_measured_mode_times_a_winner_and_feeds_the_store():
    spec = ConvSpec(1, 8, 8, 2, 3, 3, 4)
    plan, detail = convplan.tune_measured(spec, backend="cpu", iters=2)
    assert plan.mode == "measured" and plan.backend == "cpu"
    assert set(detail["candidate_us"]) == set(ALGOS)
    assert detail["skipped"] == {}
    assert detail["analytic_algorithm"] == "mec"
    assert plan.algorithm == plan_mod.pick_measured(
        detail["candidate_us"], "mec", spreads={
            a: s["us_rel_spread"] for a, s in detail["candidate_stats"].items()})
    assert all(s["iters"] == 2 for s in detail["candidate_stats"].values())
    if plan.algorithm in ("mec",) + convplan._KERNEL_ALGOS:
        assert detail["tuning"]["algorithm"] == plan.algorithm
    stored = calibrate.CalibrationStore(backend="cpu").load()
    assert set(stored.cell_times(spec)) >= set(ALGOS)
    assert calibrate.CalibrationStore(backend="cuda").load().is_empty()
    measured = plan_conv2d(spec, mode="measured", backend="cpu", iters=2)
    assert measured.mode == "measured"


def test_measured_skips_are_counted_not_dropped():
    """A candidate that raises lands in ``skipped`` with its reason."""
    spec = ConvSpec(1, 9, 9, 2, 5, 5, 4)
    with pytest.warns(UserWarning, match="skips winograd"):
        mc = plan_mod.measure_candidates_detailed(
            spec, candidates=("winograd", "direct", "mec_fused"),
            backend="cpu", iters=1, record=False)
    assert set(mc.times) == {"direct", "mec_fused"}
    assert "requires a 3x3 kernel" in mc.skipped["winograd"]
    assert plan_mod.measure_candidates(spec, candidates=("direct",),
                                       backend="cpu", iters=1,
                                       record=False).keys() == {"direct"}
    with pytest.raises(ValueError, match="no timeable candidate"):
        with pytest.warns(UserWarning):
            convplan.tune_measured(spec, backend="cpu",
                                   candidates=("winograd",), iters=1)


@pytest.mark.parametrize("algorithm", ["mec", "mec_fused2", "mec_lowered"])
def test_stage2_grids_the_winners_knob(algorithm):
    spec = ConvSpec(1, 12, 40, 2, 3, 3, 4)
    knob, plans = convplan._stage2_trials(spec, "float32", algorithm, None,
                                          "cpu")
    if algorithm == "mec":
        assert knob == "solution" and set(plans) == {"A", "B"}
    else:
        default = convplan._kernel_w_blk(spec, algorithm)
        assert knob == "w_blk" and str(default) in plans
        assert all(1 <= p.w_blk <= spec.o_w for p in plans.values())
    plan, detail = convplan.tune_measured(spec, backend="cpu", iters=1,
                                          candidates=(algorithm,))
    assert plan.algorithm == algorithm
    assert detail["tuning"]["knob"] == knob
    assert detail["tuning"]["picked"] in plans


def test_launcher_check_gates_only_cuda_kernel_plans(monkeypatch):
    """The gate is the static launch check (``analysis.launch_check``): it
    passes a geometry the launcher takes and every non-kernel plan, and
    refuses, with the check's reason, a kernel plan the launcher would
    refuse, on either backend and with no card."""
    spec = ConvSpec(1, 8, 8, 2, 3, 3, 4)
    refused = ConvSpec(1, 40, 160, 32, 33, 33, 8)  # no ring fits the opt-in
    assert convplan.launcher_check(_plan_for(spec, "mec_fused")) is None
    assert convplan.launcher_check(_plan_for(spec, "direct", "cuda")) is None
    assert convplan.launcher_check(_plan_for(refused, "direct", "cuda")) \
        is None
    for backend in ("cpu", "cuda"):
        for alg in convplan._KERNEL_ALGOS:
            assert convplan.launcher_check(_plan_for(spec, alg, backend)) \
                is None
            reason = convplan.launcher_check(_plan_for(refused, alg, backend))
            assert reason.startswith("launch_check: ") and \
                "smem-budget-overrun" in reason
            with pytest.raises(ValueError, match="launch check"):
                convplan.assert_plan(_plan_for(refused, alg, backend))


def _build_failure(*a, **kw):
    raise RuntimeError("CUDA kernel build failed:\nnvcc: exit 1")


@pytest.mark.parametrize("algorithm", convplan._KERNEL_ALGOS)
def test_launcher_check_raises_on_a_build_failure(monkeypatch, algorithm):
    """The gate builds nothing and loads nothing: a kernel library that
    would fail to build does not reach it (the executor's first launch
    raises instead, ``test_measured_race_raises_when_a_kernel_fails``)."""
    spec = ConvSpec(1, 8, 8, 2, 3, 3, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(K, "_lib", _build_failure)
    assert convplan.launcher_check(_plan_for(spec, algorithm, "cuda")) is None
    with pytest.raises(RuntimeError, match="build failed"):
        K._lib()


# the wrapper each kernel path reaches first, by the name ops calls it by
_FIRST_WRAPPER = {"mec_fused": "mec_conv_fused",
                  "mec_fused2": "mec_conv_fused2", "mec_lowered": "mec_lower"}


@pytest.mark.parametrize("stage", [1, 2])
@pytest.mark.parametrize("algorithm", convplan._KERNEL_ALGOS)
def test_measured_race_raises_when_a_kernel_fails(monkeypatch, algorithm,
                                                  stage):
    """A kernel candidate that fails to build or launch stops the race
    (stage 1) or its block grid (stage 2) with the failure: the measured
    policy never moves off a broken kernel onto another algorithm."""
    spec = ConvSpec(1, 12, 40, 2, 3, 3, 4)
    default = convplan._kernel_w_blk(spec, algorithm)
    if stage == 1:
        monkeypatch.setattr(ops, _FIRST_WRAPPER[algorithm], _build_failure)
        with pytest.raises(RuntimeError, match="build failed"):
            plan_mod.measure_candidates_detailed(
                spec, candidates=("direct", algorithm), backend="cpu",
                iters=1, record=False)
    else:
        time_trial = convplan._time_trial

        def fail_off_default(trial, *a, **kw):
            if trial.w_blk != default:
                _build_failure()
            return time_trial(trial, *a, **kw)

        monkeypatch.setattr(convplan, "_time_trial", fail_off_default)
        with pytest.raises(RuntimeError, match="build failed"):
            convplan.tune_measured(spec, backend="cpu", iters=1,
                                   candidates=(algorithm,), record=False)


def test_harness_draws_the_references_arrays():
    from repro.bench.harness import make_arrays as j_make_arrays
    spec = ConvSpec(2, 5, 6, 3, 3, 2, 4)
    jx, jk = j_make_arrays(_jspec(spec), "bfloat16", seed=4)
    tx, tk = harness.make_arrays(spec, "bfloat16", seed=4, device="cpu")
    assert tx.dtype == torch.bfloat16 and tuple(tk.shape) == (3, 2, 3, 4)
    assert np.array_equal(np.asarray(jx, np.float32), tx.float().numpy())
    assert np.array_equal(np.asarray(jk, np.float32), tk.float().numpy())
    stats = harness.time_compiled(lambda: tx + 1, iters=4, warmup=2)
    assert set(stats) == {"iters", "warmup", "us_median", "us_min", "us_mean",
                          "us_std", "us_rel_spread"}
    assert stats["iters"] == 4 and stats["us_min"] <= stats["us_median"]


# ---------------------------------------------------------------------------
# FFT and Winograd against the JAX package
# ---------------------------------------------------------------------------

def _fft_winograd_cases():
    for dtype in DTYPES:
        for gname in GEOMS:
            yield "fft", dtype, gname
        yield "winograd", dtype, "k3s1"
    yield "winograd", "float32", "k3s1_wide"


@pytest.mark.parametrize("algorithm,dtype,gname", list(_fft_winograd_cases()))
def test_fft_and_winograd_match_the_reference(algorithm, dtype, gname):
    geom = GEOMS.get(gname, (3, 15, 17, 8, 3, 3, 16, 1))
    jx, jk, tx, tk = _operands(geom, dtype, seed=7)
    stride = geom[7]
    for padding in ("VALID", "SAME"):
        j_out = j_conv2d(jx, jk, stride=stride, padding=padding,
                         algorithm=algorithm)
        t_out = conv2d(tx, tk, stride=stride, padding=padding,
                       algorithm=algorithm)
        assert t_out.dtype == tx.dtype and tuple(t_out.shape) == j_out.shape
        red = geom[4] * geom[5] * geom[3]
        tol = fwd_tolerance(algorithm, dtype, red)
        s = (stride, stride) if isinstance(stride, int) else stride
        oracle = conv2d_f64(apply_padding(tx, geom[4], geom[5], *s, padding),
                            tk, stride)
        assert scaled_error(t_out, oracle) <= tol
        ref = torch.from_numpy(np.array(j_out.astype(jnp.float32)))
        assert scaled_error(t_out, ref) <= 2 * tol


def test_winograd_refuses_what_it_does_not_compute():
    _, _, tx, tk = _operands(GEOMS["k4x3s23"])
    with pytest.raises(ValueError, match="requires a 3x3 kernel and stride 1"):
        conv2d(tx, tk, algorithm="winograd")
    _, _, tx, tk = _operands(GEOMS["k3s2"])
    with pytest.raises(ValueError, match="requires a 3x3 kernel and stride 1"):
        conv2d(tx, tk, stride=2, algorithm="winograd")
    from repro_torch.core.winograd import winograd_conv2d
    with pytest.raises(ValueError, match="requires a 3x3 kernel"):
        winograd_conv2d(torch.zeros(1, 6, 6, 2), torch.zeros(2, 2, 2, 3))
    assert "winograd" not in plan_mod.eligible_candidates(
        ConvSpec(1, 8, 8, 2, 3, 3, 4, 2, 2))
    assert plan_mod.eligible_candidates(ConvSpec(1, 8, 8, 2, 3, 3, 4)) == ALGOS
