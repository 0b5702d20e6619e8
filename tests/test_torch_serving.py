"""The port's plan-driven conv serving (``repro_torch.serving``), the
bench ``serve`` suite, the whisper frontend example and the audio family
(whisper) of ``models.lm`` / ``models.serve`` against the JAX package, on
the CPU.

One counterpart of each test of ``tests/test_conv_service.py`` but the
scheduler's (the scheduler is ported with the dense and vlm families):
the same numpy inputs and kernels go through ``repro.serving`` and
``repro_torch.serving``.  Tolerances, as scale-normalised max errors
(max|port - jax| / max|jax|): a served conv within 2 x the f32 forward
contract (``numerics.fwd_tolerance``) of the JAX package's, each side
being held to the contract on its own; a frontend (two convs and the tanh
GELU) within 2 x the contract of its wider layer; whisper-tiny's smoke
prefill logits and caches and four decode steps within 1e-4 in f32
(``tests/test_torch_serve.py`` ``SLICE_TOL``).  The bench ``serve``
document equals ``benchmarks/baselines/serve.json`` on every exact field
(``bench.check``).  Plan caches and calibrations live under the test's
``tmp_path`` (the autouse ``plan_env`` fixture, both packages' variables).
"""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

import repro.plan as jplan                                   # noqa: E402
from repro.bench import report as jreport                    # noqa: E402
from repro.configs import archs as jarchs                    # noqa: E402
from repro.core import conv2d as jconv2d                     # noqa: E402
from repro.models import serve as jserve                     # noqa: E402
from repro.models.lm import LM as JLM                        # noqa: E402
from repro.models.lm import gelu_mlp as j_gelu_mlp           # noqa: E402
from repro.serving import conv_service as J                  # noqa: E402
from repro.serving.__main__ import main as j_cli             # noqa: E402

import repro_torch.plan as plan_mod                          # noqa: E402
from repro_torch.bench import __main__ as bench_cli          # noqa: E402
from repro_torch.bench import check, harness, report         # noqa: E402
from repro_torch.configs import archs as tarchs              # noqa: E402
from repro_torch.convert import params_from_jax              # noqa: E402
from repro_torch.core import conv2d as tconv2d               # noqa: E402
from repro_torch.core.numerics import fwd_tolerance          # noqa: E402
from repro_torch.examples import whisper_frontend as example  # noqa: E402
from repro_torch.launch import serve as tlaunch              # noqa: E402
from repro_torch.models import lm as tlm                     # noqa: E402
from repro_torch.models import serve as tserve               # noqa: E402
from repro_torch.serving import conv_service as T            # noqa: E402
from repro_torch.serving.__main__ import main as t_cli       # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
SERVE_BASELINE = REPO / "benchmarks" / "baselines" / "serve.json"
SLICE_TOL = 1e-4
ARCH = "whisper-tiny"


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


def _err(port, ref) -> float:
    """max|port - ref| / max|ref|."""
    p = port.detach().to(torch.float64).numpy()
    r = np.asarray(ref, np.float64)
    assert p.shape == r.shape, (p.shape, r.shape)
    scale = np.abs(r).max()
    return float(np.abs(p - r).max() / (scale if scale > 0 else 1.0))


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype(np.float32)


def _pair(arr):
    return jnp.asarray(arr), torch.from_numpy(arr.copy())


def _kernel(k_h=3, k_w=3, i_c=4, k_c=8):
    return _pair(_rand((k_h, k_w, i_c, k_c), 0, (k_h * k_w * i_c) ** -0.5))


def _services(classes=((1, 12, 12), (2, 16, 16)), kernel=None, **kw):
    """The same service in both packages: (jax, port)."""
    kw.setdefault("stride", 2)
    kw.setdefault("padding", 1)
    kw.setdefault("plan_mode", "analytic")
    jk, tk = kernel or _kernel()
    return (J.ConvService(jk, classes=classes, **kw),
            T.ConvService(tk, classes=classes, **kw))


def _tags(classes):
    return [c.tag() for c in classes]


def _conv_tol(k):
    return 2 * fwd_tolerance("mec", "float32", k)


# ---------------------------------------------------------------- bucketing

def test_bucket_smallest_containing_class_wins():
    jsvc, tsvc = _services()
    assert _tags(tsvc.classes) == _tags(jsvc.classes)
    for shape, want in (((1, 9, 11), (1, 12, 12)), ((1, 12, 12), (1, 12, 12)),
                        ((1, 13, 5), (2, 16, 16)), ((2, 3, 3), (2, 16, 16)),
                        ((1, 9, 11, 4), (1, 12, 12))):
        assert tsvc.bucket(shape) == T.ShapeClass(*want)
        assert tsvc.bucket(shape).tag() == jsvc.bucket(shape).tag()


def test_bucket_deterministic_and_total():
    jsvc, tsvc = _services()
    for n in range(1, 3):
        for h in range(1, 17):
            for w in range(1, 17):
                cls = tsvc.bucket((n, h, w))
                assert cls.contains(n, h, w)
                assert cls.tag() == jsvc.bucket((n, h, w)).tag()
                assert tsvc.bucket((cls.n, cls.h, cls.w)) == cls
                for other in tsvc.classes:
                    if other < cls:
                        assert not other.contains(n, h, w)


@pytest.mark.parametrize("shape,match", [
    ((1, 17, 4), "fits no shape class"), ((3, 4, 4), "fits no shape class"),
    ((1, 0, 4), "non-positive"), ((1, 8, 8, 3), "channels"),
    ((1, 8), "not")])
def test_bucket_rejects_out_of_range_loudly(shape, match):
    jsvc, tsvc = _services()
    for svc in (jsvc, tsvc):
        with pytest.raises(ValueError, match=match):
            svc.bucket(shape)


def test_parse_shape_classes():
    got = T.parse_shape_classes("1x32x32,4x64x64")
    assert got == (T.ShapeClass(1, 32, 32), T.ShapeClass(4, 64, 64))
    assert _tags(got) == _tags(J.parse_shape_classes("1x32x32,4x64x64"))
    for text, match in (("1x32", "NxHxW"), (",", "no shape classes")):
        for parse in (J.parse_shape_classes, T.parse_shape_classes):
            with pytest.raises(ValueError, match=match):
                parse(text)


def test_duplicate_and_invalid_classes_rejected():
    for classes, match in ((((1, 12, 12), (1, 12, 12)), "duplicate"),
                           (((1, 0, 12),), "non-positive")):
        for make in (lambda: _services(classes=classes)[0],
                     lambda: _services(classes=classes)[1]):
            with pytest.raises(ValueError, match=match):
                make()


def test_same_padding_rejected():
    jk, tk = _kernel()
    for svc, k in ((J.ConvService, jk), (T.ConvService, tk)):
        with pytest.raises(ValueError, match="SAME"):
            svc(k, stride=2, padding="SAME", classes=((1, 12, 12),),
                plan_mode="analytic")


# ---------------------------------------------------------------- padding

def test_padding_never_shrinks_and_preserves_data():
    jsvc, tsvc = _services()
    jx, tx = _pair(_rand((1, 9, 11, 4), 1))
    cls = tsvc.bucket(tx.shape)
    padded = tsvc.pad_to_class(tx, cls)
    assert tuple(padded.shape) == (cls.n, cls.h, cls.w, 4)
    assert torch.equal(padded[:1, :9, :11], tx)
    assert float(padded[:, 9:].abs().sum()) == 0.0
    assert float(padded[:, :, 11:].abs().sum()) == 0.0
    ref = jsvc.pad_to_class(jx, jsvc.bucket(jx.shape))
    np.testing.assert_array_equal(padded.numpy(), np.asarray(ref))


# --------------------------------------------------------------- execution

def test_execute_matches_direct_conv_on_request():
    jsvc, tsvc = _services()
    jsvc.warm()
    tsvc.warm()
    for cls in tsvc.classes:
        jplan_ = jsvc.plans[J.ShapeClass(cls.n, cls.h, cls.w)]
        assert tsvc.plans[cls].algorithm == jplan_.algorithm
        assert tsvc.plans[cls].solution == jplan_.solution
        assert tsvc.plans[cls].spec.__dict__ == jplan_.spec.__dict__
    tol = _conv_tol(3 * 3 * 4)
    for i, shape in enumerate(((1, 9, 11, 4), (1, 12, 12, 4),
                               (2, 13, 16, 4))):
        jx, tx = _pair(_rand(shape, 2 + i))
        got = tsvc(tx)
        ref = jconv2d(jx, jsvc.kernel, stride=2, padding=1,
                      algorithm="direct")
        assert tuple(got.shape) == ref.shape == tsvc.request_out_shape(shape)
        assert tsvc.request_out_shape(shape) == jsvc.request_out_shape(shape)
        assert _err(got, ref) <= tol
        assert _err(got, jsvc(jx)) <= tol


def test_warm_vs_cold_bit_identical():
    jx, tx = _pair(_rand((1, 10, 13, 4), 3))
    _, warm = _services()
    warm.warm()
    assert len(warm.warmup.plans) == len(warm.classes)
    _, cold = _services()          # never warmed: lazy per-class resolve
    y_warm, y_cold = warm(tx), cold(tx)
    assert torch.equal(y_warm, y_cold)
    assert y_warm.numpy().tobytes() == y_cold.numpy().tobytes()
    jsvc, _ = _services()
    assert _err(y_warm, jsvc(jx)) <= _conv_tol(3 * 3 * 4)


def test_valid_padding_service():
    jk, tk = _kernel(4, 4, 3, 8)
    kw = dict(stride=4, padding="VALID", classes=[(1, 16, 16), (1, 32, 32)],
              plan_mode="analytic")
    jsvc, tsvc = J.ConvService(jk, **kw), T.ConvService(tk, **kw)
    jx, tx = _pair(_rand((1, 24, 20, 3), 4))
    got = tsvc(tx)
    ref = jconv2d(jx, jk, stride=4, padding="VALID", algorithm="direct")
    assert tuple(got.shape) == ref.shape
    assert _err(got, ref) <= _conv_tol(4 * 4 * 3)
    assert _err(got, jsvc(jx)) <= _conv_tol(4 * 4 * 3)


def test_fit_prefix_crops_and_pads():
    x = np.arange(24, dtype=np.float32).reshape(1, 6, 4)
    jx, tx = _pair(x)
    for length in (4, 6, 9):
        got = T.fit_prefix(tx, length)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(J.fit_prefix(jx, length)))
    assert float(T.fit_prefix(tx, 9)[:, 6:].abs().sum()) == 0.0


# ------------------------------------------------------- warmup degradation

def test_warmup_survives_cache_dir_that_is_a_file(tmp_path, monkeypatch):
    bogus = tmp_path / "not-a-dir"
    bogus.write_text("i am a file, not a cache directory")
    for prefix in ("REPRO", "REPRO_TORCH"):
        monkeypatch.setenv(f"{prefix}_PLAN_CACHE_DIR", str(bogus))
    plan_mod.reset_global_plan_cache()
    jplan.reset_global_plan_cache()
    jsvc, tsvc = _services(plan_mode="cached")
    reports = (jsvc.warm(), tsvc.warm())           # neither raises
    for svc, rep in zip((jsvc, tsvc), reports):
        assert len(rep.plans) == len(svc.classes)
        assert rep.plan_cache_io_errors >= 1
    jx, tx = _pair(_rand((1, 9, 11, 4), 5))
    ref = jconv2d(jx, jsvc.kernel, stride=2, padding=1, algorithm="direct")
    assert _err(tsvc(tx), ref) <= _conv_tol(3 * 3 * 4)


def test_warmup_survives_corrupt_cache_file():
    for mod in (plan_mod, jplan):
        corrupt = mod.global_plan_cache().path()
        corrupt.parent.mkdir(parents=True, exist_ok=True)
        corrupt.write_text("{ this is not json")
    jsvc, tsvc = _services(plan_mode="cached")
    for svc in (jsvc, tsvc):
        report = svc.warm()
        assert len(report.plans) == len(svc.classes)
        assert report.plan_cache_io_errors >= 1
        assert report.warning_count == 0


def test_warmup_report_renders_plan_table():
    jsvc, tsvc = _services()
    jtext, ttext = jsvc.warm().render(), tsvc.warm().render()
    for text in (jtext, ttext):
        assert "warmed 2/2 shape class(es)" in text
        for cls in tsvc.classes:
            assert f"-- class {cls.tag()} --" in text
        assert "ConvPlan[" in text
    assert "0 plan-cache I/O error(s)" in tsvc.warmup.summary()
    assert [ln for ln in ttext.splitlines() if ln.startswith("--")] == \
        [ln for ln in jtext.splitlines() if ln.startswith("--")]


@pytest.mark.parametrize("argv", [
    ["--kernel", "3x3x2x4", "--stride", "2", "--padding", "1",
     "--shape-classes", "1x8x8", "--plan-mode", "analytic"],
    ["--frontend", "whisper", "--shape-classes", "1x24x1,2x64x1",
     "--d-model", "16"]])
def test_warmup_report_cli(argv, capsys):
    assert j_cli(["--warmup-report"] + argv) == 0
    jout = capsys.readouterr().out
    assert t_cli(["--warmup-report", "--device", "cpu"] + argv) == 0
    tout = capsys.readouterr().out

    def headers(text):
        return [ln for ln in text.splitlines()
                if ln.startswith(("==", "--", "warmed"))
                and not ln.startswith("warmed")] + \
            [ln.split(" in ")[0] for ln in text.splitlines()
             if ln.startswith("warmed")]

    assert headers(tout) == headers(jout)
    assert "-- class" in tout


def test_cli_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        t_cli(["--warmup-report", "--shape-classes", "1x8x8"])


# -------------------------------------------------- the executor's buffers

def test_padding_region_is_zeroed_between_requests():
    """A larger request, then a smaller one in the same class: the second
    answer is the one a fresh service gives (the first request's data
    left in the static buffer is zeroed)."""
    _, tsvc = _services()
    tsvc.warm()
    big = torch.from_numpy(_rand((2, 16, 16, 4), 6))
    small = torch.from_numpy(_rand((1, 13, 9, 4), 7))
    assert tsvc.bucket(big.shape) == tsvc.bucket(small.shape)
    tsvc(big)
    _, fresh = _services()
    assert torch.equal(tsvc(small), fresh(small))
    cls = tsvc.bucket(small.shape)
    buf = tsvc._compiled[cls].static_in
    assert float(buf[1:].abs().sum()) == 0.0
    assert float(buf[:1, 13:].abs().sum()) == 0.0
    assert float(buf[:1, :13, 9:].abs().sum()) == 0.0


def test_answers_are_copies():
    _, tsvc = _services()
    tsvc.warm()
    x = torch.from_numpy(_rand((2, 16, 16, 4), 8))
    first = tsvc(x)
    kept = first.clone()
    tsvc(torch.from_numpy(_rand((2, 16, 16, 4), 9)))
    assert torch.equal(first, kept)
    assert first.is_contiguous()


def test_warmed_in_inference_mode_serves_outside_it():
    _, tsvc = _services(plan_mode="cached")
    with torch.inference_mode():
        tsvc.warm()
    assert tsvc.warmup.warning_count == 0
    x = torch.from_numpy(_rand((1, 9, 11, 4), 10))
    with torch.inference_mode():
        inside = tsvc(x)
    assert torch.equal(tsvc(x), inside)


# ------------------------------------------------------------ serve report

def test_committed_serve_baseline_is_valid():
    doc = json.loads(SERVE_BASELINE.read_text())
    assert report.validate_report(doc) == jreport.validate_report(doc) == []
    assert doc["suite"] == "serve"
    assert {r["serve_mode"] for r in doc["results"]} == \
        set(harness.SERVE_MODES)


def test_serve_record_schema_gates():
    rec = {
        "scenario": "x_c1x8x8", "algorithm": "warm", "dtype": "float32",
        "weight": 1,
        "spec": {k: 1 for k in report.SPEC_FIELDS},
        "run_spec": {k: 1 for k in report.SPEC_FIELDS},
        "overhead_elems": 0, "overhead_bytes": 0, "flops": 1.0,
        "run_flops": 1.0, "auto_algorithm": "direct", "out_shape": [1],
        "us_per_call": None, "timing": None, "hlo_flops": None,
        "hlo_bytes": None, "serve_mode": "warm",
    }
    env = {k: "x" for k in report.ENV_FIELDS + report.JAX_ENV_FIELDS}
    doc = {"schema_version": 1, "suite": "serve", "environment": env,
           "harness": {}, "results": [rec]}
    errs = report.validate_report(doc)
    assert any("serve cell missing" in e for e in errs)
    assert errs == jreport.validate_report(doc)
    rec.update(shape_class="1x8x8", n_classes=1, n_requests=4,
               warmup_warnings=0, plan_cache_io_errors=0)
    assert report.validate_report(doc) == jreport.validate_report(doc) == []


def test_run_serve_equals_the_baseline_on_exact_fields():
    doc = harness.run_serve(device="cpu")
    assert report.validate_report(doc) == []
    baseline = json.loads(SERVE_BASELINE.read_text())
    failures, _ = check.compare(doc, baseline, schema_only_on_timing=True)
    assert failures == []
    assert len(doc["results"]) == len(baseline["results"])
    for rec in doc["results"]:
        assert rec["warmup_warnings"] == rec["plan_cache_io_errors"] == 0
        assert rec["n_requests"] > 0 and rec["p50_us"] > 0
        assert rec["plan"]["backend"] == "cpu"


def test_bench_cli_serve_suite(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert bench_cli.main(["--suite", "serve", "--device", "cpu"]) == 0
    assert "[bench] serve: 18 records over 6 class cells" in \
        capsys.readouterr().out
    out = tmp_path / "BENCH_torch_serve.json"
    assert check.main([str(out), "--baseline", str(SERVE_BASELINE),
                       "--schema-only-on-timing"]) == 0


def test_serve_latencies_modes():
    _, tsvc = _services()
    reqs = [torch.from_numpy(_rand(s, 11 + i)) for i, s in
            enumerate(((1, 9, 11, 4), (2, 16, 16, 4), (1, 12, 12, 4)))]
    for mode in harness.SERVE_MODES:
        per_class, total = harness.serve_latencies(tsvc, reqs, mode)
        assert sum(len(v) for v in per_class.values()) == len(reqs)
        assert total > 0
    with pytest.raises(ValueError, match="serve mode"):
        harness.serve_latencies(tsvc, reqs, "hot")


# ------------------------------------------------------------- frontends

def _whisper_pair(n_mels=8, d_model=16, classes=((1, 12, 1), (1, 24, 1))):
    jfront, jsvcs = J.whisper_frontend_service(
        jax.random.key(6), n_mels=n_mels, d_model=d_model, classes=classes,
        plan_mode="analytic")
    kernels = [params_from_jax(np.asarray(s.kernel), device="cpu")
               for s in jsvcs]
    tfront, tsvcs = T.whisper_frontend_service(
        None, n_mels, d_model, classes, plan_mode="analytic", device="cpu",
        kernels=kernels)
    return (jfront, jsvcs), (tfront, tsvcs)


def test_whisper_frontend_service_shapes():
    (jfront, jsvcs), (tfront, tsvcs) = _whisper_pair()
    for t in (9, 12, 24):
        jmel, tmel = _pair(_rand((1, t, 8), 12 + t))
        out = tfront(tmel)
        assert tuple(out.shape) == (1, (t + 1) // 2, 16)
        assert tsvcs[0].bucket((1, t, 1)) in tsvcs[0].warmup.plans
        assert _err(out, jfront(jmel)) <= _conv_tol(3 * 16)


@pytest.mark.parametrize("t", [5, 12, 17, 24])
def test_whisper_frontend_matches_jax(t):
    """The JAX frontend's kernels carried across: each layer's answer and
    the frames within 2 x the f32 contract of the wider layer."""
    (jfront, jsvcs), (tfront, tsvcs) = _whisper_pair(n_mels=80, d_model=32)
    jmel, tmel = _pair(_rand((1, t, 80), 20 + t))
    tol = _conv_tol(3 * 80)
    x1 = tsvcs[0](tmel[:, :, None, :])
    assert _err(x1, jsvcs[0](jmel[:, :, None, :])) <= tol
    assert _err(tfront(tmel), jfront(jmel)) <= tol
    assert [s.warmup.warning_count for s in tsvcs] == [0, 0]


def test_patch_embed_service_matches_jax():
    classes = [(1, 8, 8), (2, 16, 16)]
    jfront, jsvc = J.patch_embed_service(jax.random.key(1), 3, 16, 4,
                                         classes, prefix_len=10,
                                         plan_mode="analytic")
    tfront, tsvc = T.patch_embed_service(
        None, 3, 16, 4, classes, prefix_len=10, plan_mode="analytic",
        device="cpu", kernel=params_from_jax(np.asarray(jsvc.kernel),
                                             device="cpu"))
    assert len(tsvc.warmup.plans) == 2
    for i, shape in enumerate(((1, 6, 7, 3), (1, 8, 8, 3), (2, 13, 16, 3))):
        jimg, timg = _pair(_rand(shape, 30 + i))
        got = tfront(timg)
        assert tuple(got.shape) == (shape[0], 10, 16)
        assert _err(got, jfront(jimg)) <= _conv_tol(4 * 4 * 3)


def test_frontends_draw_from_a_generator():
    gen = torch.Generator().manual_seed(0)
    _, (s1, s2) = T.whisper_frontend_service(gen, 8, 16, [(1, 12, 1)],
                                             device="cpu")
    again = T.whisper_frontend_kernels(torch.Generator().manual_seed(0), 8,
                                       16, device="cpu")
    assert torch.equal(s1.kernel, again[0]) and torch.equal(s2.kernel,
                                                            again[1])
    assert abs(s1.kernel.std().item() - 8 ** -0.5) < 0.05
    _, svc = T.patch_embed_service(gen, 3, 16, 4, [(1, 8, 8)], 4,
                                   device="cpu")
    assert tuple(svc.kernel.shape) == (4, 4, 3, 16)
    with pytest.raises(ValueError, match="generator"):
        T.whisper_frontend_service(None, 8, 16, [(1, 12, 1)], device="cpu")


# -------------------------------------------------- the audio family (LM)

def _configs(dtype="float32"):
    return (jarchs.smoke_config(ARCH).with_(dtype=dtype),
            tarchs.smoke_config(ARCH).with_(dtype=dtype))


def test_gelu_mlp_matches_jax():
    jcfg, _ = _configs()
    from repro.models.lm import init_gelu_mlp as j_init
    p = j_init(jax.random.key(0), 16, 24, jnp.float32)
    p = jax.tree.map(lambda a: a + 0.1, p)          # non-zero biases
    jx, tx = _pair(_rand((2, 5, 16), 40))
    got = tlm.gelu_mlp(tx, params_from_jax(jax.device_get(p), device="cpu"))
    assert _err(got, j_gelu_mlp(jx, p)) <= 1e-5
    tp = tlm.init_gelu_mlp(torch.Generator().manual_seed(0), 16, 24,
                           torch.float32, device="cpu")
    assert {k: tuple(v["w"].shape) for k, v in tp.items()} == \
        {"up": (16, 24), "down": (24, 16)}
    assert float(tp["up"]["b"].abs().sum()) == 0.0


def test_audio_init_has_the_jax_tree_and_encoder_matches():
    jcfg, tcfg = _configs()
    jm, tm = JLM(jcfg), tlm.LM(tcfg)
    jp = jm.init(jax.random.key(0))
    shapes = jax.tree_util.tree_flatten_with_path(jp)[0]
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    for path, leaf in shapes:
        node = tp
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape, path
    jframes, tframes = _pair(_rand((2, jcfg.encoder_len, jcfg.d_model), 41))
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    assert _err(tm.encode(tp, tframes), jm.encode(jp, jframes)) <= 1e-5


def test_whisper_serving_matches_jax():
    """smoke_config("whisper-tiny"): 2 encoder and 2 decoder layers.  A
    16-token prefill over 12 frames, then 4 decode steps fed the same
    tokens in both packages: the logits of every step and every cache
    leaf agree."""
    jcfg, tcfg = _configs()
    jm, tm = JLM(jcfg), tlm.LM(tcfg)
    jp = jm.init(jax.random.key(0))
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    toks = np.random.RandomState(1).randint(0, jcfg.vocab, (2, 20))
    jframes, tframes = _pair(_rand((2, jcfg.encoder_len, jcfg.d_model), 2))
    max_len = 24
    j_logits, j_cache = jserve.prefill(
        jm, jp, {"tokens": jnp.asarray(toks[:, :16], jnp.int32),
                 "frames": jframes}, max_len)
    t_logits, t_cache = tserve.prefill(
        tm, tp, {"tokens": torch.from_numpy(toks[:, :16]),
                 "frames": tframes}, max_len)
    errs = {"prefill": _err(t_logits, j_logits)}
    for step in range(4):
        tok = toks[:, 16 + step:17 + step]
        j_logits, j_cache = jserve.decode_step(jm, jp, j_cache,
                                               jnp.asarray(tok, jnp.int32))
        t_logits, t_cache = tserve.decode_step(tm, tp, t_cache,
                                               torch.from_numpy(tok))
        assert t_logits.dtype == torch.float32
        errs[f"decode{step}"] = _err(t_logits, j_logits)
    j_cache = jax.device_get(j_cache)
    assert sorted(t_cache) == sorted(j_cache)
    assert int(t_cache["len"]) == int(j_cache["len"]) == 20
    for name in ("k", "v", "cross_k", "cross_v"):
        errs[name] = _err(t_cache[name], j_cache[name])
    assert max(errs.values()) <= SLICE_TOL, errs


def test_whisper_decode_matches_prefill():
    _, cfg = _configs()
    model = tlm.LM(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    frames = torch.randn((2, cfg.encoder_len, cfg.d_model),
                         generator=torch.Generator().manual_seed(2))
    toks = torch.randint(0, cfg.vocab, (2, 17),
                         generator=torch.Generator().manual_seed(1))
    _, cache = tserve.prefill(model, params,
                              {"tokens": toks[:, :16], "frames": frames}, 25)
    logits_dec, _ = tserve.decode_step(model, params, cache, toks[:, 16:])
    logits_ref, _ = tserve.prefill(model, params,
                                   {"tokens": toks, "frames": frames}, 25)
    rel = ((logits_dec - logits_ref).abs().max()
           / (logits_ref.abs().max() + 1e-9)).item()
    assert rel < 2e-2


def test_audio_init_decode_cache_has_the_jax_tree():
    jcfg, tcfg = _configs()
    j = jax.device_get(jserve.init_decode_cache(JLM(jcfg), 2, 9))
    t = tserve.init_decode_cache(tlm.LM(tcfg), 2, 9, device="cpu")
    assert sorted(j) == sorted(t)
    for name in j:
        assert tuple(t[name].shape) == np.shape(j[name]), name
        assert _err(t[name], j[name]) == 0.0


# ----------------------------------------------- the launcher and example

def test_launcher_serves_whisper_through_the_warmed_frontend():
    cfg = tarchs.smoke_config(ARCH)
    res = tlaunch.serve(cfg, batch=2, prompt_len=8, gen=4, device="cpu",
                        warm_plans=True)
    assert tuple(res["tokens"].shape) == (2, 4)
    assert [r.warning_count for r in res["warmup"]] == [0, 0]
    assert [list(map(str, r.plans)) for r in res["warmup"]] == \
        [[str(T.ShapeClass(2, 2 * cfg.encoder_len, 1))]] * 2
    assert res["frontend_s"] > 0 and res["warm_s"] > 0
    stub = tlaunch.serve(cfg, batch=2, prompt_len=8, gen=4, device="cpu")
    assert stub["warmup"] == [] and stub["frontend_s"] is None


def test_launcher_main_with_warm_plans(capsys):
    gen = tlaunch.main(["--arch", ARCH, "--smoke", "--batch", "2",
                        "--prompt-len", "8", "--gen", "3", "--warm-plans",
                        "--shape-classes", "2x20x1,2x24x1", "--device",
                        "cpu"])
    assert tuple(gen.shape) == (2, 3)
    out = capsys.readouterr().out
    assert "-- class 2x24x1 --" in out and "warmed 2 conv service(s)" in out


def test_whisper_example_on_the_cpu(capsys):
    res = example.main(["--device", "cpu"])
    cfg = tarchs.smoke_config(ARCH)
    assert res["frames"] == (2, cfg.encoder_len, cfg.d_model)
    assert res["logits"] == (2, cfg.vocab)
    assert res["warnings"] == 0
    assert set(res["classes"].values()) == {"2x12x1", "2x24x1"}
    assert "service frames equal the fixed-shape path's: True" in \
        capsys.readouterr().out


def test_service_conv_matches_eager_plan_bits():
    """The class executor (a plain call on the CPU) against ``conv2d(plan=)``
    on the same padded class input: equal bits."""
    _, tsvc = _services()
    tsvc.warm()
    x = torch.from_numpy(_rand((1, 9, 11, 4), 50))
    cls = tsvc.bucket(x.shape)
    with torch.no_grad():
        eager = tconv2d(tsvc.pad_to_class(x, cls), tsvc.kernel,
                        stride=tsvc.stride, padding=tsvc.padding,
                        plan=tsvc.plans[cls])
    o_n, o_h, o_w, _ = tsvc.request_out_shape(x.shape)
    assert torch.equal(tsvc(x), eager[:o_n, :o_h, :o_w])
