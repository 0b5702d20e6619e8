"""The readers of the port's own spans (``mecbench/spans.py`` and the
five metrics that use it) on the CPU: nothing without ``geoms`` or with no
span recorded; per-step values from a summary with known numbers (the
training readers' own profiled pass stood in for, made once a trace); and
the stack at smoke size under ``common.profile``, whose profiled passes
the spans record.

    python -m pytest -q mecbench/tests
"""
from pathlib import Path

import pytest

from mecbench import common, run as bench_run, spans

ROOT = Path(__file__).resolve().parents[2]
READERS = ("vjp_dx_ms", "vjp_dw_ms", "vjp_copy_ms", "vjp_alloc_gib",
           "conv_plan_us")
GEOMS = [(2, 10, 10, 8, 3, 3, 8, 1, 1)] * 2 + [(2, 12, 12, 4, 5, 5, 8, 2, 2)]

obs = pytest.importorskip("repro_torch.obs")


def reader(name):
    return bench_run.load_module(ROOT / "mecbench/metrics" / f"{name}.py",
                                 "m_" + name)


@pytest.fixture(autouse=True)
def clean():
    obs.disable()
    obs.reset()
    yield
    obs.reset()


def _stats(count, host_s=0.0, device_s=None, self_device_s=None,
           alloc_bytes=None):
    return {"count": count, "host_s": host_s, "self_host_s": host_s,
            "device_s": device_s, "self_device_s": self_device_s,
            "alloc_bytes": alloc_bytes}


#: a summary of 4 steps of the 3 convs above: 12 top-level conv2d calls
SUMMARY = {
    "names": {
        "conv2d": _stats(14, device_s=1.0),
        "conv2d.plan": _stats(12, host_s=12 * 20e-6),
        "mec_vjp": _stats(12, device_s=2.0, alloc_bytes=8 * 2 ** 30),
        "mec_vjp.dx": _stats(12, device_s=1.2),
        "mec_vjp.dw": _stats(12, device_s=0.6),
    },
    "paths": {
        "conv2d": _stats(12),
        "conv2d/conv2d.plan/conv2d": _stats(2),
        "mec_vjp/mec_vjp.dx/mec_vjp.dx.dilate_pad": _stats(
            12, self_device_s=0.1),
        "mec_vjp/mec_vjp.dx/mec.lower": _stats(12, self_device_s=0.2),
        "mec_vjp/mec_vjp.dx/mec.rows": _stats(12, self_device_s=0.7),
        "mec_vjp/mec_vjp.dw/mec.lower": _stats(12, self_device_s=0.05),
        "mec_vjp/mec_vjp.dw/mec_vjp.dw.rows": _stats(12, self_device_s=0.5),
        "mec_vjp/mec_vjp.dw/mec_vjp.dw.stack": _stats(12,
                                                      self_device_s=0.01),
        "mec_vjp/mec_vjp.cast": _stats(24, self_device_s=0.04),
        "conv2d/mec.lower": _stats(12, self_device_s=9.0),
    },
    "by_spec": {}, "dropped": 0}

EXPECTED = {"vjp_dx_ms": 1.2 / 4 * 1e3, "vjp_dw_ms": 0.6 / 4 * 1e3,
            "vjp_copy_ms": (0.1 + 0.2 + 0.05 + 0.01 + 0.04) / 4 * 1e3,
            "vjp_alloc_gib": 2.0, "conv_plan_us": 20.0}


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_without_geoms_or_spans(name):
    assert reader(name).read({}) is None
    assert reader(name).read({"geoms": GEOMS, "train": True}) is None
    assert reader(name).read({"geoms": [], "train": True}) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_computes_a_step_from_the_summary(name, monkeypatch):
    """Steps are the top-level ``conv2d`` calls over the stack's convs
    (12 / 3 = 4: the gate's nested calls do not count); the training
    readers' pass is made once a trace, never without spans recorded."""
    made = []
    monkeypatch.setattr(obs, "summary", lambda: SUMMARY)
    monkeypatch.setattr(spans, "_profiled",
                        lambda trace: made.append(trace) or SUMMARY)
    trace = {"geoms": GEOMS, "train": True}
    assert reader(name).read(trace) == pytest.approx(EXPECTED[name])
    assert reader(name).read(trace) == pytest.approx(EXPECTED[name])
    assert made == ([trace] if name != "conv_plan_us" else [])
    assert reader(name).read({}) is None


@pytest.mark.parametrize("name", READERS[:4])
def test_vjp_readers_find_nothing_off_the_card(name, monkeypatch):
    """Off the card the pass is not made; a summary whose spans were given
    no device time or allocator reads gives nothing either."""
    host_only = {"names": {k: dict(v, device_s=None, alloc_bytes=None)
                           for k, v in SUMMARY["names"].items()},
                 "paths": {k: dict(v, self_device_s=None)
                           for k, v in SUMMARY["paths"].items()}}
    monkeypatch.setattr(obs, "summary", lambda: host_only)
    assert reader(name).read({"geoms": GEOMS, "train": True}) is None
    monkeypatch.setattr(spans, "_profiled", lambda trace: host_only)
    assert reader(name).read({"geoms": GEOMS, "train": True}) is None


@pytest.mark.parametrize("workload,found", [
    ("resnet101.infer.bf16.b64", {"conv_plan_us"}),
    ("resnet101.train.f32.b128", set())])
def test_the_profiled_stack_records_its_spans(workload, found):
    """The stack at smoke size under ``common.profile`` (a CPU trace): every
    conv's call recorded in both passes, a backward for each in training,
    and the readers that need no device time find their numbers."""
    from mecbench.tests.test_mecbench_harness import (run_smoke,
                                                      smoke_context)
    ctx = smoke_context(workload)
    run_smoke(ctx)           # plans resolved, nothing recorded
    assert obs.summary()["names"] == {}
    from mecbench.drivers import conv_stack
    import torch
    geoms = conv_stack.geometries(ctx.config, ctx.traffic["batch"])
    train = ctx.traffic["loop"] == "train"
    ops = conv_stack.make_operands(geoms, torch.float32
                                   if train else torch.bfloat16, 1, ctx.seed,
                                   torch.device("cpu"), train)
    stack = conv_stack.Stack(geoms, ops, ctx.traffic["algorithm"], train)
    common.profile(lambda: stack(0), lambda: None)
    s = obs.summary()
    assert s["paths"]["conv2d"]["count"] == 2 * len(geoms)
    if train:
        assert s["names"]["mec_vjp"]["count"] == 2 * len(geoms)
    trace = {"geoms": [g for _, g in geoms], "train": train,
             "dtype": "float32" if train else "bfloat16"}
    got = {n for n in READERS if reader(n).read(trace) is not None}
    assert got == found
    if "conv_plan_us" in found:
        assert reader("conv_plan_us").read(trace) > 0


def test_the_readers_pass_runs_the_training_stack_once_recorded():
    """The training readers' own pass, made on the host at smoke size:
    DEVICE_STEPS steps recorded under ``obs.recording()``, a backward for
    every call; no device time and no allocator read off the card."""
    from mecbench.tests.test_mecbench_harness import (run_smoke,
                                                      smoke_context)
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mecbench.drivers import conv_stack
    ctx = smoke_context("resnet101.train.f32.b128")
    run_smoke(ctx)
    geoms = conv_stack.geometries(ctx.config, ctx.traffic["batch"])
    trace = {"geoms": [g for _, g in geoms], "train": True,
             "dtype": "float32"}
    assert spans._profiled(trace, torch.device("cpu")) is None  # no calls
    ops = conv_stack.make_operands(geoms, torch.float32, 1, ctx.seed,
                                   torch.device("cpu"), True)
    stack = conv_stack.Stack(geoms, ops, ctx.traffic["algorithm"], True)
    with profile(activities=[ProfilerActivity.CPU]):
        stack(0)
    s = spans._profiled(trace, torch.device("cpu"))
    calls = spans.DEVICE_STEPS * len(geoms)
    assert s["paths"]["conv2d"]["count"] == calls
    assert s["names"]["mec_vjp"]["count"] == calls
    assert s["names"]["mec_vjp"]["device_s"] is None
    assert s["names"]["mec_vjp"]["alloc_bytes"] is None
