"""The port's spans and counters (``repro_torch.obs``) on the CPU: off by
default, on under any profiler session without marking it, marked under
``recording()``; the backward's spans linked to the forward call; self
times; the allocator read only under ``recording()``; a profile's
kernels given to the spans; the summary by spec key; the plan cache's
lookups, the kernel compiles and the record cap.  The ``cuda`` cases hold
the allocator's bytes inside the VJP's dilate-and-pad to the tensors'
shapes on the card, with every span's device time from the profiler, and
capture a conv service's graph while recording.
"""
import os
import stat

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch import plan as plan_mod
from repro_torch.core.conv_api import conv2d
from repro_torch.kernels import build, mec_conv, mec_conv1d
from repro_torch.plan.cache import global_plan_cache

MEC = ("mec", "mec_lowered", "mec_fused", "mec_fused2")
#: the VJP's spans of one f32 call with both gradients, by path (a
#: bf16 operand adds ``mec_vjp/mec_vjp.cast``)
VJP_PATHS = {"mec_vjp", "mec_vjp/mec_vjp.dx", "mec_vjp/mec_vjp.dw"} | {
    f"mec_vjp/mec_vjp.dx/{n}" for n in ("mec_vjp.dx.dilate_pad",
                                        "mec_vjp.dx.flip", "mec.lower",
                                        "mec.rows", "mec_vjp.dx.crop")} | {
    f"mec_vjp/mec_vjp.dw/{n}" for n in ("mec.lower", "mec_vjp.dw.rows",
                                        "mec_vjp.dw.stack")}


@pytest.fixture(autouse=True)
def clean(tmp_path, monkeypatch):
    """No span kept and tracing off around each test; the plan cache and
    calibration under tmp_path."""
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    monkeypatch.setenv("REPRO_TORCH_CALIBRATION", str(tmp_path / "cal.json"))
    plan_mod.reset_global_plan_cache()
    plan_mod.reset_calibration_cache()
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()
    plan_mod.reset_global_plan_cache()
    plan_mod.reset_calibration_cache()


def _step(algorithm="mec", device="cpu", shape=(2, 12, 12, 4),
          kernel=(5, 5, 4, 8), stride=2, dtype=torch.float32):
    """One conv forward and its backward to input and kernel."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=gen).to(device, dtype).requires_grad_()
    w = torch.randn(kernel, generator=gen).to(device, dtype).requires_grad_()
    y = conv2d(x, w, stride=stride, algorithm=algorithm)
    cot = torch.randn(y.shape, generator=gen).to(device, dtype)
    torch.autograd.grad(y, [x, w], cot)
    return y


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r["name"], []).append(r)
    return out


@pytest.mark.parametrize("algorithm", MEC)
def test_off_by_default_records_nothing(algorithm):
    _step(algorithm)
    assert obs.records() == []
    assert obs.summary()["names"] == {}
    assert obs.span("conv2d") is obs.span("mec_vjp")   # the shared no-op


@pytest.mark.parametrize("algorithm", MEC)
def test_a_profiler_session_records_the_tree_unmarked(algorithm):
    """Under a CPU profiler the program did not ask to mark: the span tree
    with its parents and causes, and no ``repro_torch.`` range among the
    profiler's events."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(algorithm)
    recs = obs.records()
    names = _by_name(recs)
    (call,) = names["conv2d"]
    assert call["parent"] is None and call["cause"] == call["id"]
    assert call["attrs"] == {"spec": "2x12x12x4-k5x5x8-s2x2",
                             "algorithm": algorithm, "dtype": "float32"}
    assert {r["path"] for r in recs if r["path"].startswith("mec_vjp")} \
        == VJP_PATHS
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        if r["parent"] is not None:
            parent = by_id[r["parent"]]
            assert r["path"] == f"{parent['path']}/{r['name']}"
            assert parent["t0_ns"] <= r["t0_ns"] <= r["t1_ns"] \
                <= parent["t1_ns"]
    assert not [e.name for e in prof.events()
                if e.name.startswith(obs.PREFIX)]
    with profile(activities=[ProfilerActivity.CPU]):
        pass
    assert len(obs.records()) == len(recs)       # nothing after the session


@pytest.mark.parametrize("dtype,casts", [(torch.float32, 0),
                                          (torch.bfloat16, 2)])
def test_the_cast_back_is_a_span_where_it_happens(dtype, casts):
    obs.enable()
    _step(dtype=dtype)
    s = obs.summary()
    assert s["paths"].get("mec_vjp/mec_vjp.cast", {"count": 0})["count"] \
        == casts
    assert VJP_PATHS <= set(s["paths"])
    assert s["names"]["conv2d"] == s["by_spec"]["2x12x12x4-k5x5x8-s2x2"][
        "conv2d"]


def test_recording_inside_a_profiler_marks_it():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.recording():
            _step()
    marked = {e.name for e in prof.events() if e.name.startswith(obs.PREFIX)}
    assert {obs.PREFIX + n for n in ("conv2d", "mec_vjp", "mec_vjp.dx",
                                     "mec_vjp.dw", "mec.lower")} <= marked
    assert obs._enabled is False                 # restored on the way out


@pytest.mark.parametrize("algorithm", MEC)
def test_backward_spans_carry_the_forward_call_as_cause(algorithm):
    obs.enable()
    _step(algorithm)
    _step(algorithm, shape=(1, 9, 9, 4), kernel=(3, 3, 4, 8), stride=1)
    calls = [r for r in obs.records() if r["name"] == "conv2d"]
    assert len(calls) == 2
    for call in calls:
        linked = {r["path"] for r in obs.records()
                  if r["cause"] == call["id"] and r["path"] != "conv2d"}
        assert VJP_PATHS <= linked
    vjp = [r for r in obs.records() if r["name"] == "mec_vjp"]
    assert sorted(r["cause"] for r in vjp) == sorted(c["id"] for c in calls)


def test_self_time_is_duration_less_the_children():
    obs.enable()
    with obs.span("outer", device=False):
        for _ in range(2):
            with obs.span("inner", device=False):
                torch.ones(64).sum()
        torch.ones(64).sum()
    recs = _by_name(obs.records())
    (outer,) = recs["outer"]
    inner = sum(r["t1_ns"] - r["t0_ns"] for r in recs["inner"])
    s = obs.summary()["names"]
    assert s["outer"]["host_s"] == pytest.approx(
        (outer["t1_ns"] - outer["t0_ns"]) * 1e-9, rel=1e-12)
    assert s["outer"]["self_host_s"] == pytest.approx(
        s["outer"]["host_s"] - inner * 1e-9, rel=1e-9)
    assert s["inner"]["count"] == 2
    assert s["inner"]["self_host_s"] == pytest.approx(s["inner"]["host_s"])
    assert s["outer"]["device_s"] is None and s["outer"]["alloc_bytes"] is None


def test_summary_groups_by_spec_key():
    obs.enable()
    _step()
    _step()
    _step(shape=(1, 9, 9, 4), kernel=(3, 3, 4, 8), stride=1)
    s = obs.summary()
    assert set(s["by_spec"]) == {"2x12x12x4-k5x5x8-s2x2",
                                 "1x9x9x4-k3x3x8-s1x1"}
    big, small = s["by_spec"]["2x12x12x4-k5x5x8-s2x2"], \
        s["by_spec"]["1x9x9x4-k3x3x8-s1x1"]
    assert big["conv2d"]["count"] == 2 and small["conv2d"]["count"] == 1
    assert big["mec_vjp/mec_vjp.dw/mec.lower"]["count"] == 2
    for path, stats in s["paths"].items():
        assert stats["count"] == sum(g[path]["count"] for g in
                                     s["by_spec"].values() if path in g)
    # the forward's, dx's and dw's lowering, three calls
    assert s["names"]["mec.lower"]["count"] == 9
    assert s["dropped"] == 0


def test_plan_cache_counts_one_miss_then_hits():
    obs.enable()
    for _ in range(3):
        conv2d(torch.ones(1, 6, 6, 2), torch.ones(3, 3, 2, 4))
    cache = obs.counters()["plan_cache"]
    assert (cache["misses"], cache["hits"], cache["io_errors"]) == (1, 2, 0)
    assert cache["disk_loads"] == 0         # no file yet at the first miss
    plan_mod.reset_global_plan_cache()
    conv2d(torch.ones(1, 6, 6, 2), torch.ones(3, 3, 2, 4))
    cache = global_plan_cache()
    assert (cache.hits, cache.misses, cache.disk_loads) == (1, 0, 1)
    # a miss's plan runs its numeric gate's convs inside conv2d.plan
    s = obs.summary()
    assert s["names"]["conv2d.plan"]["count"] == 4
    assert s["paths"]["conv2d"]["count"] == 4
    assert s["paths"]["conv2d/conv2d.plan/conv2d"]["count"] >= 1


def test_counters_read_where_the_port_counts(tmp_path, monkeypatch):
    """Launches as the kernel wrappers count them; one compile of a fake
    nvcc counted once, with its seconds."""
    launches = obs.counters()["launches"]
    assert launches == dict(mec_conv.launch_counts(),
                            mec_conv1d=mec_conv1d.mec_conv1d.launches)
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "library_path",
                        lambda name: tmp_path / "kernels" / f"lib{name}.so")
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    before = obs.counters()["nvcc"]
    out = build.build(["mec_conv"])
    after = obs.counters()["nvcc"]
    assert out["mec_conv"]["compiled"] and os.path.isfile(
        out["mec_conv"]["path"])
    assert after["compiles"] == before["compiles"] + 1
    assert after["seconds"] == pytest.approx(
        before["seconds"] + out["mec_conv"]["seconds"])
    build.build(["mec_conv"])                     # built: nothing compiles
    assert obs.counters()["nvcc"] == after


class _FakeAllocator:
    """Stands in for the card's allocator statistics: a count of
    allocated bytes that the test moves by hand, and its reads."""

    def __init__(self, monkeypatch):
        self.allocated = 0
        self.reads = 0

        def stats(device):
            self.reads += 1
            return {"allocated_bytes": {"all": {"allocated": self.allocated}}}

        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        monkeypatch.setattr(torch._C, "_cuda_memoryStats", stats,
                            raising=False)

    def work(self, nbytes):
        self.allocated += nbytes


def _nest(card):
    with obs.span("root"):
        card.work(10)
        with obs.span("a"):
            card.work(5)
        with obs.span("host", device=False):
            card.work(1)                 # a host span reads nothing
        card.work(100)


@pytest.mark.parametrize("how", ["recording", "profiler"])
def test_the_allocator_is_read_only_where_the_operator_asked(how,
                                                             monkeypatch):
    """Under ``recording()`` a device span reads the allocator at both ends
    (a host span never); under a profiler alone nothing is read."""
    card = _FakeAllocator(monkeypatch)
    if how == "recording":
        with obs.recording():
            _nest(card)
    else:
        with profile(activities=[ProfilerActivity.CPU]):
            _nest(card)
    s = obs.summary()["names"]
    assert s["host"]["alloc_bytes"] is None
    if how == "recording":
        assert card.reads == 4
        assert (s["root"]["alloc_bytes"], s["a"]["alloc_bytes"]) == (116, 5)
    else:
        assert card.reads == 0
        assert s["root"]["alloc_bytes"] is None and s["a"]["count"] == 1


class _Event:
    """A profiler event as ``attribute`` reads it."""

    def __init__(self, name, start=0.0, end=None, id=0,
                 device=torch.autograd.DeviceType.CPU):
        self.name, self.device_type, self.id = name, device, id
        self.time_range = type("R", (), {"start": start,
                                         "end": start if end is None
                                         else end})


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _launch(at, id, name, us):
    """A runtime call at host time ``at`` and the device work it launched."""
    return [_Event("cudaLaunchKernel", at, at + 0.5, id),
            _Event(name, 1000.0 + at, 1000.0 + at + us, id,
                   torch.autograd.DeviceType.CUDA)]


@pytest.mark.parametrize("extra_b", [0, 1])
def test_attribute_gives_spans_the_kernels_launched_inside(extra_b):
    """Each range gets the device work whose launch call fell inside it,
    and as self what no child range holds; the ranges' own device-side
    copies and work launched outside every range count nowhere; ranges
    are matched to the spans name by name in order, and a name whose
    counts differ is left without a time."""
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.recording():
            with obs.span("a", device=False):
                with obs.span("b", device=False):
                    pass
            with obs.span("a", device=False):
                pass
    cuda = torch.autograd.DeviceType.CUDA
    events = [_Event(obs.PREFIX + "a", 20.0, 30.0),       # out of order
              _Event(obs.PREFIX + "a", 0.0, 10.0),
              _Event(obs.PREFIX + "b", 2.0, 5.0),
              _Event(obs.PREFIX + "a", 0.0, 10.0, 9, cuda)]   # its copy
    events += (_launch(1.0, 1, "fill", 5.0) + _launch(3.0, 2, "copy", 3.0)
               + _launch(6.0, 3, "gemm", 40.0) + _launch(25.0, 4, "fill", 7.0)
               + _launch(15.0, 5, "outside", 100.0))
    events += [_Event(obs.PREFIX + "b", 35.0 + i, 36.0 + i)
               for i in range(extra_b)]
    assert obs.attribute(_Prof(events)) == (3 if not extra_b else 2)
    recs = sorted(obs.records(), key=lambda r: r["t0_ns"])
    assert [r["name"] for r in recs] == ["a", "b", "a"]
    assert recs[0]["device_s"] == pytest.approx(48e-6)
    assert recs[2]["device_s"] == pytest.approx(7e-6)
    s = obs.summary()["names"]
    # self: outside the child ranges, matched to a span or not
    assert s["a"]["self_device_s"] == pytest.approx(52e-6)
    if extra_b:
        assert recs[1]["device_s"] is None and s["b"]["device_s"] is None
    else:
        assert recs[1]["device_s"] == pytest.approx(3e-6)
        assert s["b"]["self_device_s"] == pytest.approx(3e-6)


def test_attribute_gives_nothing_without_device_work():
    """A profile that traced the host alone gives no span a time."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.recording():
            _step()
    assert obs.attribute(prof) == 0
    assert all(r["device_s"] is None for r in obs.records())


@pytest.mark.parametrize("cap", [0, 3])
def test_the_record_cap_counts_dropped(cap, monkeypatch):
    monkeypatch.setattr(obs, "MAX_RECORDS", cap)
    with obs.recording():
        for _ in range(5):
            with obs.span("s", device=False):
                pass
    s = obs.summary()
    assert s["dropped"] == 5 - cap
    assert s["names"].get("s", {"count": 0})["count"] == cap
    obs.reset()
    assert obs.summary()["dropped"] == 0


@pytest.mark.cuda
def test_dilate_pad_allocates_the_dilated_and_padded_cotangent_on_the_card():
    """A stride-2 conv on the card: ``mec_vjp.dx.dilate_pad`` hands out
    exactly the dilated cotangent and its padded copy (sizes that are
    whole 512-byte blocks, the allocator's rounding), and the profiler's
    kernels give every span a device time, positive for the call and the
    VJP's parts, the parts within the whole.  The weight gradient is one
    K6 launch: ``mec_vjp.dw`` opens no lowering, einsum or stack span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n, k_c, k = 2, 128, 3
    _step("mec", "cuda", shape=(n, 13, 13, 4), kernel=(k, k, 4, k_c))
    torch.cuda.synchronize()
    before = obs.counters()["launches"]["mec_weight_grad"]
    with obs.recording(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        y = _step("mec", "cuda", shape=(n, 13, 13, 4), kernel=(k, k, 4, k_c))
        torch.cuda.synchronize()
    assert obs.counters()["launches"]["mec_weight_grad"] == before + 1
    assert obs.attribute(prof) == len(obs.records())
    paths = set(obs.summary()["paths"])
    assert "mec_vjp/mec_vjp.dw" in paths
    assert not [p for p in paths if p.startswith("mec_vjp/mec_vjp.dw/")]
    o_h = y.shape[1]
    dil = (o_h - 1) * 2 + 1
    want = 4 * n * k_c * (dil * dil + (dil + 2 * (k - 1)) ** 2)
    s = obs.summary()["names"]
    assert s["mec_vjp.dx.dilate_pad"]["alloc_bytes"] == want
    for name, stats in s.items():
        assert stats["device_s"] >= 0 and stats["self_device_s"] >= 0, name
    for name in ("conv2d", "mec_vjp", "mec_vjp.dx", "mec_vjp.dw"):
        assert s[name]["device_s"] > 0, name
    busy = sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(obs.PREFIX)) * 1e-6
    top = s["conv2d"]["device_s"] + s["mec_vjp"]["device_s"]
    assert top <= busy * (1 + 1e-9)


@pytest.mark.cuda
def test_a_service_captures_its_graph_while_recording():
    """A ``ConvService`` on the card warms and captures its class
    executor under ``obs.recording()`` inside a profiler: the capture
    holds, the replay answers as the eager planned conv, and the summary
    reads the spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.serving import ConvService
    gen = torch.Generator().manual_seed(0)
    w = (torch.randn((3, 3, 4, 8), generator=gen) / 6).cuda()
    x = torch.randn((1, 13, 11, 4), generator=gen).cuda()
    svc = ConvService(w, stride=2, padding=1, classes=[(2, 16, 16)])
    with obs.recording(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        report = svc.warm()
        got = svc(x)
        torch.cuda.synchronize()
    obs.attribute(prof)
    assert report.warning_count == 0
    cls = svc.bucket(x.shape)
    with torch.no_grad():
        eager = conv2d(svc.pad_to_class(x, cls), svc.kernel, stride=2,
                       padding=1, plan=svc.plans[cls])
    o_n, o_h, o_w, _ = svc.request_out_shape(x.shape)
    assert torch.equal(got, eager[:o_n, :o_h, :o_w])
    s = obs.summary()
    assert s["names"]["conv2d"]["count"] >= 2       # warm-up and capture
    assert svc.replays[cls] == 1
