"""The LM cells (``lm_serve`` driver, Zamba2-7B-Instruct) on the CPU at
smoke size: each run is correct, measures its rate and reports exactly
``peak_mem_gib`` and ``setup_s`` (the end-to-end metrics the benchmark
has for every cell; the LM rates are not among them yet); a timed path with the hybrid layers'
LoRA or their linear left out, the gated norms' weight left out or D
mapped to the wrong heads, and the float8 control, are not correct;
the yardstick counts the published model; the configuration file is the
port's arch; the readers find their numbers where the trace has them and
nothing elsewhere; ``BENCHMARK.json`` only appends to what it had.

    python -m pytest -q mecbench/tests
"""
import json
from pathlib import Path

import pytest
import torch

from mecbench import run as bench_run
from mecbench.tests.test_mecbench_harness import (BENCH, check_cells,
                                                  smoke_context)
from mecbench.yardstick import lm as ylm
from mecbench.yardstick import peaks

ROOT = Path(__file__).resolve().parents[2]
CONFIG = json.loads((ROOT / "mecbench/configs/zamba2-7b-instruct.json")
                    .read_text())
LM_CELLS = [w["name"] for w in BENCH["workloads"]
            if w["config"] == "zamba2-7b-instruct"]
DEVICE = {"platform": "gpu", "kind": "test", "count": 1,
          "memory_peak_bytes": 0}
SEED = 2 ** 33 + 7


def _line(workload, res, trace=False):
    return bench_run.result_line(BENCH, workload, res, trace, DEVICE)


def test_the_two_cells_and_their_entries():
    """The cells come in as appended entries: the end-to-end metrics are
    the three the benchmark had, and each per-layer metric of an LM cell
    moves one that the cell reports."""
    assert LM_CELLS == ["zamba2-7b-instruct.prefill.b8x2048",
                        "zamba2-7b-instruct.decode.b32.p128.g128"]
    assert [w["name"] for w in BENCH["workloads"]][:2] == [
        "resnet101.infer.bf16.b64", "resnet101.train.f32.b128"]
    assert [m["name"] for m in BENCH["end_to_end"]] == [
        "images_per_s", "peak_mem_gib", "setup_s"]
    for w in LM_CELLS:
        reported = {m["name"] for m in bench_run.cell_metrics(
            BENCH, w, "end_to_end")}
        assert reported == {"peak_mem_gib", "setup_s"}
        layer = bench_run.cell_metrics(BENCH, w, "per_layer")
        assert layer and all(m["moves"] in reported for m in layer)
    assert {m["name"] for m in BENCH["per_layer"]
            if set(m["workloads"]) & set(LM_CELLS)} == {
        "k5_roofline", "mamba2_ssd_ms", "shared_block_ms", "prefill_mfu",
        "decode_step_ms", "decode_step_roofline", "decode_mfu"}
    check_cells(BENCH)


@pytest.mark.parametrize("workload", LM_CELLS)
def test_a_smoke_run_is_correct_and_reports_its_rate(workload):
    res = bench_run.load_driver(CONFIG).run(smoke_context(workload,
                                                          seed=SEED))
    line = _line(workload, res)
    rate = workload.split(".")[1] + "_tokens_per_s"
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"peak_mem_gib", "setup_s"}
    assert res.metrics[rate] > 0 and line["metrics"]["setup_s"]["value"] > 0
    assert list(line["checks"]) == ["logits_err"]


def _without(part):
    """A timed path whose hybrid layers leave ``part`` out, whose gated
    norms leave out their weight, or whose D skip is mapped to the heads
    in reverse."""
    from repro_torch.models import lm, mamba2, serve
    if part == "gated_norm_weight":
        orig_norm = mamba2._gated_norm
        return [(mamba2, "_gated_norm", lambda cfg, y, z, w, tp: orig_norm(
            cfg, y, z, torch.ones_like(w), tp))]
    if part == "d_heads":
        orig_local = mamba2._local

        def local(p, cfg, tp):
            w_in, conv_w, a_log, d_skip, dt_bias = orig_local(p, cfg, tp)
            return w_in, conv_w, a_log, d_skip.flip(-1), dt_bias
        return [(mamba2, "_local", local)]
    if part == "lora":
        orig = lm.gated_mlp
        return [(lm, "gated_mlp", lambda x, p, adapter: orig(
            x, p, {"linear": adapter["linear"]}))]
    orig_block = lm.hybrid_block

    def block(p, adapter, cfg, h, emb, attend, layer, blk):
        out, kv = orig_block(p, adapter, cfg, h, emb, attend, layer, blk)
        return out * 0, kv
    return [(lm, "hybrid_block", block), (serve, "hybrid_block", block)]


@pytest.mark.parametrize("workload", LM_CELLS)
@pytest.mark.parametrize("part", ["lora", "linear", "gated_norm_weight",
                                  "d_heads"])
def test_a_timed_path_without_a_part_is_not_correct(workload, part,
                                                    monkeypatch):
    for module, name, fn in _without(part):
        monkeypatch.setattr(module, name, fn)
    res = bench_run.load_driver(CONFIG).run(smoke_context(workload,
                                                          seed=SEED))
    assert _line(workload, res)["correct"] is False


@pytest.mark.parametrize("workload", LM_CELLS)
def test_the_float8_control_is_not_correct(workload):
    ctx = smoke_context(workload, seed=SEED)
    ctx.control = True
    res = bench_run.load_driver(CONFIG).run(ctx)
    assert all(c.ok for c in res.checks)
    assert not all(c.ok for c in res.control), res.control


def test_the_configuration_is_the_ports_arch():
    from repro_torch.configs.archs import PUBLISHED, ZAMBA2_7B_INSTRUCT
    assert CONFIG["reduced"] == [] and CONFIG["driver"] == "lm_serve"
    for key, value in ZAMBA2_7B_INSTRUCT.items():
        assert CONFIG[key] == value, key
    assert CONFIG["hybrid_layer_ids"] == [
        i for i, t in enumerate(CONFIG["layers_block_type"]) if t == "hybrid"]
    drv = bench_run.load_driver(CONFIG)
    assert (drv.model_config(CONFIG, "bfloat16")
            == PUBLISHED["zamba2-7b-instruct"])
    smoke = dict(CONFIG, **CONFIG["smoke"])
    cfg = drv.model_config(smoke, "bfloat16")
    assert cfg.d_model == 64 and cfg.ssm_groups == 2
    assert len(cfg.hybrid_layer_ids) >= 2 and cfg.n_mem_blocks == 2


def test_the_yardstick_counts_the_published_model():
    p = ylm.params(CONFIG)
    # the embedding once (tied head); 7.47 B with the head counted apart
    assert 7.35e9 < p["total"] < 7.36e9
    untied = ylm.params(dict(CONFIG, tie_word_embeddings=False))["total"]
    assert 7.4e9 < untied < 7.6e9
    assert untied - p["total"] == 32000 * 3584
    # decode: b gathered rows of the embedding for the lookup, not the
    # table; the head's matrix once
    one = ylm.decode_bytes(CONFIG, 1, 200, "bfloat16")
    two = ylm.decode_bytes(CONFIG, 2, 200, "bfloat16")
    per_seq = (3584 * 2 + 2 * 81 * 112 * 64 * 64 * 4
               + 2 * 81 * 3 * 7424 * 2 + 13 * 2 * 7168 * 201 * 2
               + 32000 * 4)
    assert two - one == per_seq
    weights = (p["total"] - p["embed"] + 32000 * 3584) * 2
    assert one == weights + per_seq
    assert ylm.k5_bytes(CONFIG, 8, 2048, "bfloat16") == (
        (2 * 8 * 2048 + 4) * 7424 * 2)


def _trace(loop):
    cfg = CONFIG
    t = {"loop": loop, "config": cfg, "dtype": "bfloat16", "batch": 8,
         "prompt_len": 2048, "gen_len": None, "steps": 12, "window_s": 30.0,
         "profiled_steps": 1, "lengths": [],
         "profile": {"kernels": {
             "void conv1d_kernel<__nv_bfloat16, 4>(P)": {"device_s": 0.02,
                                                         "count": 81}}},
         "spans": {"mamba2.ssd": {"count": 81, "device_s": 0.4},
                   "lm.shared_block": {"count": 13, "device_s": 0.9}}}
    if loop == "decode":
        t.update(batch=32, prompt_len=128, gen_len=128, steps=300,
                 lengths=[150, 151],
                 spans={"decode_program.replay": {"count": 2,
                                                  "device_s": 0.1}})
    return t


def _reader(name):
    return bench_run.load_module(ROOT / "mecbench/metrics" / f"{name}.py",
                                 "m_" + name)


def test_the_readers():
    pre, dec = _trace("prefill"), _trace("decode")
    k5 = 81 * ylm.k5_bytes(CONFIG, 8, 2048, "bfloat16")
    assert _reader("k5_roofline").read(pre) == pytest.approx(
        100 * k5 / peaks.HBM_BYTES_PER_S / 0.02)
    assert _reader("mamba2_ssd_ms").read(pre) == pytest.approx(400.0)
    assert _reader("shared_block_ms").read(pre) == pytest.approx(900.0)
    assert _reader("prefill_mfu").read(pre) == pytest.approx(
        100 * 12 * ylm.prefill_flops(CONFIG, 8, 2048) / 30 / 989e12)
    assert _reader("decode_step_ms").read(dec) == pytest.approx(50.0)
    nbytes = (ylm.decode_bytes(CONFIG, 32, 150, "bfloat16")
              + ylm.decode_bytes(CONFIG, 32, 151, "bfloat16")) / 2
    assert _reader("decode_step_roofline").read(dec) == pytest.approx(
        100 * nbytes / peaks.HBM_BYTES_PER_S / 0.05)
    flops = (3 * ylm.prefill_flops(CONFIG, 32, 128) + sum(
        ylm.decode_flops(CONFIG, 32, 128 + i % 128)
        for i in range(300) if i % 128))
    assert _reader("decode_mfu").read(dec) == pytest.approx(
        100 * flops / 30 / 989e12)
    for name in ("k5_roofline", "mamba2_ssd_ms", "shared_block_ms",
                 "prefill_mfu"):
        assert _reader(name).read(dec) is None
    for name in ("decode_step_ms", "decode_step_roofline", "decode_mfu"):
        assert _reader(name).read(pre) is None
    assert _reader("decode_step_ms").read(dict(dec, spans={})) is None


def test_a_traced_smoke_run_reads_what_the_cpu_has():
    """Off the card the spans hold no device time and the profile no
    kernels: only the MFU readers find their numbers."""
    for workload in LM_CELLS:
        res = bench_run.load_driver(CONFIG).run(
            smoke_context(workload, seed=SEED, trace=True))
        line = _line(workload, res, trace=True)
        mfu = workload.split(".")[1] + "_mfu"
        assert set(line["metrics"]) == {mfu}
        assert 0 < line["metrics"][mfu]["value"] < 100
        spans = res.trace["spans"]
        if res.trace["loop"] == "decode":      # the program runs eagerly
            assert spans["lm.decode"]["count"] >= 1
        else:
            assert spans["lm.prefill"]["count"] == 1
            assert spans["mamba2.ssd"]["count"] == CONFIG["smoke"][
                "num_hidden_layers"]
            assert spans["lm.shared_block"]["count"] == len(
                CONFIG["smoke"]["hybrid_layer_ids"])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", LM_CELLS)
def test_a_short_lm_run_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import subprocess
    import sys
    out = subprocess.run(
        [sys.executable, "mecbench/run.py", "--workload", workload, "--seed",
         str(2 ** 31 + 11), "--seconds", "2", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
