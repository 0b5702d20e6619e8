"""The port's LM cost model (``repro_torch.launch.costmodel``'s LM half),
its card constants and roofline terms (``launch.hlo_analysis``), the
``roofline`` table (``benchmarks.roofline``) and the kernels' flop
formula, against the JAX package in process on the same configurations.

The cost model is the same formulas in the same order: every term equals
the JAX package's (relative 1e-12) for every arch x applicable shape, on
three meshes and under the overrides that change it.  The roofline terms
equal the JAX package's times the ratio of the two packages' constants
(TPU v5e there, H100 SXM here); the dominant term legitimately differs
and is not compared.
"""
import importlib.util
import math
import pathlib

import pytest

torch = pytest.importorskip("torch")

import benchmarks.roofline as jroofline                    # noqa: E402
import repro.launch.costmodel as jcost                     # noqa: E402
import repro.launch.hlo_analysis as jhlo                   # noqa: E402
from repro.configs.archs import ARCHS as JARCHS            # noqa: E402
from repro.configs.shapes import SHAPES as JSHAPES         # noqa: E402

from repro_torch.benchmarks import roofline as troofline   # noqa: E402
from repro_torch.configs.archs import ARCHS                # noqa: E402
from repro_torch.configs.shapes import SHAPES, cell_applicable  # noqa: E402
from repro_torch.kernels import mec_conv as K              # noqa: E402
from repro_torch.kernels import mec_conv1d as C            # noqa: E402
from repro_torch.launch import costmodel as tcost          # noqa: E402
from repro_torch.launch import hlo_analysis as thlo        # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
CELLS = [(a, s) for a in ARCHS for s in SHAPES if cell_applicable(a, s)]
MESHES = [((), {}), ((), {"pod": 2}), ((1, 1, 1), {})]
OVERRIDES = [{}, {"seq_parallel": True}, {"remat_policy": "dots"},
             {"moe_dispatch_int8": True}, {"kv_cache_int8": True},
             {"grad_compress_int8": True}]


def _close(a, b):
    return math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0)


def test_the_sweep_is_the_issue_sweep():
    assert len(CELLS) == 32
    assert set(ARCHS) == set(JARCHS) and set(SHAPES) == set(JSHAPES)


@pytest.mark.parametrize("over", OVERRIDES, ids=lambda o: ",".join(o) or "base")
def test_lm_cost_model_equals_the_jax_package(over):
    for arch, shape in CELLS:
        mine, ref = ARCHS[arch].with_(**over), JARCHS[arch].with_(**over)
        cell = SHAPES[shape]
        b, s = cell.global_batch, cell.seq_len
        assert _close(tcost.flops_fwd(mine, b, s), jcost.flops_fwd(ref, b, s))
        assert _close(tcost.logits_flops(mine, b, s),
                      jcost.logits_flops(ref, b, s))
        assert _close(tcost.params_bytes(mine), jcost.params_bytes(ref))
        for args, kw in MESHES:
            tm, jm = tcost.MeshShape(*args, **kw), jcost.MeshShape(*args, **kw)
            got = tcost.cell_cost(mine, cell.kind, b, s, tm)
            want = jcost.cell_cost(ref, cell.kind, b, s, jm)
            assert set(got) == set(want)
            for k in want:
                assert _close(got[k], want[k]), (arch, shape, args, kw, k)


def test_constants_are_the_h100_sxm_data_sheet_and_chip_smoke_agrees():
    assert (thlo.PEAK_FLOPS, thlo.HBM_BW, thlo.ICI_BW) == (989e12, 3.35e12,
                                                           450e9)
    assert thlo.SOURCE == "H100 SXM data sheet"
    spec = importlib.util.spec_from_file_location("chip_smoke_peaks",
                                                  REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    _, bw, _, bf16, label = chip_smoke.peaks_for("NVIDIA H100 80GB HBM3")
    assert (bf16, bw, label) == (thlo.PEAK_FLOPS, thlo.HBM_BW, thlo.SOURCE)


def test_roofline_terms_equal_the_jax_packages_times_the_constants():
    ratio = {"t_compute_s": jhlo.PEAK_FLOPS / thlo.PEAK_FLOPS,
             "t_memory_s": jhlo.HBM_BW / thlo.HBM_BW,
             "t_collective_s": jhlo.ICI_BW / thlo.ICI_BW}
    for flops, hbm, coll, n in ((1e15, 3e11, 2e9, 256), (7.5e12, 1e9, 0.0, 1),
                                (0.0, 5e10, 4e8, 16)):
        got = thlo.roofline_terms(flops, hbm, coll, n)
        want = jhlo.roofline_terms(flops, hbm, coll, n)
        for k, r in ratio.items():
            assert _close(got[k], want[k] * r), k
    for arch, shape in CELLS:
        got = troofline.analyze_cell(arch, shape)
        want = jroofline.analyze_cell(arch, shape)
        for k, r in ratio.items():
            assert _close(got[k], want[k] * r), (arch, shape, k)
        assert _close(got["useful_flop_ratio"], want["useful_flop_ratio"])
        assert not any(k.startswith("raw_") for k in got)


def test_roofline_reads_dry_run_records_only_when_asked(tmp_path):
    rec = {"per_device": {"flops": 3.0, "collectives": {
        "all-gather": 0, "all-reduce": 5, "count": 1, "total": 5},
        "memory": {"peak_bytes": 7}}}
    (tmp_path / "qwen3-4b__train_4k__pod.json").write_text(
        __import__("json").dumps(rec))
    assert "raw_flops_dev" not in troofline.analyze_cell("qwen3-4b",
                                                         "train_4k")
    got = troofline.analyze_cell("qwen3-4b", "train_4k", results=tmp_path)
    assert (got["raw_flops_dev"], got["raw_coll_dev"], got["raw_coll_mix"],
            got["peak_bytes_dev"]) == (3.0, 5, {"all-reduce": 5}, 7)
    lines = []
    rows = troofline.main(emit=lines.append)
    assert len(rows) == 32 and lines[0] == "table,name,us_per_call,derived"


@pytest.mark.parametrize("name", ["mec_conv_fused", "mec_conv_fused2",
                                  "mec_lowered", "mec_conv1d",
                                  "mec_weight_grad"])
def test_kernel_launches_on_meta_count_their_arithmetic(name):
    """A K1-K6 launch traced on meta tensors is one ``kernel_call`` whose
    FLOPs (``hlo_analysis.flops_bytes``) are its own multiply-adds (K6's,
    the weight gradient's, the forward's); K2 (the lowering) counts
    none."""
    n, i_h, i_w, i_c, k_h, k_w, k_c, s = 2, 9, 11, 3, 3, 2, 5, 1
    x = torch.zeros((n, i_h, i_w, i_c), device="meta")
    k = torch.zeros((k_h, k_w, i_c, k_c), device="meta")
    o_h, o_w = (i_h - k_h) // s + 1, (i_w - k_w) // s + 1
    conv = 2 * n * o_h * o_w * k_h * k_w * i_c * k_c
    if name == "mec_conv1d":
        xs, ks = torch.zeros((n, 7, 6), device="meta"), \
            torch.zeros((4, 6), device="meta")
        got = thlo.flops_bytes(lambda: C.mec_conv1d(xs, ks))
        assert got == {"flops": 2 * n * 7 * 6 * 4, "bytes_accessed": 0.0}
        return
    if name == "mec_weight_grad":
        g = torch.zeros((n, o_h, o_w, k_c), device="meta")
        got = thlo.flops_bytes(lambda: K.mec_weight_grad(x, g, k_h, k_w, s))
        assert got == {"flops": conv, "bytes_accessed": 0.0}
        return
    if name == "mec_lowered":
        low = K.mec_lower(x, k_w, s)
        assert thlo.flops_bytes(lambda: K.mec_lower(x, k_w, s))["flops"] == 0
        got = thlo.flops_bytes(lambda: K.mec_gemm(
            low, k.reshape(k_h, k_w * i_c, k_c), k_h, s))
    else:
        got = thlo.flops_bytes(lambda: getattr(K, name)(x, k))
    assert got["flops"] == conv
    with pytest.raises(ValueError, match="no flop formula"):
        thlo.kernel_flops("mec_unknown", [], None)
