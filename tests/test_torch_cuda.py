"""The port's CUDA kernels, its conv2d, its planner and its serving path
on the card.

Every test here is marked ``cuda`` and skips without a CUDA card: the
kernels have no CPU mode (on the CPU the wrappers run their plain
versions, which ``tests/test_torch_kernels.py`` holds against the JAX
package).  The file imports torch, numpy and the port only, never jax, so
it runs on a GPU machine without JAX; ``--noconftest`` keeps pytest from
loading the JAX suite's ``tests/conftest.py``:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances, as scale-normalized max errors: a kernel against its plain
version on the same inputs is held to 2 x the contract's forward
tolerance (``numerics.fwd_tolerance``, f32 scaled by sqrt(K/27)), since
each side is held to the budget on its own; K2 is data movement and must
match exactly.  The plain versions run on the card too, with TF32 off.
Gradients through ``conv2d`` on the card are held to the contract's grad
tolerance (``numerics.grad_tolerance``) against f64 autograd through
``F.conv2d``.  K5 (the conv1d) sums in the plain version's order with the
same roundings, so it must equal its plain version to the bit; against the
f64 oracle it is held to ``tests/test_kernels.py``'s tolerance (2e-4 in
f32, 4e-2 below, rtol and atol).  On operands of two dtypes (fault F4)
K1-K5 must equal, to the bit, their f32 runs on the promoted operands
cast back.  A plan on the card must run bit for bit what the kwargs
path runs, and a served conv's CUDA-graph replay what the eager
``conv2d(plan=)`` runs on the same padded class input.  The smoke-size zamba2 served on the card
is held to the same served on the CPU at 1e-4, scale-normalized, in f32.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import conv2d                  # noqa: E402
from repro_torch.core.conv_api import apply_padding  # noqa: E402
from repro_torch.core.numerics import fwd_tolerance, grad_tolerance  # noqa: E402
from repro_torch.kernels import mec_conv as K        # noqa: E402
from repro_torch.configs.archs import smoke_config  # noqa: E402
from repro_torch.kernels import mec_conv1d as C      # noqa: E402
from repro_torch.kernels import ops, ref             # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import lm, serve             # noqa: E402
from repro_torch.models.layers import f32_accumulation  # noqa: E402

pytestmark = pytest.mark.cuda

# (ih, iw, ic, kh, kw, kc, stride, w_blk): tests/test_kernels.py SWEEP,
# then the edges the kernels mask rather than pad: a w-block that does not
# divide o_w, k_c off the 64-channel tile, i_c off the channel chunk, a
# block wider than one 64-column sub-tile, and cv1's k_w = 11 at s_w = 4.
GEOMS = [
    (7, 7, 1, 3, 3, 1, 1, 8),
    (12, 14, 3, 5, 3, 8, 2, 8),
    (9, 9, 4, 3, 3, 6, 1, 8),
    (11, 13, 2, 4, 5, 3, (2, 3), 8),
    (16, 16, 8, 7, 7, 16, 2, 8),
    (8, 8, 3, 1, 1, 4, 1, 8),
    (24, 24, 6, 5, 5, 16, 1, 8),
    (227 // 4, 227 // 4, 3, 11, 11, 8, 4, 8),
    (20, 45, 37, 3, 3, 130, 1, 13),
    (9, 140, 5, 3, 4, 65, (1, 1), 100),
    (67, 67, 3, 11, 11, 96, 4, 15),
]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
IDS = [f"g{i}" for i in range(len(GEOMS))]
# K4: GEOMS at oh_blk = 8, then (ih, iw, ic, kh, kw, kc, stride, w_blk,
# oh_blk) for the three geometries of fault F1 (the TPU kernel's halo view
# is shorter than the halo), k_h < s_h, an oh_blk that does not divide o_h,
# and an oh_blk above the kernel's 16-row sub-tile.
FUSED2_GEOMS = [g + (8,) for g in GEOMS] + [
    (7, 7, 3, 7, 7, 5, 1, 8, 8),
    (6, 6, 3, 5, 5, 5, 1, 8, 8),
    (9, 9, 3, 7, 7, 5, 1, 8, 8),
    (8, 8, 3, 2, 2, 5, 3, 8, 8),
    (23, 19, 5, 3, 3, 7, 1, 17, 5),
    (40, 12, 4, 3, 3, 9, 1, 10, 38),
]
FUSED2_IDS = IDS + ["f1_7x7", "f1_6x6", "f1_9x9", "kh_lt_sh", "ragged_h",
                    "rows_gt_16"]
NO_LAUNCHES = {"mec_conv_fused": 0, "mec_lower": 0, "mec_gemm": 0,
               "mec_conv_fused2": 0, "mec_weight_grad": 0}


@pytest.fixture(autouse=True)
def plan_env(tmp_path, monkeypatch):
    """``algorithm="auto"`` resolves through the plan cache: keep it, and
    the calibration store, under tmp_path (decided per test; no card
    needed)."""
    from repro_torch import plan
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    monkeypatch.setenv("REPRO_TORCH_CALIBRATION", str(tmp_path / "off.json"))
    plan.reset_global_plan_cache()
    plan.reset_calibration_cache()
    yield
    plan.reset_global_plan_cache()
    plan.reset_calibration_cache()


@pytest.fixture
def cuda():
    """The card, with cuBLAS/cuDNN in IEEE f32 for the plain versions;
    skips without one (decided here, not at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


def _operands(geom, dtype, device, batch=2):
    """Seeded numpy input and kernel, as tensors of ``dtype`` on
    ``device``."""
    ih, iw, ic, kh, kw, kc = geom[:6]
    rng = np.random.RandomState(sum(geom[:6]))
    x = rng.randn(batch, ih, iw, ic).astype(np.float32)
    k = (rng.randn(kh, kw, ic, kc) * (kh * kw * ic) ** -0.5).astype(np.float32)
    return (torch.from_numpy(x).to(device, DTYPES[dtype]),
            torch.from_numpy(k).to(device, DTYPES[dtype]))


def _strides(s):
    return (s, s) if isinstance(s, int) else tuple(s)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("geom", GEOMS, ids=IDS)
def test_fused_kernel_matches_plain(cuda, geom, dtype):
    x, k = _operands(geom, dtype, cuda)
    s, w_blk = _strides(geom[6]), geom[7]
    before = K.mec_conv_fused.launches
    y = K.mec_conv_fused(x, k, s, w_blk=w_blk)
    torch.cuda.synchronize()
    assert K.mec_conv_fused.launches == before + 1
    assert y.dtype == x.dtype and y.device == x.device
    tol = 2 * fwd_tolerance("mec_fused", dtype, geom[3] * geom[4] * geom[2])
    assert ref.scaled_error(y, K.mec_conv_fused_plain(x, k, s)) <= tol


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("geom", FUSED2_GEOMS, ids=FUSED2_IDS)
def test_fused2_kernel_matches_plain(cuda, geom, dtype):
    """K4 against its plain version and the f64 oracle, and one launch of
    K4 alone: no fallback to K1, on every geometry."""
    x, k = _operands(geom, dtype, cuda)
    s, w_blk, oh_blk = _strides(geom[6]), geom[7], geom[8]
    K.reset_launch_counts()
    y = K.mec_conv_fused2(x, k, s, w_blk=w_blk, oh_blk=oh_blk)
    torch.cuda.synchronize()
    assert K.launch_counts() == {**NO_LAUNCHES, "mec_conv_fused2": 1}
    assert y.dtype == x.dtype and y.device == x.device
    tol = fwd_tolerance("mec_fused2", dtype, geom[3] * geom[4] * geom[2])
    assert ref.scaled_error(y, K.mec_conv_fused2_plain(x, k, s, oh_blk)) <= 2 * tol
    assert ref.scaled_error(y, ref.conv2d_f64(x, k, s)) <= tol


# Table 2's cv1-cv12 at batch 16: (ih, iw, ic, kh, kw, kc, stride).
TABLE2 = [(227, 227, 3, 11, 11, 96, 4), (231, 231, 3, 11, 11, 96, 4),
          (227, 227, 3, 7, 7, 64, 2), (224, 224, 64, 7, 7, 64, 2),
          (24, 24, 96, 5, 5, 256, 1), (12, 12, 256, 3, 3, 512, 1),
          (224, 224, 3, 3, 3, 64, 1), (112, 112, 64, 3, 3, 128, 1),
          (56, 56, 64, 3, 3, 64, 1), (28, 28, 128, 3, 3, 128, 1),
          (14, 14, 256, 3, 3, 256, 1), (7, 7, 512, 3, 3, 512, 1)]


def test_fused2_launcher_runs_the_picked_block(cuda):
    """K4's launcher owns its sub-tile; ``ops.pick_oh_blk`` sizes blocks by
    a copy of its limits.  The launcher keeps to those limits, and runs
    every block the pickers choose as one sub-tile."""
    assert K.fused2_tile(ops.CTA_ROWS + 3, 1, 3, 3, 1, 1) == (ops.CTA_ROWS, 1)
    assert K.fused2_tile(1, 1000, 3, 3, 1, 1) == (1, ops.CTA_POSITIONS)
    assert K.fused2_tile(4, 1000, 3, 3, 1, 1) == (4, ops.CTA_POSITIONS // 4)
    for batch, geoms in ((2, GEOMS), (1, TABLE2), (16, TABLE2)):
        for ih, iw, _, kh, kw, kc, s, *_ in geoms:
            s_h, s_w = _strides(s)
            o_h, o_w = (ih - kh) // s_h + 1, (iw - kw) // s_w + 1
            w_blk = ops.pick_fused_w_blk(o_w, kc, batch, o_h)
            oh_blk = ops.pick_oh_blk(o_h, o_w, w_blk, kc, batch)
            assert K.fused2_tile(oh_blk, w_blk, kh, kw, s_h, s_w) == \
                (oh_blk, w_blk), (ih, iw, kh, kw, s, batch)


def _fused_pair(x, k, s):
    """K1 and K4 at the pickers' blocks: (kernel, run, plain, config)."""
    s_h, s_w = _strides(s)
    i_n, i_h, i_w, _ = x.shape
    k_h, k_w, _, k_c = k.shape
    o_h, o_w = (i_h - k_h) // s_h + 1, (i_w - k_w) // s_w + 1
    w_blk = ops.pick_fused_w_blk(o_w, k_c, i_n, o_h)
    oh_blk = ops.pick_oh_blk(o_h, o_w, w_blk, k_c, i_n)
    return (
        (1, lambda: K.mec_conv_fused(x, k, s, w_blk=w_blk),
         lambda: K.mec_conv_fused_plain(x, k, s),
         K.fused_config(1, x.dtype, x.shape, k.shape, s, w_blk, oh_blk)),
        (4, lambda: K.mec_conv_fused2(x, k, s, w_blk=w_blk, oh_blk=oh_blk),
         lambda: K.mec_conv_fused2_plain(x, k, s, oh_blk),
         K.fused_config(4, x.dtype, x.shape, k.shape, s, w_blk, oh_blk)))


def _check_fused_pair(x, k, s, dtype, reduction):
    """Each of K1 and K4 within the contract against the f64 oracle and 2x
    it against its plain version; returns their configs."""
    tol = fwd_tolerance("mec_fused", dtype, reduction)
    oracle = ref.conv2d_f64(x, k, s)
    configs = {}
    for kernel, run, plain, cfg in _fused_pair(x, k, s):
        y = run()
        torch.cuda.synchronize()
        assert y.dtype == x.dtype and y.shape == oracle.shape
        assert ref.scaled_error(y, oracle) <= tol, (kernel, cfg)
        assert ref.scaled_error(y, plain()) <= 2 * tol, (kernel, cfg)
        configs[kernel] = cfg
    return configs


# cv11 and cv12 (Table 2), whose grids are short of the SMs: the launcher
# splits their reduction across a thread-block cluster.
SPLIT_LAYERS = {"cv11": (14, 14, 256, 3, 3, 256, 1),
                "cv12": (7, 7, 512, 3, 3, 512, 1)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("layer", list(SPLIT_LAYERS))
def test_fused_kernels_split_the_reduction_over_a_cluster(cuda, layer, batch,
                                                          dtype):
    """K1 and K4 on cv11 and cv12 at batch 1 and 16: within the contract,
    with the reduction split across a cluster where the grid is short of
    the SMs (both kernels at batch 1, K4 at batch 16), and equal to the
    bit on a second run (the leader adds the partial sums in rank
    order)."""
    geom = SPLIT_LAYERS[layer]
    x, k = _operands(geom, dtype, cuda, batch=batch)
    configs = _check_fused_pair(x, k, 1, dtype, 9 * geom[2])
    assert configs[4]["split"] > 1
    assert batch == 16 or configs[1]["split"] > 1
    for _, run, _, _ in _fused_pair(x, k, 1):
        assert torch.equal(run(), run())


# (ih, iw, ic, kh, kw, kc, stride): i_c = 3 at s_w = 4 (rows of 12 or 6
# bytes, window starts off every alignment), an odd i_c past the compact
# path (2-byte copies in bf16/f16), an i_c whose rows take 8-byte copies.
UNALIGNED = [(31, 43, 3, 11, 11, 16, 4), (10, 21, 37, 3, 3, 20, 2),
             (9, 30, 20, 3, 5, 12, (1, 3))]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("geom", UNALIGNED, ids=["ic3_sw4", "ic37", "ic20"])
def test_fused_kernels_on_unaligned_channels(cuda, geom, dtype):
    x, k = _operands(geom, dtype, cuda)
    _check_fused_pair(x, k, _strides(geom[6]), dtype,
                      geom[2] * geom[3] * geom[4])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("i_c", [4, 32])
@pytest.mark.parametrize("k_c", [1, 3, 5, 6])
def test_fused_kernels_with_fewer_channels_than_an_mma_tile(cuda, k_c, i_c,
                                                            dtype):
    """k_c below the n8 MMA tile, on the compact (i_c = 4) and the channel
    (i_c = 32) path."""
    geom = (10, 11, i_c, 3, 3, k_c, 1)
    x, k = _operands(geom, dtype, cuda)
    _check_fused_pair(x, k, 1, dtype, 9 * i_c)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("i_c", [3, 40])
def test_fused_kernels_take_a_misaligned_input_view(cuda, i_c, dtype):
    """An input that starts one element into its storage: the compact
    path stages from the 16-byte boundary below each row, the channel path
    narrows its copies."""
    shape = (2, 12, 13, i_c)
    n = 2 * 12 * 13 * i_c
    g = torch.Generator(cuda).manual_seed(11)
    flat = torch.randn((n + 1,), generator=g, device=cuda).to(DTYPES[dtype])
    x = flat[1:].view(shape)
    assert x.data_ptr() % 16 != 0
    k = (torch.randn((3, 3, i_c, 24), generator=g, device=cuda)
         * (9 * i_c) ** -0.5).to(DTYPES[dtype])
    _check_fused_pair(x, k, 1, dtype, 9 * i_c)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("i_c", [3, 40])
def test_fused_kernels_keep_an_inf_to_the_windows_that_hold_it(cuda, i_c, dtype):
    """An Inf just past the first window of a row, on the compact (i_c = 3,
    whose MMA depth runs past k_w*i_c into the next columns) and the channel
    path: the outputs whose windows hold it are not finite, all others are
    finite and within the contract of the oracle on the input without it."""
    geom = (10, 12, i_c, 3, 3, 16, 1)
    x, k = _operands(geom, dtype, cuda)
    inf_h, inf_w = 2, 5
    clean = x.clone()
    clean[0, inf_h, inf_w, 0] = 0
    x[0, inf_h, inf_w, 0] = float("inf")
    oracle = ref.conv2d_f64(clean, k, 1)
    holds = torch.zeros(oracle.shape[:3], dtype=torch.bool, device=cuda)
    holds[0, inf_h - 2:inf_h + 1, inf_w - 2:inf_w + 1] = True
    tol = fwd_tolerance("mec_fused", dtype, 9 * i_c)
    for kernel, run, _, cfg in _fused_pair(x, k, 1):
        assert cfg["compact"] == (i_c <= 16), (kernel, cfg)
        y = run()
        torch.cuda.synchronize()
        assert not torch.isfinite(y[holds]).any(), (kernel, cfg)
        assert torch.isfinite(y[~holds]).all(), (kernel, cfg)
        assert ref.scaled_error(y[~holds], oracle[~holds]) <= tol, (kernel, cfg)


def test_fused_kernels_take_inputs_past_2_31_bytes(cuda):
    """A bf16 input of 2.17 GB: 64-bit offsets.  The last output rows of
    the last image against the plain version on the rows they read."""
    g = torch.Generator(cuda).manual_seed(13)
    x = torch.randn((2, 1030, 1030, 512), generator=g, device=cuda,
                    dtype=torch.bfloat16)
    assert x.numel() * x.element_size() > 2 ** 31
    k = (torch.randn((3, 3, 512, 8), generator=g, device=cuda)
         * (9 * 512) ** -0.5).to(torch.bfloat16)
    tol = fwd_tolerance("mec_fused", "bfloat16", 9 * 512)
    want = K.mec_conv_fused_plain(x[1:, -6:], k, 1)
    for kernel, run, _, _ in _fused_pair(x, k, 1):
        y = run()[1:, -4:]
        torch.cuda.synchronize()
        assert ref.scaled_error(y, want) <= 2 * tol, kernel
        del y


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("geom", GEOMS, ids=IDS)
def test_lower_kernel_matches_plain(cuda, geom, dtype):
    x, _ = _operands(geom, dtype, cuda)
    s_w = _strides(geom[6])[1]
    before = K.mec_lower.launches
    low = K.mec_lower(x, geom[4], s_w)
    torch.cuda.synchronize()
    assert K.mec_lower.launches == before + 1
    assert torch.equal(low, K.mec_lower_plain(x, geom[4], s_w))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("geom", GEOMS, ids=IDS)
def test_gemm_kernel_matches_plain(cuda, geom, dtype):
    ih, iw, ic, kh, kw, kc, s, w_blk = geom
    s_h, s_w = _strides(s)
    x, k = _operands(geom, dtype, cuda)
    low = K.mec_lower_plain(x, kw, s_w)
    kmat = k.reshape(kh, kw * ic, kc)
    before = K.mec_gemm.launches
    y = K.mec_gemm(low, kmat, kh, s_h, w_blk=w_blk)
    torch.cuda.synchronize()
    assert K.mec_gemm.launches == before + 1
    tol = 2 * fwd_tolerance("mec_lowered", dtype, kh * kw * ic)
    assert ref.scaled_error(y, K.mec_gemm_plain(low, kmat, kh, s_h)) <= tol


# K3 at its pickers' blocks: (name, (ih, iw, ic, kh, kw, kc, stride), batch)
# for tests/test_kernels.py SWEEP, fault F1's geometries and k_h < s_h at
# batch 2, Table 2's cv1-cv12 at batch 1, and cv11 and cv12 at batch 16.
GEMM_CASES = ([(f"sweep{i}", g[:7], 2) for i, g in enumerate(GEOMS[:8])]
              + [(n, g[:7], 2) for n, g in zip(FUSED2_IDS[-6:-2], FUSED2_GEOMS[-6:-2])]
              + [(f"cv{i + 1}", g, 1) for i, g in enumerate(TABLE2)]
              + [("cv11", TABLE2[10], 16), ("cv12", TABLE2[11], 16)])


def _gemm_operands(geom, dtype, device, batch):
    """L (the plain lowering of the seeded input) and kernel_mat."""
    x, k = _operands(geom, dtype, device, batch)
    kh, kw, ic, kc = geom[3], geom[4], geom[2], geom[5]
    return (K.mec_lower_plain(x, kw, _strides(geom[6])[1]),
            k.reshape(kh, kw * ic, kc), x, k)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name,geom,batch", GEMM_CASES,
                         ids=[f"{n}-b{b}" for n, _, b in GEMM_CASES])
def test_gemm_kernel_holds_the_contract(cuda, name, geom, batch, dtype):
    """K3 (the tensor-core core on L read as an image) at its pickers'
    blocks: one launch, within the contract against the f64 oracle and 2x
    it against its plain version."""
    kh, s_h = geom[3], _strides(geom[6])[0]
    low, kmat, x, k = _gemm_operands(geom, dtype, cuda, batch)
    before = K.mec_gemm.launches
    y = K.mec_gemm(low, kmat, kh, s_h)
    torch.cuda.synchronize()
    assert K.mec_gemm.launches == before + 1
    assert y.dtype == x.dtype and y.is_contiguous()
    tol = fwd_tolerance("mec_lowered", dtype, kh * geom[4] * geom[2])
    oracle = ref.conv2d_f64(x, k, _strides(geom[6]))
    assert y.shape == oracle.shape
    assert ref.scaled_error(y, oracle) <= tol
    assert ref.scaled_error(y, K.mec_gemm_plain(low, kmat, kh, s_h)) <= 2 * tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("layer", list(SPLIT_LAYERS))
def test_gemm_kernel_splits_the_reduction_over_a_cluster(cuda, layer, batch, dtype):
    """K3 on cv11 and cv12 at batch 1 and 16: the grid is short of the SMs,
    so a cluster splits the reduction; within the contract, and equal to
    the bit on a second run."""
    geom = SPLIT_LAYERS[layer]
    low, kmat, x, k = _gemm_operands(geom, dtype, cuda, batch)
    assert K.gemm_config(x.dtype, low.shape, kmat.shape, 3, 1)["split"] > 1
    y = K.mec_gemm(low, kmat, 3, 1)
    tol = fwd_tolerance("mec_lowered", dtype, 9 * geom[2])
    assert ref.scaled_error(y, ref.conv2d_f64(x, k, 1)) <= tol
    assert torch.equal(y, K.mec_gemm(low, kmat, 3, 1))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("i_c", [3, 40])
def test_gemm_kernel_keeps_an_inf_to_the_windows_that_hold_it(cuda, i_c, dtype):
    """An Inf in L just past the first output row's window (row 3 of a
    3-row kernel), on the compact path (k_w*i_c = 9, whose MMA depth runs
    past the window into the next rows of L) and the channel path: the
    outputs whose windows hold it are not finite, all others are finite
    and within the contract of the oracle on L without it."""
    geom = (10, 12, i_c, 3, 3, 16, 1)
    low, kmat, _, _ = _gemm_operands(geom, dtype, cuda, 2)
    inf_w, inf_row = 4, 3
    clean = low.clone()
    clean[0, inf_w, inf_row, 0] = 0
    low[0, inf_w, inf_row, 0] = float("inf")
    assert K.gemm_config(low.dtype, low.shape, kmat.shape, 3, 1)["compact"] == (3 * i_c <= 16)
    y = K.mec_gemm(low, kmat, 3, 1)
    torch.cuda.synchronize()
    oracle = K.mec_gemm_plain(clean.double(), kmat.double(), 3, 1)
    holds = torch.zeros(oracle.shape[:3], dtype=torch.bool, device=cuda)
    holds[0, inf_row - 2:inf_row + 1, inf_w] = True        # output rows 1 .. 3
    assert not torch.isfinite(y[holds]).any()
    assert torch.isfinite(y[~holds]).all()
    assert ref.scaled_error(y[~holds], oracle[~holds]) <= \
        fwd_tolerance("mec_lowered", dtype, 9 * i_c)


@pytest.mark.parametrize("layer", list(SPLIT_LAYERS))
def test_mec_lowered_allocates_l_and_o(cuda, layer):
    """mode="lowered" at batch 16 allocates the compact L (paper Eq. 3)
    and O and nothing else: K3 keeps no workspace (2 MiB of slack for the
    allocator's rounding)."""
    x, k = _operands(SPLIT_LAYERS[layer], "float32", cuda, batch=16)
    i_n, i_h, i_w, i_c = x.shape
    k_h, k_w, _, k_c = k.shape
    o_h, o_w = i_h - k_h + 1, i_w - k_w + 1
    need = (i_n * o_w * i_h * k_w * i_c + i_n * o_h * o_w * k_c) * 4
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    y = ops.mec_conv2d_cuda(x, k, 1, mode="lowered")
    torch.cuda.synchronize()
    assert K.launch_counts() == {**NO_LAUNCHES, "mec_lower": 1, "mec_gemm": 1}
    assert need <= torch.cuda.max_memory_allocated() - base <= need + (2 << 20)
    del y


def test_kernels_take_non_contiguous_operands(cuda):
    x, k = _operands((12, 14, 6, 3, 3, 10, 1), "float32", cuda)
    x_t = x.transpose(1, 2).contiguous().transpose(1, 2)    # same values
    assert not x_t.is_contiguous()
    tol = 2 * fwd_tolerance("mec_fused", "float32", 3 * 3 * 6)
    assert ref.scaled_error(K.mec_conv_fused(x_t, k, 1),
                            K.mec_conv_fused_plain(x, k, 1)) <= tol
    assert torch.equal(K.mec_lower(x_t, 3, 1), K.mec_lower_plain(x, 3, 1))


@pytest.mark.parametrize("padding", ["VALID", "SAME", ((1, 2), (0, 3))])
@pytest.mark.parametrize("stride", [1, 2, (2, 3)])
def test_conv2d_on_the_card_runs_the_kernels(cuda, padding, stride):
    """conv2d on CUDA tensors: auto resolves to K1, mec_lowered runs K2 +
    K3, and both agree with the same call on CPU tensors (the kernels'
    plain versions)."""
    x, k = _operands((15, 17, 5, 3, 4, 7, 1), "float32", cuda)
    tol = 2 * fwd_tolerance("mec_fused", "float32", 3 * 4 * 5)
    for algorithm, launched in (("auto", {"mec_conv_fused": 1}),
                                ("mec_fused", {"mec_conv_fused": 1}),
                                ("mec_fused2", {"mec_conv_fused2": 1}),
                                ("mec_lowered", {"mec_lower": 1, "mec_gemm": 1})):
        K.reset_launch_counts()
        y = conv2d(x, k, stride=stride, padding=padding, algorithm=algorithm)
        torch.cuda.synchronize()
        assert K.launch_counts() == {**NO_LAUNCHES, **launched}, algorithm
        y_cpu = conv2d(x.cpu(), k.cpu(), stride=stride, padding=padding,
                       algorithm=algorithm)
        assert y.device == x.device and y.shape == y_cpu.shape
        assert ref.scaled_error(y.cpu(), y_cpu) <= tol, algorithm


@pytest.mark.parametrize("algorithm", ["mec_fused2", "mec_fused", "mec_lowered"])
@pytest.mark.parametrize("stride", [1, 2, (2, 3)])
def test_mec_backward_on_the_card_matches_f64_autograd(cuda, stride, algorithm):
    """d_input and d_kernel of sum(out * g) through the MEC VJP on the card
    against autograd through the f64 direct conv; the forward launches
    the algorithm's kernels and the backward exactly one K6
    (``mec_weight_grad``) for the conv."""
    x, k = _operands((15, 17, 5, 3, 4, 7, 1), "float32", cuda)
    x64 = x.double().requires_grad_()
    k64 = k.double().requires_grad_()
    x.requires_grad_()
    k.requires_grad_()
    K.reset_launch_counts()
    y = conv2d(x, k, stride=stride, padding="SAME", algorithm=algorithm)
    fwd_counts = K.launch_counts()
    g = torch.randn(y.shape, generator=torch.Generator(cuda).manual_seed(3),
                    device=cuda)
    y.backward(g)
    torch.cuda.synchronize()
    assert K.launch_counts() == {**fwd_counts, "mec_weight_grad": 1}
    conv2d(x64, k64, stride=stride, padding="SAME",
           algorithm="direct").backward(g.double())
    i_n, o_h, o_w, k_c = y.shape
    assert ref.scaled_error(x.grad, x64.grad) <= \
        grad_tolerance(algorithm, "float32", 3 * 4 * k_c)
    assert ref.scaled_error(k.grad, k64.grad) <= \
        grad_tolerance(algorithm, "float32", i_n * o_h * o_w)


# K6, the MEC weight gradient: the five Table-3 layers (ih, iw, ic, kh, kw,
# kc, stride; cv4's k_w*i_c = 448), then i_c = 3 at cv1's k_w = 11, s_h >
# k_h, stride (2, 3), k_c off the 64-channel tile with i_c off the
# 32-channel chunk, a patch embed (k = s = 14), stride 16 (the launcher
# halves the channel chunk to fit shared memory) and k_w = 17 (two blocks
# of kernel columns)
WGRAD_GEOMS = [(224, 224, 64, 7, 7, 64, 2), (56, 56, 64, 3, 3, 64, 1),
               (28, 28, 128, 3, 3, 128, 1), (14, 14, 256, 3, 3, 256, 1),
               (7, 7, 512, 3, 3, 512, 1), (227, 227, 3, 11, 11, 96, 4),
               (8, 8, 3, 2, 2, 5, 3), (11, 13, 2, 4, 5, 3, (2, 3)),
               (20, 45, 37, 3, 3, 130, 1), (56, 56, 3, 14, 14, 40, 14),
               (66, 66, 64, 3, 3, 8, 16), (20, 24, 32, 3, 17, 8, 1)]
WGRAD_IDS = ["cv4", "cv9", "cv10", "cv11", "cv12", "ic3_k11", "sh_gt_kh",
             "s23", "kc130", "patch14", "s16", "kw17"]


def _cotangent(geom, device, batch=2):
    """A seeded cotangent of the conv's output shape."""
    ih, iw, _, kh, kw, kc = geom[:6]
    s_h, s_w = _strides(geom[6])
    rng = np.random.RandomState(sum(geom[:6]) + 1)
    g = rng.randn(batch, (ih - kh) // s_h + 1, (iw - kw) // s_w + 1, kc)
    return torch.from_numpy(g.astype(np.float32)).to(device)


@pytest.mark.parametrize("geom", WGRAD_GEOMS, ids=WGRAD_IDS)
def test_weight_grad_kernel_matches_plain(cuda, geom):
    """K6 against its plain version (the compact L and k_h einsums, in
    IEEE f32 on the card) at batch 2: one launch of K6 alone, dW in f32
    within twice the f32 gradient budget, and equal bits on a second
    launch."""
    x, _ = _operands(geom, "float32", cuda)
    g = _cotangent(geom, cuda)
    kh, kw, s = geom[3], geom[4], _strides(geom[6])
    K.reset_launch_counts()
    dw = K.mec_weight_grad(x, g, kh, kw, s)
    torch.cuda.synchronize()
    assert K.launch_counts() == {**NO_LAUNCHES, "mec_weight_grad": 1}
    assert dw.dtype == torch.float32 and dw.shape == (kh, kw, geom[2], geom[5])
    tol = 2 * grad_tolerance("mec_fused2", "float32",
                             g.shape[0] * g.shape[1] * g.shape[2])
    assert ref.scaled_error(dw, K.mec_weight_grad_plain(x, g, kh, kw, s)) <= tol
    assert torch.equal(dw, K.mec_weight_grad(x, g, kh, kw, s))


def test_weight_grad_kernel_splits_the_positions_deterministically(cuda):
    """cv9 at batch 16: the launcher splits the positions over CTAs (a
    workspace and a second pass that adds the splits in order); the
    result is within budget of the plain version and equal to the bit on
    every launch."""
    geom = (56, 56, 64, 3, 3, 64, 1)
    x, _ = _operands(geom, "float32", cuda, batch=16)
    g = _cotangent(geom, cuda, batch=16)
    cfg = K.wgrad_config(x.shape, g.shape, 3, 3, 1)
    assert cfg["splits"] > 1 and cfg["workspace"] == cfg["splits"] * 3 * 3 * 64 * 64
    first = K.mec_weight_grad(x, g, 3, 3, 1)
    tol = 2 * grad_tolerance("mec_fused2", "float32", 16 * 54 * 54)
    assert ref.scaled_error(first, K.mec_weight_grad_plain(x, g, 3, 3, 1)) <= tol
    for _ in range(3):
        assert torch.equal(first, K.mec_weight_grad(x, g, 3, 3, 1))


def test_weight_grad_kernel_casts_other_dtypes_and_strided_inputs(cuda):
    """bf16 operands are cast to f32 first (the same bits as the f32 call
    on their values), and a strided input is made contiguous."""
    geom = (12, 14, 6, 3, 3, 10, 1)
    x, _ = _operands(geom, "float32", cuda)
    g = _cotangent(geom, cuda)
    xb, gb = x.bfloat16(), g.bfloat16()
    assert torch.equal(K.mec_weight_grad(xb, gb, 3, 3, 1),
                       K.mec_weight_grad(xb.float(), gb.float(), 3, 3, 1))
    x_t = x.transpose(1, 2).contiguous().transpose(1, 2)    # same values
    assert not x_t.is_contiguous()
    assert torch.equal(K.mec_weight_grad(x_t, g, 3, 3, 1),
                       K.mec_weight_grad(x, g, 3, 3, 1))


# ---------------------------------------------------------------------------
# the planner on the card
# ---------------------------------------------------------------------------

PLAN_ALGOS = ("direct", "im2col", "fft", "winograd", "mec", "mec_lowered",
              "mec_fused", "mec_fused2")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("algorithm", PLAN_ALGOS)
def test_conv2d_plan_on_the_card_is_the_kwargs_path(cuda, algorithm, dtype):
    """A plan on CUDA operands runs the planned kernels with the plan's
    block: bit for bit the kwargs path for the MEC kernels, and for every
    algorithm within its contract of f64 (fft and winograd included)."""
    from repro_torch.core import conv2d_spec
    from repro_torch.plan import ConvPlan, plan_conv2d
    from repro_torch.plan.convplan import _kernel_w_blk
    x, k = _operands((15, 17, 8, 3, 3, 24, 1), dtype, cuda)
    spec = conv2d_spec(x, k, padding="SAME")
    plan = ConvPlan(spec=spec, dtype=dtype, algorithm=algorithm,
                    w_blk=_kernel_w_blk(spec, algorithm), backend="cuda")
    K.reset_launch_counts()
    y = conv2d(x, k, padding="SAME", plan=plan)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    want = conv2d(x, k, padding="SAME", algorithm=algorithm)
    if algorithm in ("mec_fused", "mec_fused2", "mec_lowered"):
        assert torch.equal(y, want)
        assert sum(counts.values()) == (2 if algorithm == "mec_lowered" else 1)
    else:
        assert counts == NO_LAUNCHES
    from repro_torch.core.conv_api import apply_padding
    oracle = ref.conv2d_f64(apply_padding(x, 3, 3, 1, 1, "SAME"), k, 1)
    assert ref.scaled_error(y, oracle) <= fwd_tolerance(algorithm, dtype, 72)
    with pytest.raises(ValueError, match="backend mismatch"):
        conv2d(x.cpu(), k.cpu(), padding="SAME", plan=plan)
    assert plan_conv2d(spec, dtype=dtype).algorithm == "mec_fused"


def test_measured_plan_on_the_card_times_every_kernel(cuda):
    """The measured race on the card times every candidate, skips none of
    K1, K2+K3 and K4, and records its trials in the calibration store;
    the plan it returns runs."""
    from repro_torch.core.convspec import ConvSpec
    from repro_torch.plan import CalibrationStore
    from repro_torch.plan.convplan import tune_measured
    spec = ConvSpec(4, 16, 16, 32, 3, 3, 64)
    plan, detail = tune_measured(spec, "bfloat16", iters=3)
    assert set(detail["candidate_us"]) == set(PLAN_ALGOS)
    assert detail["skipped"] == {}
    assert detail["analytic_algorithm"] == "mec_fused"
    assert (plan.backend, plan.mode, plan.dtype) == ("cuda", "measured",
                                                     "bfloat16")
    stored = CalibrationStore(backend="cuda").load()
    assert set(stored.cell_times(spec)) == set(PLAN_ALGOS)
    x, k = _operands((16, 16, 32, 3, 3, 64, 1), "bfloat16", cuda, batch=4)
    y = conv2d(x, k, plan=plan)
    assert ref.scaled_error(y, ref.conv2d_f64(x, k, 1)) <= \
        fwd_tolerance(plan.algorithm, "bfloat16", 3 * 3 * 32)


def test_launcher_gate_on_the_card_refuses_only_by_design(cuda):
    """The planner's launcher gate on the card: a plan the launcher takes
    passes, a dtype it has no instance for is refused with a reason (and
    so skipped by the race), and ``ops.launch_config``'s default block is
    the one the executor runs."""
    from repro_torch.core.convspec import ConvSpec
    from repro_torch.plan.convplan import ConvPlan, _kernel_w_blk, launcher_check
    spec = ConvSpec(16, 14, 14, 256, 3, 3, 256)
    for alg, mode in (("mec_fused", "fused"), ("mec_fused2", "fused2"),
                      ("mec_lowered", "lowered")):
        w_blk = _kernel_w_blk(spec, alg)
        ok = ConvPlan(spec=spec, dtype="float32", algorithm=alg, w_blk=w_blk,
                      backend="cuda")
        assert launcher_check(ok) is None
        shapes = ((16, 14, 14, 256), (3, 3, 256, 256), 1)
        assert ops.launch_config(mode, torch.float32, *shapes) == \
            ops.launch_config(mode, torch.float32, *shapes, w_blk=w_blk)
        f64 = ConvPlan(spec=spec, dtype="float64", algorithm=alg, w_blk=w_blk,
                       backend="cuda")
        assert "no instance" in launcher_check(f64)


@pytest.mark.parametrize("algorithm", ["mec_fused", "mec_fused2", "mec_lowered"])
def test_measured_race_on_the_card_raises_when_a_kernel_fails(cuda, monkeypatch,
                                                              algorithm):
    """A kernel whose launch fails on the card stops the measured race with
    the failure; the race does not pick another algorithm."""
    from repro_torch.core.convspec import ConvSpec
    from repro_torch.plan.convplan import tune_measured

    def fail(*a, **kw):
        raise RuntimeError("mec_fused: CUDA error 700 (an illegal memory access)")

    monkeypatch.setattr(K, "_launch", fail)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        tune_measured(ConvSpec(4, 16, 16, 32, 3, 3, 64), "bfloat16", iters=1,
                      candidates=("direct", algorithm), record=False)


def test_auto_on_the_card_plans_k1_through_the_cache(cuda):
    """``auto`` on CUDA operands resolves through the plan cache to K1
    with the block K1's launcher picks, and the plan lands on disk."""
    from repro_torch.core import conv2d_spec
    from repro_torch.plan import PlanCache, global_plan_cache
    x, k = _operands((14, 14, 256, 3, 3, 256, 1), "float32", cuda, batch=16)
    spec = conv2d_spec(x, k)
    K.reset_launch_counts()
    conv2d(x, k)
    assert K.launch_counts() == {**NO_LAUNCHES, "mec_conv_fused": 1}
    key = "16x14x14x256-k3x3x256-s1x1|float32|cuda"
    hit = global_plan_cache().get(key)
    assert (hit.algorithm, hit.w_blk) == (
        "mec_fused", ops.pick_fused_w_blk(spec.o_w, 256, 16, spec.o_h))
    assert PlanCache().get(key) == hit


def test_mixed_devices_raise(cuda):
    x, k = _operands((9, 9, 4, 3, 3, 6, 1), "float32", cuda)
    with pytest.raises(ValueError, match="kernel on"):
        conv2d(x, k.cpu())
    with pytest.raises(ValueError, match="different devices"):
        ops.mec_conv2d_cuda(x.cpu(), k)


# ---------------------------------------------------------------------------
# K5: causal depthwise conv1d
# ---------------------------------------------------------------------------

# (t, c, k_w): tests/test_kernels.py's cases, fault F2's k_w = 1, a time
# tile that does not divide t, channels off the 128-thread CTA, and the
# widest instantiated kernel.
CONV1D_CASES = [(10, 5, 4), (1024, 256, 4), (33, 7, 3), (512, 64, 2),
                (5, 3, 4), (10, 5, 1), (1024, 8, 1), (100, 130, 8),
                (65, 300, 6)]
CONV1D_TOL = {"float32": 2e-4, "bfloat16": 4e-2, "float16": 4e-2}


def _conv1d_operands(t, c, k_w, dtype, device, batch=2):
    rng = np.random.RandomState(t + 7 * c + 31 * k_w)
    x = rng.randn(batch, t, c).astype(np.float32)
    k = rng.randn(k_w, c).astype(np.float32)
    return (torch.from_numpy(x).to(device, DTYPES[dtype]),
            torch.from_numpy(k).to(device, DTYPES[dtype]))


def _within(y, oracle, tol) -> bool:
    return torch.allclose(y.double(), oracle, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("t,c,k_w", CONV1D_CASES)
def test_conv1d_kernel_matches_plain(cuda, t, c, k_w, dtype):
    x, k = _conv1d_operands(t, c, k_w, dtype, cuda)
    before = C.mec_conv1d.launches
    y = C.mec_conv1d(x, k)
    torch.cuda.synchronize()
    assert C.mec_conv1d.launches == before + 1
    assert y.dtype == x.dtype and y.shape == x.shape and y.is_contiguous()
    assert torch.equal(y, C.mec_conv1d_plain(x, k))
    assert _within(y, ref.conv1d_ref(x.double(), k.double()), CONV1D_TOL[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_conv1d_kernel_at_the_zamba2_shape_on_a_column_slice(cuda, dtype):
    """(4, 512, 7296, k_w = 4): the conv input of every zamba2-7b Mamba2
    layer, columns 7168 .. 14463 of its 14576-wide in_proj output."""
    g = torch.Generator(cuda).manual_seed(5)
    zxbcdt = torch.randn((4, 512, 14576), generator=g, device=cuda).to(DTYPES[dtype])
    x = zxbcdt[..., 7168:14464]
    k = torch.randn((4, 7296), generator=g, device=cuda).to(DTYPES[dtype])
    y = C.mec_conv1d(x, k)
    assert torch.equal(y, C.mec_conv1d_plain(x.contiguous(), k))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_conv1d_kernel_at_the_xlstm_shape_on_a_strided_view(cuda, dtype):
    """(8, 1024, 1536, k_w = 4): the conv input of every xlstm-125m mLSTM
    block at chip_smoke's prefill, x_in, the first half of each
    3072-wide row of the up projection, read through its strides (no
    copy): one launch, equal to the plain version to the bit.  CPU
    counterpart: tests/test_torch_xlstm.py
    test_k5_runs_once_a_block_in_prefill_and_never_in_decode."""
    g = torch.Generator(cuda).manual_seed(11)
    up = torch.randn((8, 1024, 3072), generator=g, device=cuda).to(DTYPES[dtype])
    x = up[..., :1536]
    k = torch.randn((4, 1536), generator=g, device=cuda).to(DTYPES[dtype])
    before = C.mec_conv1d.launches
    y = C.mec_conv1d(x, k)
    torch.cuda.synchronize()
    assert C.mec_conv1d.launches == before + 1
    assert C.vector_bytes(x, k, y) == 16
    assert torch.equal(y, C.mec_conv1d_plain(x.contiguous(), k))
    assert _within(y, ref.conv1d_ref(x.double(), k.double()), CONV1D_TOL[dtype])


# (dtype, first column, c, vector bytes): the zamba2 column slice (columns
# 7168 .. 14463 of a 14576-wide row), slices moved by 1, 2 and 4 elements,
# and a c off the 16-byte vector: every vector width of every dtype
VECTOR_CASES = [(d, lo, c, vb) for d in ("bfloat16", "float16")
                for lo, c, vb in ((7168, 7296, 16), (7169, 7296, 2), (7170, 7296, 4),
                                  (7172, 7296, 8), (7168, 7297, 2), (7168, 7300, 8))]
VECTOR_CASES += [("float32", lo, c, vb)
                 for lo, c, vb in ((7168, 7296, 16), (7169, 7296, 4), (7170, 7296, 8),
                                   (7168, 7298, 8), (7168, 7297, 4))]


@pytest.mark.parametrize("dtype,lo,c,vb", VECTOR_CASES)
def test_conv1d_kernel_at_every_vector_width(cuda, dtype, lo, c, vb):
    """A column slice of a (4, 512, 14576) row, as the Mamba2 block passes
    it, at the vector width its alignment allows: equal to the plain
    version to the bit for every k_w of 1..8."""
    g = torch.Generator(cuda).manual_seed(lo + c)
    row = torch.randn((4, 512, 14576), generator=g, device=cuda).to(DTYPES[dtype])
    x = row[..., lo:lo + c]
    for k_w in range(1, C.MAX_KW + 1):
        k = torch.randn((k_w, c), generator=g, device=cuda).to(DTYPES[dtype])
        y = C.mec_conv1d(x, k)
        assert C.vector_bytes(x, k, y) == vb
        assert torch.equal(y, C.mec_conv1d_plain(x.contiguous(), k)), k_w


def test_conv1d_kernel_refuses_what_it_does_not_take(cuda):
    x, k = _conv1d_operands(10, 5, 4, "float32", cuda)
    with pytest.raises(ValueError, match="different devices"):
        C.mec_conv1d(x, k.cpu())
    with pytest.raises(TypeError):
        C.mec_conv1d(x.double(), k.double())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k_w", [9, 16, 33])
@pytest.mark.parametrize("layout", ["contiguous", "column_slice"])
def test_conv1d_kernel_above_max_kw_equals_plain_fault_f5(cuda, layout, k_w,
                                                          dtype):
    """Above MAX_KW (fault F5) K5 takes k_w at run time and still equals
    its plain version to the bit, on a contiguous input with a ragged
    time tile and channels off the CTA, and on a column slice."""
    assert k_w > C.MAX_KW
    g = torch.Generator(cuda).manual_seed(k_w)
    if layout == "contiguous":
        x = torch.randn((2, 100, 130), generator=g, device=cuda).to(DTYPES[dtype])
    else:
        row = torch.randn((2, 77, 300), generator=g, device=cuda).to(DTYPES[dtype])
        x = row[..., 40:261]
    k = torch.randn((k_w, x.shape[2]), generator=g, device=cuda).to(DTYPES[dtype])
    before = C.mec_conv1d.launches
    y = C.mec_conv1d(x, k)
    torch.cuda.synchronize()
    assert C.mec_conv1d.launches == before + 1
    assert y.dtype == x.dtype and y.shape == x.shape and y.is_contiguous()
    assert torch.equal(y, C.mec_conv1d_plain(x.contiguous(), k))
    assert _within(y, ref.conv1d_ref(x.double(), k.double()), CONV1D_TOL[dtype])


# (x dtype, kernel dtype): fault F4's pairs
MIXED = [("bfloat16", "float32"), ("float32", "bfloat16"), ("float16", "bfloat16")]


@pytest.mark.parametrize("k_w", [4, 9])
@pytest.mark.parametrize("x_dtype,k_dtype", MIXED)
def test_conv1d_kernel_on_mixed_dtypes_fault_f4(cuda, x_dtype, k_dtype, k_w):
    """x and kernel of two dtypes: K5 runs on both promoted (the f32
    instance), equal to the bit to that run cast to x's dtype and to the
    plain version on the same operands."""
    x, _ = _conv1d_operands(1024, 256, k_w, x_dtype, cuda)
    _, k = _conv1d_operands(1024, 256, k_w, k_dtype, cuda)
    y = C.mec_conv1d(x, k)
    assert y.dtype == x.dtype
    assert torch.equal(y, C.mec_conv1d(x.float(), k.float()).to(x.dtype))
    assert torch.equal(y, C.mec_conv1d_plain(x, k))


@pytest.mark.parametrize("x_dtype,k_dtype", MIXED)
@pytest.mark.parametrize("mode,launched", [
    ("fused", {"mec_conv_fused": 1}), ("fused2", {"mec_conv_fused2": 1}),
    ("lowered", {"mec_lower": 1, "mec_gemm": 1})])
def test_conv2d_kernels_on_mixed_dtypes_fault_f4(cuda, mode, launched, x_dtype,
                                                 k_dtype):
    """K1, K4 and K2+K3 on an input and a kernel of two dtypes run the f32
    instance on both promoted: equal to the bit to that run cast to the
    input's dtype, within the input dtype's contract of f64."""
    x, _ = _operands((15, 17, 8, 3, 3, 24, 1), x_dtype, cuda)
    _, k = _operands((15, 17, 8, 3, 3, 24, 1), k_dtype, cuda)
    K.reset_launch_counts()
    y = ops.mec_conv2d_cuda(x, k, 1, mode=mode)
    torch.cuda.synchronize()
    assert K.launch_counts() == {**NO_LAUNCHES, **launched}
    assert y.dtype == x.dtype
    assert torch.equal(y, ops.mec_conv2d_cuda(x.float(), k.float(), 1,
                                              mode=mode).to(x.dtype))
    assert ref.scaled_error(y, ref.conv2d_f64(x, k, 1)) <= \
        fwd_tolerance("mec_" + mode, x_dtype, 3 * 3 * 8)


@pytest.mark.parametrize("x_dtype,k_dtype", MIXED)
@pytest.mark.parametrize("wrapper", ["fused", "fused2", "gemm"])
def test_conv2d_wrappers_on_mixed_dtypes_fault_f4(cuda, wrapper, x_dtype, k_dtype):
    """K1, K4 and K3 through their own wrappers on an input and a kernel of
    two dtypes promote both: one launch of the f32 instance, equal to the
    bit to the run on promoted operands cast to the input's dtype, within
    the input dtype's contract of f64."""
    x, _ = _operands((15, 17, 8, 3, 3, 24, 1), x_dtype, cuda)
    _, k = _operands((15, 17, 8, 3, 3, 24, 1), k_dtype, cuda)
    if wrapper == "gemm":
        low = K.mec_lower(x, 3, 1)

        def run(x, k):
            return K.mec_gemm(low.to(x.dtype), k.reshape(3, 24, 24), 3, 1)
    else:
        fn = K.mec_conv_fused if wrapper == "fused" else K.mec_conv_fused2

        def run(x, k):
            return fn(x, k, 1, w_blk=16)
    K.reset_launch_counts()
    y = run(x, k)
    torch.cuda.synchronize()
    assert sum(K.launch_counts().values()) == 1
    assert y.dtype == x.dtype
    assert torch.equal(y, run(x.float(), k.float()).to(x.dtype))
    assert ref.scaled_error(y, ref.conv2d_f64(x, k, 1)) <= \
        fwd_tolerance("mec_fused", x_dtype, 3 * 3 * 8)


# ---------------------------------------------------------------------------
# serving on the card
# ---------------------------------------------------------------------------

def _to(tree, device):
    return lm.tree_map(lambda t: t.to(device), tree)


def _scaled(a, b) -> float:
    return ((a.double().cpu() - b.double().cpu()).abs().max()
            / b.double().abs().max()).item()


@pytest.mark.parametrize("conv_impl", ["fused", "lowered"])
def test_smoke_serving_on_the_card_matches_the_cpu(cuda, conv_impl):
    """smoke_config("zamba2-7b") in f32: a 16-token prefill and 4 decode
    steps on the card against the same on the CPU; the fused conv launches
    K5 once per Mamba2 layer of the prefill and never in decode."""
    cfg = smoke_config("zamba2-7b").with_(conv_impl=conv_impl)
    model = lm.LM(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 20),
                         generator=torch.Generator().manual_seed(1))
    logits = {}
    with f32_accumulation():
        for device in ("cpu", cuda):
            p = _to(params, device)
            C.mec_conv1d.launches = 0
            out, cache = serve.prefill(model, p, {"tokens": toks[:, :16].to(device)}, 24)
            prefill_launches = C.mec_conv1d.launches
            steps = [out]
            for i in range(4):
                out, cache = serve.decode_step(model, p, cache,
                                               toks[:, 16 + i:17 + i].to(device))
                steps.append(out)
            torch.cuda.synchronize()
            logits[str(device)] = steps
            if device != "cpu":
                assert prefill_launches == (cfg.n_layers if conv_impl == "fused" else 0)
                assert C.mec_conv1d.launches == prefill_launches
    for got, want in zip(logits["cuda"], logits["cpu"]):
        assert got.device.type == "cuda" and _scaled(got, want) <= 1e-4


def test_serve_on_the_card_launches_k5_per_mamba_layer(cuda):
    cfg = smoke_config("zamba2-7b").with_(conv_impl="fused")
    C.mec_conv1d.launches = 0
    K.reset_launch_counts()
    res = launch_serve.serve(cfg, batch=2, prompt_len=16, gen=5, device=cuda)
    assert C.mec_conv1d.launches == cfg.n_layers
    assert K.launch_counts() == NO_LAUNCHES
    assert res["tokens"].shape == (2, 5) and res["tokens"].device.type == "cuda"
    assert bool(torch.isfinite(res["prefill_logits"]).all())


# ---------------------------------------------------------------------------
# the benchmark subsystem and the memory auditor on the card
# ---------------------------------------------------------------------------

def test_bench_smoke_suite_on_the_card_times_every_variant(cuda):
    """``run_suite("smoke")`` on the card: every variant timed on the
    device timer, K1-K4 launched (and K6 not: the suite times forwards),
    the card named in the report."""
    from repro_torch.bench.harness import run_suite
    from repro_torch.bench.report import validate_report
    K.reset_launch_counts()
    doc = run_suite("smoke", iters=2)
    torch.cuda.synchronize()
    assert validate_report(doc) == []
    assert all(r["us_per_call"] > 0 for r in doc["results"])
    assert {r["algorithm"] for r in doc["results"]} >= {
        "direct", "im2col", "fft", "winograd", "mecA", "mecB",
        "mec_lowered", "mec_fused", "mec_fused2"}
    counts = K.launch_counts()
    assert counts.pop("mec_weight_grad") == 0
    assert all(n > 0 for n in counts.values()), counts
    env = doc["environment"]
    assert (env["backend"], env["device_kind"]) == \
        ("cuda", torch.cuda.get_device_name(0))
    assert {r["plan"]["backend"] for r in doc["results"]} == {"cuda"}


def test_memaudit_kernel_cells_pass_on_the_card(cuda):
    """The smoke plans built on the card, audited: K1 and K4 keep no
    temporary, K2+K3 exactly the Eq. 3 L (2 MiB of slack), and the
    lowered path stays below im2col wherever Eq. 4 predicts a saving."""
    from repro_torch.analysis import memaudit
    from repro_torch.bench.report import validate_report
    from repro_torch.plan.__main__ import build_plans
    plans = memaudit.plans_of(build_plans(["smoke"]))
    doc, _ = memaudit.run_audit(plans=plans)
    assert validate_report(doc) == []
    kernel = [r for r in doc["results"]
              if r["algorithm"] in memaudit.KERNEL_ALGORITHMS]
    assert len(kernel) == 3 * len(plans)
    assert all(r["verdict"] == "pass" and r["policy"] == "gated"
               and r["measured_temp_bytes"] is not None for r in kernel), kernel
    lowered = [c for c in doc["crosscheck"] if c["algorithm"] == "mec_lowered"]
    assert len(lowered) == len(plans)
    assert all(c["ok"] == "yes" for c in lowered), lowered


def test_calibration_from_a_card_autotune_passes_its_check(cuda, tmp_path):
    """An autotune of ``smoke`` on the card skips no candidate, and a
    calibration fitted from it passes ``check_calibration``."""
    from repro_torch.bench.harness import run_autotune
    from repro_torch.plan import calibrate as cal
    doc = run_autotune("smoke", iters=2)
    assert all(r["n_skipped"] == 0 for r in doc["results"]), doc["results"]
    calib = cal.Calibration.for_current_env("cuda")
    assert cal.ingest_autotune(calib, doc) > 0
    path = tmp_path / "fit.json"
    path.write_text(json.dumps(calib.to_dict()))
    assert cal.check_calibration(json.loads(path.read_text())) == []
    assert cal.calibrate_main(["--check", "--baseline", str(path)]) == 0


def test_bench_cli_on_the_card(cuda, tmp_path):
    """``python -m repro_torch.bench --suite smoke --device cuda`` exits 0
    and writes its report under its own name."""
    from repro_torch.bench.report import validate_report
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    out = subprocess.run([sys.executable, "-m", "repro_torch.bench", "--suite",
                          "smoke", "--device", "cuda"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    doc = json.loads((tmp_path / "BENCH_torch_smoke.json").read_text())
    assert validate_report(doc) == []
    assert doc["environment"]["backend"] == "cuda"


def test_memaudit_plain_cells_pass_on_the_card(cuda):
    """Fault F6, repaired: on the smoke plans built on the card every
    plain-PyTorch cell is inside the JAX package's band (``direct`` on its
    own bytes, cuDNN's apart), and the plain MEC stays below im2col.
    Paired with ``tests/test_torch_analysis.py``'s gate tests on the
    CPU."""
    from repro_torch.analysis import memaudit
    from repro_torch.plan.__main__ import build_plans
    plans = memaudit.plans_of(build_plans(["smoke"]))
    doc, failures = memaudit.run_audit(plans=plans)
    assert failures == []
    plain = [r for r in doc["results"]
             if r["algorithm"] not in memaudit.KERNEL_ALGORITHMS]
    assert plain and all(r["policy"] == "gated" and r["verdict"] == "pass"
                         for r in plain), plain
    direct = [r for r in plain if r["algorithm"] == "direct"]
    assert all(r["library_workspace_bytes"] is not None for r in direct)
    assert all(c["ok"] == "yes" for c in doc["crosscheck"])


# geometries the chip smoke launches, in small: the sweep, F1's, and a
# Table-3 layer at batch 16; then one no launcher takes (a 33 x 33 kernel)
LAUNCH_GEOMS = [(2,) + g[:7] for g in GEOMS] + [
    (2, 7, 7, 3, 7, 7, 5, 1), (2, 8, 8, 3, 2, 2, 5, 3),
    (16, 14, 14, 256, 3, 3, 256, 1), (1, 40, 120, 32, 33, 33, 64, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_launch_check_equals_the_launcher_on_the_card(cuda, dtype):
    """The static mirror (``analysis.launch_check``) gives the launcher's
    own fields (``mec_conv.fused_config``) on every geometry, and refuses
    what it refuses.  Paired with ``tests/test_torch_launch_check.py``,
    which holds it to the launcher's source compiled for the host."""
    from repro_torch.analysis import launch_check as LC
    from repro_torch.core.convspec import ConvSpec
    both_refused = 0
    for n, ih, iw, ic, kh, kw, kc, s in LAUNCH_GEOMS:
        s_h, s_w = (s, s) if isinstance(s, int) else s
        spec = ConvSpec(n, ih, iw, ic, kh, kw, kc, s_h, s_w)
        for alg in LC.KERNEL_ALGORITHMS:
            mode = alg[len("mec_"):]
            try:
                want = ops.launch_config(mode, getattr(torch, dtype),
                                         (n, ih, iw, ic), (kh, kw, ic, kc),
                                         (s_h, s_w))
            except K.LaunchRefused:
                want = None
            got = LC.launcher_fields(alg, dtype, spec, None)
            assert got == want, (spec, alg)
            both_refused += got is None
    assert both_refused >= 3


@pytest.mark.parametrize("algorithm", ["mec_fused", "mec_fused2",
                                       "mec_lowered"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_numcheck_on_the_kernel_paths_on_the_card(cuda, algorithm, dtype):
    """The kernel paths' numeric contract on the card: the static trace
    and the error probe, forward and both gradients, at cv11's width at
    batch 16 against an f64 oracle on the card.  Paired with
    ``tests/test_torch_numcheck.py`` (the plain versions on the CPU)."""
    from repro_torch.analysis import numcheck as N
    from repro_torch.core.convspec import ConvSpec
    chk = N.check_numerics(ConvSpec(16, 14, 14, 256, 3, 3, 256), algorithm,
                           dtype, device="cuda", oracle="torch", scaled=True)
    assert chk.ok, chk.render()
    assert chk.record["probe"]["device"] == "cuda"


# ---------------------------------------------------------------------------
# plan-driven conv serving: class executors as CUDA graphs
# ---------------------------------------------------------------------------

# (kernel shape, stride, padding, class, request): whisper-tiny's two
# frontend layers at its full-length mel class, and the bench's s3x3 serve
# cell
SERVE_SPECS = {
    "whisper_conv1": ((3, 1, 80, 384), (1, 1), ((1, 1), (0, 0)),
                      (4, 3000, 1), (1, 2217, 1)),
    "whisper_conv2": ((3, 1, 384, 384), (2, 1), ((1, 1), (0, 0)),
                      (4, 3000, 1), (2, 2555, 1)),
    "bench_s3x3": ((3, 3, 4, 8), (2, 2), 1, (2, 16, 16), (1, 13, 11)),
}


def _service(name, device, dtype="float32"):
    from repro_torch.serving import ConvService
    kshape, stride, padding, cls, _ = SERVE_SPECS[name]
    rng = np.random.RandomState(len(name))
    k = (rng.randn(*kshape) * np.prod(kshape[:3]) ** -0.5).astype(np.float32)
    svc = ConvService(torch.from_numpy(k).to(device, DTYPES[dtype]),
                      stride=stride, padding=padding, classes=[cls],
                      plan_mode="cached")
    report = svc.warm()
    assert report.warning_count == 0 and report.plan_cache_io_errors == 0
    return svc


def _request(svc, shape, seed, device):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape, svc.kernel.shape[2]).astype(np.float32)
    return torch.from_numpy(x).to(device, svc.kernel.dtype)


@pytest.mark.parametrize("name", sorted(SERVE_SPECS))
def test_graph_replay_equals_eager_planned_conv(cuda, name):
    """A request through the captured class executor against the eager
    ``conv2d(plan=)`` of its padded class input: equal bits; K1 planned
    (the cached policy's analytic pick on the card), the replay counted."""
    svc = _service(name, cuda)
    x = _request(svc, SERVE_SPECS[name][4], 1, cuda)
    cls = svc.bucket(x.shape)
    assert svc.plans[cls].algorithm == "mec_fused"
    got = svc(x)
    with torch.no_grad():
        eager = conv2d(svc.pad_to_class(x, cls), svc.kernel,
                       stride=svc.stride, padding=svc.padding,
                       plan=svc.plans[cls])
    o_n, o_h, o_w, _ = svc.request_out_shape(x.shape)
    torch.cuda.synchronize()
    assert torch.equal(got, eager[:o_n, :o_h, :o_w])
    assert svc.replays[cls] == 1
    k_h, k_w = svc.kernel.shape[:2]
    padded = apply_padding(svc.pad_to_class(x, cls), k_h, k_w, *svc.stride,
                           svc.padding)
    oracle = ref.conv2d_f64(padded, svc.kernel, svc.stride)[:o_n, :o_h, :o_w]
    k = int(np.prod(svc.kernel.shape[:3]))
    assert ref.scaled_error(got, oracle) <= fwd_tolerance("mec_fused",
                                                          "float32", k)


def test_graph_replay_launches_no_wrapper(cuda):
    """The capture counts K1 once; replays launch it without Python."""
    K.reset_launch_counts()
    svc = _service("whisper_conv1", cuda)
    warm = K.launch_counts()
    assert warm == dict(NO_LAUNCHES, mec_conv_fused=2)   # eager run + capture
    for seed in range(3):
        svc(_request(svc, (4, 3000, 1), seed, cuda))
    assert K.launch_counts() == warm
    assert sum(svc.replays.values()) == 3


def test_served_answer_is_a_copy(cuda):
    svc = _service("whisper_conv2", cuda)
    first = svc(_request(svc, (4, 3000, 1), 2, cuda))
    kept = first.clone()
    cls = svc.classes[0]
    second = svc(_request(svc, (4, 3000, 1), 3, cuda))
    torch.cuda.synchronize()
    assert torch.equal(first, kept) and not torch.equal(first, second)
    ex = svc._compiled[cls]
    assert first.data_ptr() != ex.static_out.data_ptr()


@pytest.mark.parametrize("name", sorted(SERVE_SPECS))
def test_padding_region_is_zero_after_a_larger_request(cuda, name):
    svc = _service(name, cuda)
    cls = svc.classes[0]
    big = _request(svc, (cls.n, cls.h, cls.w), 4, cuda)
    svc(big)
    small_shape = SERVE_SPECS[name][4]
    small = _request(svc, small_shape, 5, cuda)
    got = svc(small)
    n, h, w = small_shape
    buf = svc._compiled[cls].static_in
    torch.cuda.synchronize()
    assert float(buf[n:].abs().sum()) == 0.0
    assert float(buf[:n, h:].abs().sum()) == 0.0
    assert float(buf[:n, :h, w:].abs().sum()) == 0.0
    fresh = _service(name, cuda)
    assert torch.equal(got, fresh(small))


# ---------------------------------------------------------------------------
# the decode step as one program, the batcher and the int8 cache
# ---------------------------------------------------------------------------

DECODE_ARCHS = ["yi-6b", "llava-next-34b", "zamba2-7b", "whisper-tiny",
                "xlstm-125m", "qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"]
INT8_ATTN_GATE, INT8_DECODE_GATE = 0.03, 0.05      # tests/test_kv_quant.py


def _smoke_prefill(arch, device, n=8, steps=4, **kw):
    """A smoke model of ``arch`` (f32) on ``device``, the cache of an
    ``n``-token prefill (with seeded vision tokens or frames where the
    family takes them) and ``steps`` further tokens."""
    cfg = smoke_config(arch).with_(**kw)
    model = lm.LM(cfg)
    params = _to(model.init(torch.Generator().manual_seed(0), device="cpu"),
                 device)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, n + steps), generator=gen)
    batch = {"tokens": toks[:, :n].to(device)}
    if cfg.family == "vlm":
        batch["vision"] = torch.randn((2, cfg.prefix_len, cfg.d_model),
                                      generator=gen).to(device)
    if cfg.family == "audio":
        batch["frames"] = torch.randn((2, cfg.encoder_len, cfg.d_model),
                                      generator=gen).to(device)
    _, cache = serve.prefill(model, params, batch,
                             cfg.prefix_len * (cfg.family == "vlm")
                             + n + 2 * steps)
    return model, params, cache, toks[:, n:].to(device)


def _tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_tree_equal(a[k], b[k])
                                              for k in a)
    return (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_captured_decode_step_equals_eager_bits(cuda, arch):
    """Four decode steps from one cache through the captured program and
    eagerly: equal bits on every step's logits and every cache leaf."""
    from repro_torch.serving import DecodeProgram
    with torch.inference_mode(), f32_accumulation():
        model, params, cache, extra = _smoke_prefill(arch, cuda)
        g_cache = lm.tree_map(torch.clone, cache)
        prog = DecodeProgram(
            lambda c, t: serve.decode_step(model, params, c, t), g_cache,
            torch.zeros_like(extra[:, :1]))
        assert prog.graph is not None
        for i in range(extra.shape[1]):
            prog.tokens.copy_(extra[:, i:i + 1])
            got = prog().clone()
            want, cache = serve.decode_step(model, params, cache,
                                            extra[:, i:i + 1])
            assert torch.equal(got, want), i
        assert _tree_equal(g_cache, cache) and prog.replays == extra.shape[1]


def test_capture_leaves_the_cache_as_built(cuda):
    """The eager warm-up runs on a clone: the hybrid family's Mamba2 state
    and conv history, and the length, are as the prefill left them."""
    from repro_torch.serving import DecodeProgram
    with torch.inference_mode(), f32_accumulation():
        model, params, cache, extra = _smoke_prefill("zamba2-7b", cuda)
        before = lm.tree_map(torch.clone, cache)
        DecodeProgram(lambda c, t: serve.decode_step(model, params, c, t),
                      cache, torch.zeros_like(extra[:, :1]))
        torch.cuda.synchronize()
        assert _tree_equal(cache, before)


def test_xlstm_capture_leaves_the_cache_as_built(cuda):
    """The ssm family's mLSTM and sLSTM state, conv history and length are
    as the prefill left them until the first replay, which advances them
    as one eager step does.  CPU counterpart: tests/test_torch_xlstm.py
    test_decode_writes_the_cache_in_place."""
    from repro_torch.serving import DecodeProgram
    with torch.inference_mode(), f32_accumulation():
        model, params, cache, extra = _smoke_prefill("xlstm-125m", cuda)
        before = lm.tree_map(torch.clone, cache)
        prog = DecodeProgram(
            lambda c, t: serve.decode_step(model, params, c, t), cache,
            torch.zeros_like(extra[:, :1]))
        torch.cuda.synchronize()
        assert prog.graph is not None and _tree_equal(cache, before)
        prog.tokens.copy_(extra[:, :1])
        prog()
        _, want = serve.decode_step(model, params, before, extra[:, :1])
        assert _tree_equal(cache, want)


def test_xlstm_serve_on_the_card_launches_k5_per_block(cuda):
    """conv_impl="fused": one K5 launch a block in the prefill (4 at smoke
    size), none in decode, no K1-K4; the greedy tokens of the lowered
    path."""
    cfg = smoke_config("xlstm-125m")
    runs = {}
    for impl in ("fused", "lowered"):
        C.mec_conv1d.launches = 0
        K.reset_launch_counts()
        runs[impl] = launch_serve.serve(cfg.with_(conv_impl=impl), batch=2,
                                        prompt_len=16, gen=5, device=cuda)
        assert C.mec_conv1d.launches == (cfg.n_layers if impl == "fused" else 0)
        assert K.launch_counts() == NO_LAUNCHES
        assert runs[impl]["decode_graph"]
    assert torch.equal(runs["fused"]["tokens"], runs["lowered"]["tokens"])


def test_serve_decodes_through_the_graph_on_the_card(cuda, monkeypatch):
    import functools
    from repro_torch.serving import DecodeProgram
    cfg = smoke_config("yi-6b")
    graph = launch_serve.serve(cfg, batch=2, prompt_len=8, gen=5, device=cuda)
    monkeypatch.setattr(launch_serve, "DecodeProgram",
                        functools.partial(DecodeProgram, graph=False))
    eager = launch_serve.serve(cfg, batch=2, prompt_len=8, gen=5, device=cuda)
    assert graph["decode_graph"] and not eager["decode_graph"]
    assert 0 < graph["capture_s"] < graph["decode_s"]
    assert torch.equal(graph["tokens"], eager["tokens"])
    assert torch.equal(graph["logits"], eager["logits"])


def _requests(cfg, n, seed, **kw):
    from repro_torch.serving import Request
    gen = torch.Generator().manual_seed(seed)
    return [Request(rid=i, prompt=torch.randint(
        0, cfg.vocab, (5 + 4 * i,), generator=gen).to("cuda"),
        max_new_tokens=4 + i, **kw) for i in range(n)]


def _record(batcher) -> dict:
    """Wrap ``batcher``'s prefill and decode program so that each
    request's logits rows (its prefill's, then one a tick while it is
    live) collect in the returned {rid: [(V,) f32, ...]}."""
    rows = {}
    prefill, decode = batcher._prefill, batcher._decode

    def recorded_prefill(req, slot):
        row = prefill(req, slot)
        rows[req.rid] = [row]
        return row

    def recorded_decode():
        logits = decode()
        for req in batcher.live.values():
            rows[req.rid].append(logits[req.slot].clone())
        return logits

    batcher._prefill, batcher._decode = recorded_prefill, recorded_decode
    return rows


def _solo(model, params, req, feed=True):
    """The request alone: (greedy tokens, logits rows); with ``feed`` the
    decode steps read the request's own stream."""
    logits, cache = serve.prefill(model, params, {"tokens": req.prompt[None]},
                                  64)
    out, rows = [int(torch.argmax(logits[0]))], [logits[0]]
    for i in range(req.max_new_tokens - 1):
        tok = req.out[i] if feed else out[-1]
        logits, cache = serve.decode_step(model, params, cache,
                                          torch.tensor([[tok]], device="cuda"))
        out.append(int(torch.argmax(logits[0])))
        rows.append(logits[0])
    return out, rows


def test_batcher_on_the_card_equals_each_request_alone(cuda):
    """f32 smoke yi-6b, 5 requests through 2 captured slots: each stream
    equals the request served alone on the card; the graph replayed."""
    from repro_torch.serving import ContinuousBatcher
    cfg = smoke_config("yi-6b")
    model = lm.LM(cfg)
    params = _to(model.init(torch.Generator().manual_seed(0), device="cpu"),
                 cuda)
    with torch.inference_mode(), f32_accumulation():
        batcher = ContinuousBatcher(model, params, n_slots=2, max_len=64)
        assert batcher._decode.graph is not None
        for req in _requests(cfg, 5, 3):
            batcher.submit(req)
        done = batcher.run_until_done()
        assert len(done) == 5 and batcher._decode.replays > 0
        for req in done:
            assert req.out == _solo(model, params, req, feed=False)[0]
        assert batcher.cache["lens"].tolist() == [-1, -1]


def test_int8_batcher_on_the_card(cuda):
    """The int8 pool on the card: int8 k/v and bf16 scales, under 0.6 x the
    bf16 pool's bytes, each request's logits within the int8 decode gate
    of the float path fed the same tokens."""
    from repro_torch.serving import ContinuousBatcher, init_pool
    cfg = smoke_config("qwen3-4b")
    model = lm.LM(cfg)
    params = _to(model.init(torch.Generator().manual_seed(0), device="cpu"),
                 cuda)
    with torch.inference_mode(), f32_accumulation():
        q8 = ContinuousBatcher(lm.LM(cfg.with_(kv_cache_int8=True)), params,
                               n_slots=2, max_len=64)
        bf = init_pool(lm.LM(cfg.with_(dtype="bfloat16")), 2, 64, device=cuda)

        def nbytes(cache):
            return sum(t.numel() * t.element_size() for t in cache.values())

        assert q8.cache["k"].dtype == torch.int8
        assert nbytes(q8.cache) < 0.6 * nbytes(bf)
        got = _record(q8)
        for req in _requests(cfg, 3, 4):
            q8.submit(req)
        for req in q8.run_until_done():
            rows = _solo(model, params, req)[1]
            assert max(_scaled(a, b) for a, b in zip(got[req.rid], rows)) \
                < INT8_DECODE_GATE


def test_int8_decode_attention_on_the_card(cuda):
    from repro_torch.models.layers import decode_attention, quantize_kv
    gen = torch.Generator().manual_seed(5)
    q = torch.randn((4, 1, 32, 128), generator=gen).to(cuda)
    k, v = (torch.randn((4, 300, 8, 128), generator=gen).to(cuda)
            for _ in range(2))
    length = torch.tensor(257, dtype=torch.int32, device=cuda)
    exact = decode_attention(q, k, v, length)
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    assert _scaled(decode_attention(q, kq, vq, length, k_scale=ks,
                                    v_scale=vs), exact) < INT8_ATTN_GATE
    cq, cs = quantize_kv(k.cpu())
    assert torch.equal(kq.cpu(), cq) and torch.equal(ks.cpu(), cs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_triangle_attention_on_the_card_equals_plain_bits(cuda, dtype):
    from repro_torch.models.layers import (chunked_attention,
                                           chunked_attention_tri)
    gen = torch.Generator().manual_seed(6)
    q = torch.randn((2, 300, 8, 64), generator=gen).to(cuda, DTYPES[dtype])
    k, v = (torch.randn((2, 300, 2, 64), generator=gen).to(cuda, DTYPES[dtype])
            for _ in range(2))
    with f32_accumulation():
        tri = chunked_attention_tri(q, k, v, q_chunk=64, kv_chunk=128)
        plain = chunked_attention(q, k, v, causal=True, q_chunk=64,
                                  kv_chunk=128)
    assert torch.equal(tri, plain)


# ---------------------------------------------------------------------------
# K5's gradient, the moe family and LM training on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k_w", [4, 9])
def test_conv1d_on_the_card_is_differentiable(cuda, k_w, dtype):
    """K5's autograd node on a CUDA tensor that requires grad: a grad_fn,
    one launch a forward and none in the backward, dx and dk equal to the
    plain version's autograd on the card (same formulas, same order) on a
    strided slice."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(k_w)
    row = torch.randn((2, 300, 96), generator=gen).to(dt).to(cuda)
    k = torch.randn((k_w, 64), generator=gen).to(dt).to(cuda)
    g = torch.randn((2, 300, 64), generator=gen).to(dt).to(cuda)
    grads = []
    for fn in (C.mec_conv1d, C.mec_conv1d_plain):
        x = row.clone().requires_grad_(True)
        kk = k.clone().requires_grad_(True)
        C.mec_conv1d.launches = 0
        y = fn(x[..., 16:80], kk)
        assert y.grad_fn is not None
        y.backward(g)
        torch.cuda.synchronize()
        grads.append((x.grad, kk.grad, C.mec_conv1d.launches))
    assert grads[0][2] == 1 and grads[1][2] == 0
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])


def test_expert_product_has_an_f32_result_and_a_gradient(cuda):
    """The bf16 expert product on the card: torch.bmm's f32-result form
    without an f32 copy of the weights, equal to the product of the
    widened operands within f32 rounding, and its gradients from the f32
    cotangent, equal to the widened product's."""
    from repro_torch.models import moe
    gen = torch.Generator().manual_seed(0)
    a = torch.randn((4, 16, 64), generator=gen).to(torch.bfloat16).to(cuda)
    b = torch.randn((4, 64, 32), generator=gen).to(torch.bfloat16).to(cuda)
    a.requires_grad_(True)
    b.requires_grad_(True)
    with f32_accumulation():
        y = moe._product_f32(a, b)
        want = torch.bmm(a.detach().float(), b.detach().float())
    assert y.dtype == torch.float32
    assert _scaled(y.detach(), want) < 1e-6
    y.square().sum().backward()
    assert a.grad.dtype == torch.bfloat16 and b.grad.dtype == torch.bfloat16
    ga = (2 * want) @ b.detach().float().transpose(1, 2)
    assert _scaled(a.grad.float(), ga) < 2e-2
    # the backward takes the f32 cotangent, as the widened product's
    # autograd (the CPU's path) does: equal bits at one cotangent, where
    # the cotangent rounded to bf16 first does not give them
    g = torch.randn((4, 16, 32), generator=gen).to(cuda)
    grads = []
    for widen in (False, True):
        aw = a.detach().clone().requires_grad_(True)
        bw = b.detach().clone().requires_grad_(True)
        with f32_accumulation():
            out = (torch.bmm(aw.float(), bw.float()) if widen
                   else moe._product_f32(aw, bw))
            out.backward(g)
        grads.append((aw.grad, bw.grad))
    with f32_accumulation():
        rounded = moe._product_f32_grads(a.detach(), b.detach(),
                                         g.to(torch.bfloat16).float())
    assert all(map(torch.equal, grads[0], grads[1]))
    assert not all(map(torch.equal, rounded, grads[0]))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"])
def test_moe_serve_on_the_card_matches_the_cpu(cuda, arch):
    """The smoke moe model (f32, capacity factor 8: no drops) with the same
    weights on the card and the CPU: a 16-token prefill and 4 decode
    steps, every step's logits within 1e-4, no drop counted on either, no
    conv kernel on the card."""
    from repro_torch.models import moe
    cfg = smoke_config(arch)
    model = lm.LM(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 20),
                         generator=torch.Generator().manual_seed(1))
    logits = {}
    K.reset_launch_counts()
    C.mec_conv1d.launches = 0
    with f32_accumulation():
        for device in ("cpu", cuda):
            p = _to(params, device)
            with moe.count_drops(device) as dropped:
                out, cache = serve.prefill(
                    model, p, {"tokens": toks[:, :16].to(device)}, 24)
                steps = [out]
                for i in range(4):
                    out, cache = serve.decode_step(
                        model, p, cache, toks[:, 16 + i:17 + i].to(device))
                    steps.append(out)
                assert int(dropped) == 0
            logits[str(device)] = steps
    assert K.launch_counts() == NO_LAUNCHES and C.mec_conv1d.launches == 0
    for got, want in zip(logits["cuda"], logits["cpu"]):
        assert got.device.type == "cuda" and _scaled(got, want) <= 1e-4


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"])
def test_moe_drops_on_the_card_are_counted_alike_in_graph_and_eager(
        cuda, arch, monkeypatch):
    """At a capacity factor that drops: the captured decode counts the
    same drops a step as the eager one, with the same tokens."""
    import functools
    from repro_torch.serving import DecodeProgram
    cfg = smoke_config(arch).with_(capacity_factor=0.5)
    graph = launch_serve.serve(cfg, batch=4, prompt_len=12, gen=6, device=cuda)
    monkeypatch.setattr(launch_serve, "DecodeProgram",
                        functools.partial(DecodeProgram, graph=False))
    eager = launch_serve.serve(cfg, batch=4, prompt_len=12, gen=6, device=cuda)
    assert graph["decode_graph"] and not eager["decode_graph"]
    assert graph["drops"]["prefill"] > 0
    assert graph["drops"] == eager["drops"]
    assert torch.equal(graph["tokens"], eager["tokens"])


@pytest.mark.parametrize("arch", ["yi-6b", "qwen3-moe-30b-a3b", "zamba2-7b",
                                  "xlstm-125m", "whisper-tiny",
                                  "llava-next-34b"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """One smoke train step (f32, the fused conv where the family has one)
    on the card against the CPU: loss and grad norm within 1e-4, K5
    launched once a block on the card."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training import steps
    cfg = smoke_config(arch).with_(conv_impl="fused")
    model = lm.LM(cfg)
    out = {}
    for device in ("cpu", cuda):
        params = _to(model.init(torch.Generator().manual_seed(0),
                                device="cpu"), device)
        batch = SyntheticLMData(cfg, 2, 32, device=device).next_batch()
        step = steps.make_train_step(model, AdamWConfig(total_steps=10))
        C.mec_conv1d.launches = 0
        with f32_accumulation():
            _, _, met = step(params, steps.init_opt_state(params), batch)
        out[str(device)] = (float(met["loss"]), float(met["grad_norm"]),
                            C.mec_conv1d.launches)
    (l0, g0, n0), (l1, g1, n1) = out["cpu"], out[str(cuda)]
    assert abs(l1 - l0) <= 1e-4 * abs(l0) and abs(g1 - g0) <= 1e-4 * abs(g0)
    blocks = cfg.n_layers if cfg.family in ("hybrid", "ssm") else 0
    assert n0 == 0 and n1 == blocks


def test_chunked_loss_on_the_card_matches_the_cpu(cuda):
    from repro_torch.training.loss import chunked_softmax_xent
    gen = torch.Generator().manual_seed(0)
    h = torch.randn((2, 70, 32), generator=gen)
    w = torch.randn((32, 300), generator=gen)
    labels = torch.randint(-1, 300, (2, 70), generator=gen)
    out = []
    for device in ("cpu", cuda):
        hh = h.detach().clone().to(device).requires_grad_(True)
        ww = w.detach().clone().to(device).requires_grad_(True)
        with f32_accumulation():
            loss, _ = chunked_softmax_xent(hh, ww, labels.to(device), chunk=16)
            loss.backward()
        out.append((loss.detach().cpu(), hh.grad.cpu(), ww.grad.cpu()))
    for a, b in zip(*out):
        assert _scaled(b, a) < 1e-5


def test_checkpoint_of_card_tensors_restores_on_the_card(cuda, tmp_path):
    from repro_torch.ckpt.manager import CheckpointManager
    tree = {"w": torch.randn((3, 5), device=cuda).to(torch.bfloat16),
            "s": torch.zeros((), dtype=torch.int32, device=cuda)}
    mgr = CheckpointManager(tmp_path)
    mgr.save_async(2, {"params": tree})
    mgr.wait()
    out = mgr.restore(2, {"params": lm.tree_map(torch.zeros_like, tree)})
    assert out["params"]["w"].device.type == "cuda"
    assert _tree_equal(out["params"], tree)


def test_zz_a_failed_capture_raises(cuda):
    """A step that reads a device value on the host cannot be captured:
    the program raises, with no eager fallback.  (Last in the file: the
    failed capture is the final CUDA work here.)"""
    from repro_torch.serving import DecodeProgram
    cache = {"x": torch.ones(4, device=cuda),
             "len": torch.zeros((), dtype=torch.int32, device=cuda)}

    def step(c, t):
        scale = float(c["x"].sum().item())          # a host sync
        return c["x"][None] * scale, dict(c, len=c["len"] + 1)

    with pytest.raises(RuntimeError, match="capturing the decode step failed"):
        DecodeProgram(step, cache, torch.zeros((1, 1), dtype=torch.long,
                                               device=cuda))


# ------------------------------------------------------ ranks on one card

def test_two_gloo_ranks_share_the_card_through_the_kernels(cuda):
    """Two processes on cuda:0 under gloo (NCCL refuses two ranks on one
    device): ``spatial`` through K1 and ``batch`` through K4, output and
    gradients against the single-device conv on the card, every rank's
    body launching its kernel."""
    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    import test_torch_dist_workers as W
    from repro_torch.launch.mesh import spawn
    rng = np.random.RandomState(3)
    cases = []
    for part, alg, kernel in (("spatial", "mec_fused", "mec_conv_fused"),
                              ("batch", "mec_fused2", "mec_conv_fused2")):
        x = rng.randn(2, 32, 30, 16).astype(np.float32)
        k = rng.randn(3, 3, 16, 32).astype(np.float32)
        g = rng.randn(2, 30, 28, 32).astype(np.float32)
        cases.append((dict(x=x, k=k, g=g, stride=1, algorithm=alg,
                           partition=part, mesh_shape=(2,),
                           mesh_axes=("data",)), kernel))
    ranks = spawn(W.conv_cases, 2, args=([c for c, _ in cases], "cuda"),
                  device="cuda", timeout_s=120, join_timeout_s=600)
    for i, (case, kernel) in enumerate(cases):
        x = torch.tensor(case["x"], device=cuda, requires_grad=True)
        k = torch.tensor(case["k"], device=cuda, requires_grad=True)
        y = conv2d(x, k, algorithm=case["algorithm"], partition="none")
        (y * torch.tensor(case["g"], device=cuda)).sum().backward()
        ref = {"y": y.detach().cpu().numpy(), "dx": x.grad.cpu().numpy(),
               "dk": k.grad.cpu().numpy()}
        for r in ranks:
            got = r[i]
            assert got["launches"][kernel] >= 1, got["launches"]
            for f, tol in (("y", 2 * fwd_tolerance("mec", "float32", 144)),
                           ("dx", grad_tolerance("mec", "float32", 288)),
                           ("dk", grad_tolerance("mec", "float32", 1680))):
                err = np.abs(got[f] - ref[f]).max() / np.abs(ref[f]).max()
                assert err < tol, (case["partition"], f, err)


def test_nccl_with_more_ranks_than_cards_raises(cuda, monkeypatch):
    from repro_torch.launch.mesh import init_world, spawn
    with pytest.raises(ValueError, match="--backend gloo"):
        spawn(print, torch.cuda.device_count() + 1, backend="nccl",
              device="cuda")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", str(torch.cuda.device_count() + 1))
    with pytest.raises(ValueError, match="--backend gloo"):
        init_world("nccl", "cuda")


def test_tensor_parallel_serve_on_the_card_equals_one_rank(cuda):
    """zamba2-7b smoke (f32, the fused conv: K5 on each rank's channel
    slice) served by two gloo ranks sharing the card under (1, 2) rules
    against one process on the card: the greedy tokens equal, the logits
    within 1e-4 scaled; each rank's prefill launches K5 once a Mamba2
    layer.  The CPU counterpart is ``tests/test_torch_tensor_parallel.py``
    ``test_serving_on_2_ranks_equals_one_rank``."""
    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    import test_torch_dist_workers as W
    from repro_torch.launch.mesh import spawn
    over = {"conv_impl": "fused"}
    ranks = spawn(W.tp_serve, 2, args=("zamba2-7b", over, "cuda"),
                  device="cuda", timeout_s=120, join_timeout_s=600)
    cfg = smoke_config("zamba2-7b").with_(**over)
    with f32_accumulation():
        one = launch_serve.serve(cfg, batch=2, prompt_len=16, gen=5,
                                 device=cuda)
    want = one["prefill_logits"].cpu().numpy()
    for r in ranks:
        assert r["k5_launches"] == cfg.n_layers
        assert np.array_equal(r["tokens"], one["tokens"].cpu().numpy())
        err = np.abs(r["prefill_logits"] - want).max() / np.abs(want).max()
        assert err < 1e-4, err


@pytest.mark.parametrize("row,lo,hi", [(7352, 3584, 7296), (1536, 0, 768)])
def test_conv1d_on_a_rank_slice_equals_its_plain_version(cuda, row, lo, hi):
    """K5 on the channel slice a rank gives it at tp 2 (zamba2-7b's xBC of
    its local in_proj output; xlstm-125m's mLSTM x_in of its local up
    output), a strided view, at a short sequence: forward and gradients
    equal to the plain version's, bf16 and f32.  The CPU counterpart is
    the fused families of ``tests/test_torch_tensor_parallel.py``."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    for dtype in (torch.float32, torch.bfloat16):
        base = torch.randn((2, 64, row), generator=gen, device=cuda).to(dtype)
        k = torch.randn((4, hi - lo), generator=gen, device=cuda).to(dtype)
        g = torch.randn((2, 64, hi - lo), generator=gen, device=cuda).to(dtype)
        got = {}
        for name, fn in (("kernel", C.mec_conv1d), ("plain", C.mec_conv1d_plain)):
            x = base.clone().requires_grad_(True)
            kk = k.clone().requires_grad_(True)
            y = fn(x[..., lo:hi], kk)
            y.backward(g)
            got[name] = (y.detach(), x.grad, kk.grad)
        assert torch.equal(got["kernel"][0], got["plain"][0])
        for a, b in zip(got["kernel"][1:], got["plain"][1:]):
            err = ref.scaled_error(a, b)
            assert err <= grad_tolerance("mec_fused", "float32", 128), err
