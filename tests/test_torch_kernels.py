"""The port's CUDA kernel wrappers against the JAX package's Pallas
kernels.

K5 (the causal depthwise conv1d): its wrapper on CPU tensors (the plain
version) against ``mec_conv1d_pallas`` in interpret mode
(``repro.kernels.ops.mec_conv1d_tpu``) on the cases of
``tests/test_kernels.py``, with that test's tolerance (2e-4 in f32, 4e-2
below, rtol and atol); at k_w = 1, where the TPU kernel is wrong (fault
F2), against the JAX oracle ``repro.kernels.ref.conv1d_ref`` instead.

On the CPU each wrapper runs its kernel's plain PyTorch version; these
tests hold those versions against ``mec_conv_fused_pallas`` (K1),
``mec_lower_pallas`` (K2), ``mec_gemm_pallas`` (K3) and
``mec_conv_fused2_pallas`` (K4) run with ``interpret=True``, on the
kernel test sweep (f32, bf16) and the Table-2 layers cut to <= 32x32
spatial and <= 8 channels (f32).  On the geometries of fault F1, where
the TPU's K4 reads a halo view shorter than the halo, and on k_h < s_h,
K4's plain version is held against the JAX package's oracle
``repro.kernels.ref.conv2d_ref`` instead.  Tolerances: K1/K3/K4, 2 x the
contract's forward tolerance (``numerics.fwd_tolerance``, f32 scaled by
sqrt(K/27)), since each side is held to it on its own; K2 is data
movement and must match exactly.

K6 (the MEC weight gradient) replaces no Pallas kernel: its plain
version, what its wrapper runs on CPU tensors, is held against the JAX
package's VJP (``repro.core.conv_api._mec_weight_grad``) within twice the
f32 gradient budget (``numerics.grad_tolerance``).

The kernels themselves, on the card, are held against these plain
versions in ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                              # noqa: E402

from repro.bench.scenarios import CV_LAYERS          # noqa: E402
from repro.kernels.mec_conv import (mec_conv_fused2_pallas,  # noqa: E402
                                    mec_conv_fused_pallas, mec_gemm_pallas,
                                    mec_lower_pallas)
from repro.kernels.ops import mec_conv1d_tpu         # noqa: E402
from repro.kernels.ref import conv1d_ref as j_conv1d_ref  # noqa: E402
from repro.kernels.ref import conv2d_ref as j_conv2d_ref  # noqa: E402
from repro.kernels.ref import lower_ref as j_lower_ref  # noqa: E402

from repro_torch.core.numerics import fwd_tolerance, grad_tolerance  # noqa: E402
from repro_torch.kernels import build, ops, ref      # noqa: E402
from repro_torch.kernels import mec_conv as K        # noqa: E402
from repro_torch.kernels import mec_conv1d as C      # noqa: E402

SWEEP = [
    # (ih, iw, ic, kh, kw, kc, stride), as tests/test_kernels.py SWEEP
    (7, 7, 1, 3, 3, 1, 1),
    (12, 14, 3, 5, 3, 8, 2),
    (9, 9, 4, 3, 3, 6, 1),
    (11, 13, 2, 4, 5, 3, (2, 3)),
    (16, 16, 8, 7, 7, 16, 2),
    (8, 8, 3, 1, 1, 4, 1),
    (24, 24, 6, 5, 5, 16, 1),
    (227 // 4, 227 // 4, 3, 11, 11, 8, 4),
]
TABLE2_SMALL = {name: (min(ih, 32), min(iw, 32), min(ic, 8), kh, kw,
                       min(kc, 8), s)
                for name, (ih, iw, ic, kh, kw, kc, s) in CV_LAYERS.items()}
GEOMS = ([(f"sweep{i}", g, "float32") for i, g in enumerate(SWEEP)]
         + [(f"sweep{i}", g, "bfloat16") for i, g in enumerate(SWEEP)]
         + [(name, g, "float32") for name, g in TABLE2_SMALL.items()])
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}
# Fault F1 (ROADMAP Queue 3): the TPU's fused2 kernel is wrong where the
# halo k_h - s_h outruns s_h * min(8, o_h); then k_h < s_h (negative halo).
EDGE_GEOMS = {
    "f1_7x7": (7, 7, 3, 7, 7, 5, 1),
    "f1_6x6": (6, 6, 3, 5, 5, 5, 1),
    "f1_9x9": (9, 9, 3, 7, 7, 5, 1),
    "kh_lt_sh": (8, 8, 3, 2, 2, 5, 3),
}


def _operands(geom, dtype, batch=2):
    """Seeded numpy input and kernel as (jax, torch) pairs of ``dtype``."""
    ih, iw, ic, kh, kw, kc, _ = geom
    rng = np.random.RandomState(sum(geom[:6]))
    x = rng.randn(batch, ih, iw, ic).astype(np.float32)
    k = (rng.randn(kh, kw, ic, kc) * (kh * kw * ic) ** -0.5).astype(np.float32)
    jd, td = DTYPES[dtype]
    return (jnp.asarray(x, jd), jnp.asarray(k, jd),
            torch.from_numpy(x).to(td), torch.from_numpy(k).to(td))


def _strides(s):
    return (s, s) if isinstance(s, int) else tuple(s)


def _to_torch(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("name,geom,dtype", GEOMS,
                         ids=[f"{n}-{d}" for n, _, d in GEOMS])
def test_kernels_plain_match_pallas(name, geom, dtype):
    """K1, K2 and K3 through their wrappers on CPU tensors (the plain
    versions) against the Pallas kernels in interpret mode."""
    ih, iw, ic, kh, kw, kc, s = geom
    s_h, s_w = _strides(s)
    jx, jk, tx, tk = _operands(geom, dtype)
    tol = 2 * fwd_tolerance("mec_fused", dtype, kh * kw * ic)

    # K2: exact, and equal to the JAX oracle too
    j_low = mec_lower_pallas(jx, kw, s_w, interpret=True)
    t_low = K.mec_lower(tx, kw, s_w)
    assert t_low.dtype == tx.dtype and tuple(t_low.shape) == j_low.shape
    assert torch.equal(t_low.to(torch.float32), _to_torch(j_low))
    assert torch.equal(t_low, ref.lower_ref(tx, kw, s_w))
    assert torch.equal(t_low.to(torch.float32),
                       _to_torch(j_lower_ref(jx, kw, s_w)))

    # K1
    j_out = mec_conv_fused_pallas(jx, jk, (s_h, s_w), w_blk=8, interpret=True)
    t_out = K.mec_conv_fused(tx, tk, (s_h, s_w), w_blk=8)
    assert t_out.dtype == tx.dtype and tuple(t_out.shape) == j_out.shape
    assert ref.scaled_error(t_out, _to_torch(j_out)) <= tol

    # K3 (the Pallas kernel returns f32; the port writes the input dtype)
    j_kmat = jk.reshape(kh, kw * ic, kc)
    j_out3 = mec_gemm_pallas(j_low, j_kmat, kh, s_h, w_blk=8, interpret=True)
    t_out3 = K.mec_gemm(t_low, tk.reshape(kh, kw * ic, kc), kh, s_h, w_blk=8)
    assert t_out3.dtype == tx.dtype and tuple(t_out3.shape) == j_out3.shape
    assert ref.scaled_error(t_out3, _to_torch(j_out3)) <= tol


@pytest.mark.parametrize("name,geom,dtype", GEOMS,
                         ids=[f"{n}-{d}" for n, _, d in GEOMS])
def test_fused2_plain_matches_pallas(name, geom, dtype):
    """K4 through its wrapper on CPU tensors (the plain h-blocked
    decomposition) against the Pallas kernel in interpret mode, at the
    TPU kernel's default oh_blk = 8 and w_blk = 8."""
    kh, kw, ic, s = geom[3], geom[4], geom[2], _strides(geom[6])
    jx, jk, tx, tk = _operands(geom, dtype)
    j_out = mec_conv_fused2_pallas(jx, jk, s, w_blk=8, oh_blk=8, interpret=True)
    t_out = K.mec_conv_fused2(tx, tk, s, w_blk=8, oh_blk=8)
    assert t_out.dtype == tx.dtype and tuple(t_out.shape) == j_out.shape
    assert ref.scaled_error(t_out, _to_torch(j_out)) <= \
        2 * fwd_tolerance("mec_fused2", dtype, kh * kw * ic)


@pytest.mark.parametrize("oh_blk", [1, 2, 3, 8])
@pytest.mark.parametrize("name", list(EDGE_GEOMS))
def test_fused2_plain_on_fault_f1_geometries(name, oh_blk):
    """Where the TPU kernel is wrong (F1) or its halo is negative, K4's
    plain version matches the JAX package's oracle at any block height."""
    geom = EDGE_GEOMS[name]
    kh, kw, ic, s = geom[3], geom[4], geom[2], geom[6]
    jx, jk, tx, tk = _operands(geom, "float32")
    t_out = K.mec_conv_fused2(tx, tk, s, oh_blk=oh_blk)
    assert ref.scaled_error(t_out, _to_torch(j_conv2d_ref(jx, jk, s))) <= \
        2 * fwd_tolerance("mec_fused2", "float32", kh * kw * ic)


@pytest.mark.parametrize("geom", SWEEP[:5])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_versions_against_f64_oracle(geom, dtype):
    """Each plain version alone holds the contract budget against the f64
    oracle (computed from the same quantized inputs)."""
    kh, kw, ic, s = geom[3], geom[4], geom[2], geom[6]
    _, _, tx, tk = _operands(geom, dtype)
    oracle = ref.conv2d_f64(tx, tk, s)
    tol = fwd_tolerance("mec_fused", dtype, kh * kw * ic)
    assert ref.scaled_error(K.mec_conv_fused_plain(tx, tk, s), oracle) <= tol
    s_h, s_w = _strides(s)
    low = K.mec_lower_plain(tx, kw, s_w)
    y3 = K.mec_gemm_plain(low, tk.reshape(kh, kw * ic, -1), kh, s_h)
    assert ref.scaled_error(y3, oracle) <= tol
    for oh_blk in (1, 3, 8):
        y4 = K.mec_conv_fused2_plain(tx, tk, s, oh_blk)
        assert ref.scaled_error(y4, oracle) <= tol


# ---------------------------------------------------------------------------
# K3 as the K1/K4 core: the shifted GEMM over L is a conv of L read as an
# image I' (height o_w, width i_h, k_w*i_c channels) with kernel_mat read as
# K' (1, k_h, k_w*i_c, k_c), stride (1, s_h), output axes h and w swapped
# ---------------------------------------------------------------------------

# Table 3's layers (ResNet-101) at narrow widths, as TABLE2_SMALL
TABLE3_SMALL = {name: TABLE2_SMALL[name]
                for name in ("cv4", "cv9", "cv10", "cv11", "cv12")}
GEMM_GEOMS = ([(f"sweep{i}", g) for i, g in enumerate(SWEEP)]
              + list(EDGE_GEOMS.items()) + list(TABLE3_SMALL.items()))


def _gemm_as_core(low, kmat, k_h, s_h):
    """K3's function as the core computes it: ``mec_conv_fused_plain`` on
    L and kernel_mat viewed as :func:`gemm_core` says, its output written
    through the core's output strides into O (n, o_h, o_w, k_c)."""
    core = K.gemm_core(low.shape, kmat.shape, k_h, s_h)
    y = K.mec_conv_fused_plain(low.view(core["inp"]), kmat.view(core["kernel"]),
                               core["stride"])
    assert tuple(y.shape) == core["out_shape"]
    i_n, o_w, o_h, k_c = core["out_shape"]
    out = torch.empty(i_n * o_h * o_w * k_c, dtype=y.dtype)
    out.as_strided(core["out_shape"], core["out_strides"] + (1,)).copy_(y)
    return out.view(i_n, o_h, o_w, k_c)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,geom", GEMM_GEOMS, ids=[n for n, _ in GEMM_GEOMS])
def test_gemm_is_the_core_on_l_read_as_an_image(name, geom, dtype):
    """The core's conv on (L as I', kernel_mat as K', stride (1, s_h)),
    written through its swapped output strides, against the JAX package's
    ``mec_gemm_pallas`` in interpret mode (2x the contract; not on F1's
    geometries and k_h < s_h, which K3's TPU kernel does not reach
    differently) and its oracle ``conv2d_ref`` (the contract)."""
    ih, iw, ic, kh, kw, kc, s = geom
    s_h, s_w = _strides(s)
    jx, jk, tx, tk = _operands(geom, dtype)
    tol = fwd_tolerance("mec_lowered", dtype, kh * kw * ic)
    low = K.mec_lower_plain(tx, kw, s_w)
    got = _gemm_as_core(low, tk.reshape(kh, kw * ic, kc), kh, s_h)
    assert got.dtype == tx.dtype
    j_low = j_lower_ref(jx, kw, s_w)
    j_out = mec_gemm_pallas(j_low, jk.reshape(kh, kw * ic, kc), kh, s_h, w_blk=8,
                            interpret=True)
    assert tuple(got.shape) == j_out.shape
    assert ref.scaled_error(got, _to_torch(j_out)) <= 2 * tol
    assert ref.scaled_error(got, _to_torch(j_conv2d_ref(jx, jk, s))) <= tol


# (low shape, k_h, k_c, s_h, w_blk): Table 3's cv12, cv11 and cv4 at batch
# 16, cv4 at batch 1, SWEEP[3] with a given block, cv1's 33 channels of L
GEMM_CORE_CASES = [((16, 5, 7, 1536), 3, 512, 1, None),
                   ((16, 12, 14, 768), 3, 256, 1, None),
                   ((16, 109, 224, 448), 7, 64, 2, None),
                   ((1, 109, 224, 448), 7, 64, 2, None),
                   ((2, 3, 11, 10), 4, 3, 2, 8),
                   ((1, 55, 227, 33), 11, 96, 4, 20)]


@pytest.mark.parametrize("low_shape,k_h,k_c,s_h,w_blk", GEMM_CORE_CASES)
def test_gemm_core_maps_l_onto_the_core(low_shape, k_h, k_c, s_h, w_blk):
    """:func:`gemm_core`: I' is L, K' is kernel_mat with a unit first axis,
    stride (1, s_h); the core's (n, o_w, o_h, k_c) output strides are O's
    with h and w swapped; the core's rows are w_blk output columns (K4's
    row picker where None), its columns h_blk output rows (K4's column
    picker), both on the transposed geometry."""
    i_n, o_w, i_h, kwic = low_shape
    o_h = (i_h - k_h) // s_h + 1
    core = K.gemm_core(low_shape, (k_h, kwic, k_c), k_h, s_h, w_blk)
    assert core["inp"] == low_shape
    assert core["kernel"] == (1, k_h, kwic, k_c)
    assert core["stride"] == (1, s_h)
    assert core["out_shape"] == (i_n, o_w, o_h, k_c)
    o = torch.empty((i_n, o_h, o_w, k_c), device="meta")
    assert core["out_strides"] + (1,) == o.permute(0, 2, 1, 3).stride()
    h_blk = ops.pick_fused_w_blk(o_h, k_c, i_n, o_w)
    assert core["w_blk"] == h_blk
    assert core["oh_blk"] == (ops.pick_oh_blk(o_w, o_h, h_blk, k_c, i_n)
                              if w_blk is None else min(w_blk, o_w))


# ---------------------------------------------------------------------------
# K1/K4's f32 arithmetic: three TF32 products on the tensor cores
# ---------------------------------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 as bit rounding: round the f32 mantissa to 10 bits,
    ties away from zero (the 13 dropped bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _three_tf32(plain, x, k, *args):
    """What K1/K4 compute for f32 operands: each operand split as hi =
    tf32(v), lo = tf32(v - hi), and the conv taken as lo*hi + hi*lo +
    hi*hi, three convs of TF32 operands (whose products are exact in f32)
    each accumulated in f32 by ``plain``."""
    x_hi, k_hi = _tf32(x), _tf32(k)
    x_lo, k_lo = _tf32(x - x_hi), _tf32(k - k_hi)
    return (plain(x_lo, k_hi, *args) + plain(x_hi, k_lo, *args)
            + plain(x_hi, k_hi, *args))


SPLIT_GEOMS = ([(f"sweep{i}", g) for i, g in enumerate(SWEEP)]
               + list(EDGE_GEOMS.items()) + list(TABLE2_SMALL.items()))


def test_tf32_rounding_helper_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                       # TF32's unit in the last place
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + ulp * 0.75, 3.0])
    assert _tf32(x).tolist() == [one + ulp, -(one + ulp), one, one + ulp, 3.0]


@pytest.mark.parametrize("name,geom", SPLIT_GEOMS,
                         ids=[n for n, _ in SPLIT_GEOMS])
def test_three_tf32_split_holds_the_f32_contract(name, geom):
    """K1's and K4's plain versions through the three-product split, on
    the kernel sweep, F1's geometries and k_h < s_h, and the Table-2
    layers cut to <= 32x32 spatial and <= 8 channels, against the JAX
    package's oracle ``conv2d_ref``: within the f32 contract."""
    kh, kw, ic, s = geom[3], geom[4], geom[2], geom[6]
    jx, jk, tx, tk = _operands(geom, "float32")
    want = _to_torch(j_conv2d_ref(jx, jk, s))
    tol = fwd_tolerance("mec_fused", "float32", kh * kw * ic)
    y1 = _three_tf32(K.mec_conv_fused_plain, tx, tk, s)
    y4 = _three_tf32(K.mec_conv_fused2_plain, tx, tk, s, 3)
    assert ref.scaled_error(y1, want) <= tol
    assert ref.scaled_error(y4, want) <= tol


def test_one_tf32_product_misses_the_f32_contract_at_cv11():
    """Why the kernels spend three products: one TF32 product per
    multiply-add misses the f32 budget at cv11's reduction (3 x 3 x 256),
    by more than 10x, where the three-product split keeps it."""
    geom = (8, 8, 256, 3, 3, 8, 1)
    jx, jk, tx, tk = _operands(geom, "float32")
    want = _to_torch(j_conv2d_ref(jx, jk, 1))
    tol = fwd_tolerance("mec_fused", "float32", 3 * 3 * 256)
    one = K.mec_conv_fused_plain(_tf32(tx), _tf32(tk), 1)
    assert ref.scaled_error(one, want) > 10 * tol
    three = _three_tf32(K.mec_conv_fused_plain, tx, tk, 1)
    assert ref.scaled_error(three, want) <= tol


@pytest.mark.parametrize("mode", ["fused", "fused2", "lowered"])
@pytest.mark.parametrize("w_blk", [None, 1, 3])
def test_mec_conv2d_cuda_modes_on_cpu(mode, w_blk):
    geom = SWEEP[3]
    _, _, tx, tk = _operands(geom, "float32")
    out = ops.mec_conv2d_cuda(tx, tk, geom[6], mode=mode, w_blk=w_blk)
    oracle = ref.conv2d_f64(tx, tk, geom[6])
    assert ref.scaled_error(out, oracle) <= \
        fwd_tolerance("mec_" + mode, "float32", 4 * 5 * 2)


def test_mec_conv2d_cuda_rejects_bad_arguments():
    _, _, tx, tk = _operands(SWEEP[2], "float32")     # o_w = 7
    for bad in (0, 8, -1):
        with pytest.raises(ValueError, match="w_blk"):
            ops.mec_conv2d_cuda(tx, tk, 1, w_blk=bad)
    with pytest.raises(ValueError, match="oh_blk"):
        K.mec_conv_fused2(tx, tk, 1, oh_blk=0)
    with pytest.raises(ValueError, match="oh_blk"):
        K.mec_conv_fused2_plain(tx, tk, 1, oh_blk=0)
    with pytest.raises(ValueError, match="mode"):
        ops.mec_conv2d_cuda(tx, tk, 1, mode="nope")
    with pytest.raises(ValueError, match="w_blk"):
        K.mec_conv_fused(tx, tk, 1, w_blk=0)
    with pytest.raises(ValueError, match="kernel_mat"):
        K.mec_gemm(K.mec_lower(tx, 3, 1), tk.reshape(3, 12, 6)[:2], 3, 1)
    with pytest.raises(ValueError, match="lowering"):
        K.mec_lower(tx, 10, 1)


def test_wrappers_refuse_other_devices_and_mixed_operands():
    """Mixed devices raise.  Meta operands are a trace of the kernel path
    (``analysis.numcheck``): every step of the CUDA path but the launch,
    which becomes the op ``repro_torch::kernel_call``; nothing runs and
    nothing is counted."""
    x = torch.zeros((1, 5, 5, 2), device="meta")
    k = torch.zeros((3, 3, 2, 4), device="meta")
    K.reset_launch_counts()
    assert K.mec_lower(x, 3, 1).shape == (1, 3, 5, 6)
    for fn in (K.mec_conv_fused, K.mec_conv_fused2):
        y = fn(x, k)
        assert y.device.type == "meta" and y.shape == (1, 3, 3, 4)
    low = K.mec_lower(x, 3, 1)
    assert K.mec_gemm(low, k.reshape(3, 6, 4), 3, 1).shape == (1, 3, 3, 4)
    assert set(K.launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="different devices"):
        K.mec_conv_fused(torch.zeros((1, 5, 5, 2)), k)
    with pytest.raises(ValueError, match="different devices"):
        K.mec_conv_fused2(torch.zeros((1, 5, 5, 2)), k)


def test_cpu_path_launches_no_kernel():
    K.reset_launch_counts()
    _, _, tx, tk = _operands(SWEEP[1], "float32")
    ops.mec_conv2d_cuda(tx, tk, 2, mode="fused")
    ops.mec_conv2d_cuda(tx, tk, 2, mode="fused2")
    ops.mec_conv2d_cuda(tx, tk, 2, mode="lowered")
    assert K.launch_counts() == {"mec_conv_fused": 0, "mec_lower": 0,
                                 "mec_gemm": 0, "mec_conv_fused2": 0,
                                 "mec_weight_grad": 0}


# (o_h, o_w, k_c, i_n): the Table-3 layers at batch 1 and 16, then edges:
# one output, one output row of 4096 columns, one column of 4096 rows
@pytest.mark.parametrize("o_h,o_w,k_c,i_n", [
    (109, 109, 64, 1), (109, 109, 64, 16), (54, 54, 64, 1), (54, 54, 64, 16),
    (26, 26, 128, 1), (26, 26, 128, 16), (12, 12, 256, 1), (12, 12, 256, 16),
    (5, 5, 512, 1), (5, 5, 512, 16), (1, 1, 1, 1), (1, 4096, 8, 1),
    (4096, 1, 8, 1)])
def test_gemm_blocks_size_for_the_h100(o_h, o_w, k_c, i_n):
    """K3's blocks are K4's pickers on the transposed geometry: a CTA takes
    up to 16 output columns w (the core's rows) by output rows h (its
    columns) within the 128-position MMA tile; the columns are halved only
    while even a cluster split of 4 leaves the grid short of the SMs, the
    rows only while that holds and the block keeps one m16 tile."""
    core = K.gemm_core((i_n, o_w, o_h, 8), (1, 8, k_c), 1, 1)
    rows, cols = core["oh_blk"], core["w_blk"]
    assert 1 <= rows <= min(o_w, ops.CTA_ROWS)
    assert 1 <= cols <= min(o_h, ops.CTA_POSITIONS)
    assert rows == 1 or rows * cols <= ops.CTA_POSITIONS
    full_cols = min(o_h, ops.CTA_POSITIONS)
    if cols < full_cols:
        assert cols >= ops.MIN_FUSED_COLUMNS
        assert ops.MAX_SPLIT * i_n * o_w * -(-o_h // min(full_cols, 2 * cols)) \
            * -(-k_c // ops.CTA_CHANNELS) < ops.N_SMS
    full_rows = max(1, min(o_w, ops.CTA_POSITIONS // cols, ops.CTA_ROWS))
    if rows < full_rows:
        others = i_n * -(-o_h // cols) * -(-k_c // ops.CTA_CHANNELS)
        assert ops.MAX_SPLIT * others * -(-o_w // (2 * rows)) < ops.N_SMS
        assert rows * cols >= ops.MIN_POSITIONS


def test_gemm_blocks_stack_narrow_layers():
    """At batch 16, K3 stacks output columns into one CTA as K4 stacks
    rows: cv12's 5 x 5 and cv11's 10 x 12 outputs (columns x rows) fill
    an MMA tile, cv4 takes one column of all 109 rows."""
    def blocks(o, k_c):
        core = K.gemm_core((16, o, o, 8), (1, 8, k_c), 1, 1)
        return core["oh_blk"], core["w_blk"]
    assert blocks(5, 512) == (5, 5)
    assert blocks(12, 256) == (10, 12)
    assert blocks(109, 64) == (1, 109)


@pytest.mark.parametrize("o_w,k_c,i_n,o_h", [
    (109, 64, 1, 109), (109, 64, 16, 109), (5, 512, 16, 5), (12, 256, 1, 12),
    (1, 1, 1, 1), (4096, 8, 1, 1), (54, 64, 1, 54), (26, 128, 16, 26)])
def test_pick_fused_w_blk_sizes_for_the_h100(o_w, k_c, i_n, o_h):
    """K1/K4's block is the 128-position MMA tile, halved only while even
    the launcher's largest cluster split leaves the grid short of one CTA
    per SM, and never below 32 columns."""
    blk = ops.pick_fused_w_blk(o_w, k_c, i_n, o_h)
    full = min(o_w, ops.CTA_POSITIONS)
    assert 1 <= blk <= full
    assert blk == full or blk >= ops.MIN_FUSED_COLUMNS
    if blk < full:
        # the block before the last halving left the grid short of the SMs
        prev = min(full, 2 * blk)
        assert ops.MAX_SPLIT * i_n * o_h * -(-o_w // prev) \
            * -(-k_c // ops.CTA_CHANNELS) < ops.N_SMS


# (o_h, o_w, k_c, i_n): the Table-3 layers at batch 1 and 16, and edges
@pytest.mark.parametrize("o_h,o_w,k_c,i_n", [
    (109, 109, 64, 1), (109, 109, 64, 16), (54, 54, 64, 16), (26, 26, 128, 16),
    (12, 12, 256, 1), (12, 12, 256, 16), (5, 5, 512, 16), (1, 1, 1, 1),
    (1, 4096, 8, 1), (300, 2, 3, 1)])
def test_pick_oh_blk_sizes_for_the_h100(o_h, o_w, k_c, i_n):
    w_blk = ops.pick_fused_w_blk(o_w, k_c, i_n, o_h)
    blk = ops.pick_oh_blk(o_h, o_w, w_blk, k_c, i_n)
    assert 1 <= blk <= min(o_h, ops.CTA_ROWS)
    assert blk == 1 or blk * w_blk <= ops.CTA_POSITIONS
    others = i_n * -(-o_w // w_blk) * -(-k_c // ops.CTA_CHANNELS)
    full = max(1, min(o_h, ops.CTA_POSITIONS // w_blk, ops.CTA_ROWS))
    if blk < full:
        # halved only while even the largest cluster split left the grid
        # short of one CTA per SM (the block before the last halving was
        # 2 * blk - 1 or 2 * blk rows), and never below one m16 MMA tile
        assert ops.MAX_SPLIT * others * -(-o_h // (2 * blk)) < ops.N_SMS
        assert blk * w_blk >= ops.MIN_POSITIONS


def test_pick_oh_blk_fills_narrow_layers():
    """cv11 and cv12 at batch 16 stack output rows into one CTA: 120 and
    25 positions, where K1 runs 12 and 5; cv4's 109 columns fill the
    128-position MMA tile alone."""
    assert ops.pick_oh_blk(12, 12, 12, 256, 16) == 10
    assert ops.pick_oh_blk(5, 5, 5, 512, 16) == 5
    assert ops.pick_oh_blk(109, 109, 109, 64, 16) == 1


def test_build_names_sources_and_hashes_them():
    assert build.sources() == ["mec_conv", "mec_conv1d"]
    path = build.library_path("mec_conv")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libmec_conv-") and path.suffix == ".so"
    assert path == build.library_path("mec_conv")      # stable
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    with pytest.raises(FileNotFoundError):
        build.library_path("nope")


# ---------------------------------------------------------------------------
# K6: the MEC weight gradient
# ---------------------------------------------------------------------------

# (ih, iw, ic, kh, kw, kc, stride): cv4's 7x7 kernel at stride 2, a stride
# (2, 3) with i_c = 2, and s_h > k_h
WGRAD_GEOMS = [(16, 16, 8, 7, 7, 16, 2), (11, 13, 2, 4, 5, 3, (2, 3)),
               (8, 8, 3, 2, 2, 5, 3)]


def _wgrad_operands(geom, batch=2):
    """Seeded numpy input and cotangent of the conv's output shape, and the
    kernel size and strides."""
    ih, iw, ic, kh, kw, kc, s = geom
    s_h, s_w = (s, s) if isinstance(s, int) else s
    rng = np.random.RandomState(sum(geom[:6]))
    x = rng.randn(batch, ih, iw, ic).astype(np.float32)
    g = rng.randn(batch, (ih - kh) // s_h + 1, (iw - kw) // s_w + 1,
                  kc).astype(np.float32)
    return x, g, kh, kw, (s_h, s_w)


@pytest.mark.parametrize("geom", WGRAD_GEOMS, ids=["k7s2", "s23", "sh_gt_kh"])
def test_weight_grad_plain_matches_the_jax_vjp(geom):
    """The weight gradient on CPU tensors runs K6's plain version, launches
    nothing, and agrees with the JAX package's VJP."""
    from repro.core.conv_api import _mec_weight_grad as j_wgrad
    x, g, kh, kw, (s_h, s_w) = _wgrad_operands(geom)
    before = K.mec_weight_grad.launches
    got = K.mec_weight_grad(torch.from_numpy(x), torch.from_numpy(g), kh, kw,
                            (s_h, s_w))
    assert K.mec_weight_grad.launches == before
    want = np.array(j_wgrad(jnp.asarray(x), jnp.asarray(g), s_h, s_w, kh, kw))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    tol = 2 * grad_tolerance("mec_fused2", "float32",
                             g.shape[0] * g.shape[1] * g.shape[2])
    assert ref.scaled_error(got, torch.from_numpy(want)) <= tol


def test_weight_grad_wrapper_traces_on_meta_and_refuses_bad_operands():
    """On meta tensors the launch is one traced kernel call (f32 dW, nothing
    counted); a cotangent of another shape than the output, or operands on
    two devices, raise."""
    x = torch.zeros((2, 9, 9, 4), device="meta", dtype=torch.bfloat16)
    g = torch.zeros((2, 4, 7, 6), device="meta", dtype=torch.bfloat16)
    before = K.mec_weight_grad.launches
    dw = K.mec_weight_grad(x, g, 3, 3, (2, 1))
    assert dw.device.type == "meta" and dw.dtype == torch.float32
    assert tuple(dw.shape) == (3, 3, 4, 6)
    assert K.mec_weight_grad.launches == before
    with pytest.raises(ValueError, match="cotangent"):
        K.mec_weight_grad(torch.zeros((2, 9, 9, 4)), torch.zeros((2, 7, 7, 6)),
                          3, 3, 2)
    with pytest.raises(ValueError, match="different devices"):
        K.mec_weight_grad(torch.zeros((2, 9, 9, 4)), g.float(), 3, 3, (2, 1))


# ---------------------------------------------------------------------------
# K5: causal depthwise conv1d
# ---------------------------------------------------------------------------

# (t, c, k_w), as tests/test_kernels.py test_mec_conv1d_kernel
CONV1D_CASES = [(10, 5, 4), (1024, 256, 4), (33, 7, 3), (512, 64, 2),
                (5, 3, 4)]
CONV1D_TOL = {"float32": 2e-4, "bfloat16": 4e-2, "float16": 4e-2}


def _conv1d_operands(t, c, k_w, dtype, batch=2):
    """Seeded numpy x (batch, t, c) and kernel (k_w, c) as (jax, torch)
    pairs of ``dtype``."""
    rng = np.random.RandomState(t + 7 * c + 31 * k_w)
    x = rng.randn(batch, t, c).astype(np.float32)
    k = rng.randn(k_w, c).astype(np.float32)
    jd, td = DTYPES[dtype]
    return (jnp.asarray(x, jd), jnp.asarray(k, jd),
            torch.from_numpy(x).to(td), torch.from_numpy(k).to(td))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("t,c,k_w", CONV1D_CASES)
def test_conv1d_plain_matches_pallas(t, c, k_w, dtype):
    jx, jk, tx, tk = _conv1d_operands(t, c, k_w, dtype)
    j_out = mec_conv1d_tpu(jx, jk, interpret=True)
    t_out = ops.mec_conv1d_cuda(tx, tk)
    assert t_out.dtype == tx.dtype and tuple(t_out.shape) == j_out.shape
    tol = CONV1D_TOL[dtype]
    np.testing.assert_allclose(t_out.to(torch.float32).numpy(),
                               np.asarray(j_out, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("t,c", [(10, 5), (1024, 8)])
def test_conv1d_plain_at_kw1_matches_oracle_fault_f2(t, c):
    """At k_w = 1 the TPU kernel returns the previous time block times k
    (fault F2); the port's conv1d matches the JAX oracle there."""
    jx, jk, tx, tk = _conv1d_operands(t, c, 1, "float32")
    np.testing.assert_allclose(ops.mec_conv1d_cuda(tx, tk).numpy(),
                               np.asarray(j_conv1d_ref(jx, jk)), rtol=2e-4,
                               atol=2e-4)
    assert torch.equal(ops.mec_conv1d_cuda(tx, tk), tx * tk[0])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_conv1d_takes_a_strided_input(dtype):
    """A column slice of a wider row, as the Mamba2 block passes it, and a
    time-strided view, give the result of the contiguous input."""
    jx, jk, tx, tk = _conv1d_operands(33, 21, 4, dtype)
    strided = torch.cat([tx[..., :3], tx, tx[..., :5]], dim=-1)[..., 3:24]
    assert strided.stride() == (33 * 29, 29, 1) and torch.equal(strided, tx)
    assert torch.equal(C.mec_conv1d(strided, tk), C.mec_conv1d_plain(tx, tk))
    every_other = tx[:, ::2]
    assert torch.equal(C.mec_conv1d(every_other, tk),
                       C.mec_conv1d_plain(every_other.contiguous(), tk))
    np.testing.assert_allclose(
        C.mec_conv1d(strided, tk).to(torch.float32).numpy(),
        np.asarray(mec_conv1d_tpu(jx, jk, interpret=True), np.float32),
        rtol=CONV1D_TOL[dtype], atol=CONV1D_TOL[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k_w", [9, 16])
@pytest.mark.parametrize("t,c", [(1024, 256), (33, 7)])
def test_conv1d_plain_above_max_kw_matches_pallas_fault_f5(t, c, k_w, dtype):
    """Above MAX_KW, where the CUDA wrapper used to refuse (fault F5), the
    plain version still computes the Pallas kernel's function."""
    assert k_w > C.MAX_KW
    jx, jk, tx, tk = _conv1d_operands(t, c, k_w, dtype)
    j_out = mec_conv1d_tpu(jx, jk, interpret=True)
    t_out = C.mec_conv1d(tx, tk)
    assert t_out.dtype == tx.dtype and tuple(t_out.shape) == j_out.shape
    tol = CONV1D_TOL[dtype]
    np.testing.assert_allclose(t_out.to(torch.float32).numpy(),
                               np.asarray(j_out, np.float32), rtol=tol,
                               atol=tol)


# (x dtype, kernel dtype): fault F4's pairs
MIXED_CONV1D = [("bfloat16", "float32"), ("float32", "bfloat16"),
                ("float16", "bfloat16")]


@pytest.mark.parametrize("k_w", [4, 9])
@pytest.mark.parametrize("x_dtype,k_dtype", MIXED_CONV1D)
def test_conv1d_on_mixed_dtypes_matches_pallas_fault_f4(x_dtype, k_dtype, k_w):
    """x and kernel of two dtypes: K5's plain version promotes both and
    returns x's dtype, the Pallas kernel's function (it multiplies by the
    kernel in its own dtype).  A sub-f32 output equals the Pallas kernel's
    on all but a few elements (the kernel cast to x's dtype, the port's
    rule before, made 36% differ at k_w = 4)."""
    rng = np.random.RandomState(17 + k_w)
    x = rng.randn(2, 1024, 256).astype(np.float32)
    k = rng.randn(k_w, 256).astype(np.float32)
    jx = jnp.asarray(x, DTYPES[x_dtype][0])
    jk = jnp.asarray(k, DTYPES[k_dtype][0])
    tx = torch.from_numpy(x).to(DTYPES[x_dtype][1])
    tk = torch.from_numpy(k).to(DTYPES[k_dtype][1])
    j_out = np.array(mec_conv1d_tpu(jx, jk, interpret=True), np.float32)
    t_out = C.mec_conv1d(tx, tk)
    assert t_out.dtype == tx.dtype and t_out.is_contiguous()
    common = torch.promote_types(tx.dtype, tk.dtype)
    assert torch.equal(t_out, C.mec_conv1d_plain(tx.to(common), tk.to(common))
                       .to(tx.dtype))
    tol = CONV1D_TOL[x_dtype]
    np.testing.assert_allclose(t_out.float().numpy(), j_out, rtol=tol,
                               atol=tol)
    if x_dtype != "float32":
        assert (t_out.float().numpy() != j_out).mean() <= 1e-3


@pytest.mark.parametrize("geom", [SWEEP[2], SWEEP[3]], ids=["s1", "s23"])
@pytest.mark.parametrize("x_dtype,k_dtype", MIXED_CONV1D)
@pytest.mark.parametrize("wrapper", ["fused", "fused2", "gemm"])
def test_conv2d_wrappers_on_mixed_dtypes_match_pallas_fault_f4(
        wrapper, x_dtype, k_dtype, geom):
    """K1, K4 and K3 through their own wrappers on an input and a kernel of
    two dtypes (the plain versions): both operands promoted, the output in
    the input's dtype, equal to the bit to the run on promoted operands
    and within the input dtype's contract of the Pallas kernel in
    interpret mode, which multiplies by the kernel in its own dtype."""
    ih, iw, ic, kh, kw, kc, s = geom
    s_h, s_w = _strides(s)
    jx, _, tx, _ = _operands(geom, x_dtype)
    _, jk, _, tk = _operands(geom, k_dtype)
    common = torch.promote_types(tx.dtype, tk.dtype)
    if wrapper == "gemm":
        def run(x, k):
            return K.mec_gemm(K.mec_lower(x, kw, s_w),
                              k.reshape(kh, kw * ic, kc), kh, s_h)
        j_out = mec_gemm_pallas(mec_lower_pallas(jx, kw, s_w, interpret=True),
                                jk.reshape(kh, kw * ic, kc), kh, s_h,
                                w_blk=8, interpret=True)
    else:
        fn = K.mec_conv_fused if wrapper == "fused" else K.mec_conv_fused2
        pallas = mec_conv_fused_pallas if wrapper == "fused" \
            else mec_conv_fused2_pallas

        def run(x, k):
            return fn(x, k, (s_h, s_w), w_blk=8)
        j_out = pallas(jx, jk, (s_h, s_w), w_blk=8, interpret=True)
    t_out = run(tx, tk)
    assert t_out.dtype == tx.dtype and tuple(t_out.shape) == j_out.shape
    assert torch.equal(t_out, run(tx.to(common), tk.to(common)).to(tx.dtype))
    assert ref.scaled_error(t_out, _to_torch(j_out)) <= \
        2 * fwd_tolerance("mec_fused", x_dtype, kh * kw * ic)


def test_conv1d_plain_against_f64_oracle():
    _, _, tx, tk = _conv1d_operands(1024, 256, 4, "float32")
    oracle = ref.conv1d_ref(tx.double(), tk.double())
    assert ref.scaled_error(C.mec_conv1d_plain(tx, tk), oracle) <= 1e-6
    assert ref.scaled_error(ref.conv1d_ref(tx, tk), oracle) <= 1e-6


def test_conv1d_wrapper_refuses_bad_operands():
    """Bad operands raise.  Meta operands are a trace of the kernel path,
    as K1-K4's: the launch becomes ``repro_torch::kernel_call`` and
    nothing is counted."""
    x, k = torch.zeros((1, 8, 4)), torch.zeros((3, 4))
    C.mec_conv1d.launches = 0
    y = C.mec_conv1d(x.to("meta"), k.to("meta"))
    assert y.device.type == "meta" and y.shape == (1, 8, 4)
    assert C.mec_conv1d.launches == 0
    with pytest.raises(ValueError, match="different devices"):
        C.mec_conv1d(x, k.to("meta"))
    for dtype in (torch.float64, torch.int32):
        with pytest.raises(TypeError, match="float32/bfloat16/float16"):
            C.mec_conv1d(x.to(dtype), k.to(dtype))
    with pytest.raises(ValueError, match="k_w, c"):
        C.mec_conv1d(x, torch.zeros((3, 5)))
    with pytest.raises(ValueError, match="empty"):
        C.mec_conv1d(torch.zeros((1, 0, 4)), k)


def test_conv1d_cpu_path_launches_no_kernel():
    C.mec_conv1d.launches = 0
    _, _, tx, tk = _conv1d_operands(33, 7, 3, "bfloat16")
    ops.mec_conv1d_cuda(tx, tk)
    C.mec_conv1d(tx[:, ::2], tk)
    assert C.mec_conv1d.launches == 0


# (dtype, first column of the slice, its width c, the vector in bytes): the
# zamba2-7b conv input (columns 7168 .. 14463 of a 14576-wide row), the
# slice moved by 1, 2 and 4 elements, c off a multiple of 8, and f32
VECTOR_CASES = [("bfloat16", 7168, 7296, 16), ("bfloat16", 7169, 7296, 2),
                ("bfloat16", 7170, 7296, 4), ("bfloat16", 7172, 7296, 8),
                ("bfloat16", 7168, 7300, 8), ("bfloat16", 7168, 7298, 4),
                ("bfloat16", 7168, 7297, 2), ("float16", 7168, 7296, 16),
                ("float32", 7168, 7296, 16), ("float32", 7169, 7296, 4),
                ("float32", 7170, 7296, 8), ("float32", 7168, 7298, 8)]


@pytest.mark.parametrize("dtype,lo,c,want", VECTOR_CASES)
def test_conv1d_vector_bytes(dtype, lo, c, want):
    """K5's vector is the widest of 16, 8 and 4 bytes that divides the
    addresses, x's strides and c in bytes, else one element."""
    td = DTYPES[dtype][1]
    row = torch.empty((4, 512, 14576), dtype=td)
    assert row.data_ptr() % 16 == 0
    x = row[..., lo:lo + c]
    k, out = torch.empty((4, c), dtype=td), torch.empty((4, 512, c), dtype=td)
    assert C.vector_bytes(x, k, out) == want
    # a time stride off the vector narrows it too
    assert C.vector_bytes(row[:, :, :c].as_strided(x.shape, (512 * 14576, 14575, 1)),
                          k, out) == x.element_size()
