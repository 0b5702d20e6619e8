"""The PyTorch port's core modules against the JAX package: geometry,
memory model and contracts (exact copies), the reference algorithms
(direct / im2col / MEC A and B / VanillaMEC), the algorithm and solution
pickers, parameter conversion, and the port's import hygiene.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances are the contract budgets (``numerics.CONTRACTS``), as
scale-normalized max errors: 2 x ``fwd_tolerance`` when port and JAX are
compared, because each side is held to the budget on its own.
"""
import dataclasses
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                           # noqa: E402
import jax.numpy as jnp                              # noqa: E402

from repro.bench.scenarios import CV_LAYERS          # noqa: E402
from repro.core import convspec as jspec             # noqa: E402
from repro.core import memory as jmem                # noqa: E402
from repro.core import numerics as jnum              # noqa: E402
from repro.core.direct import direct_conv2d as j_direct  # noqa: E402
from repro.core.im2col import im2col_conv2d as j_im2col  # noqa: E402
from repro.core.mec import mec_conv2d as j_mec       # noqa: E402
from repro.core.mec import pick_solution as j_pick_solution  # noqa: E402
from repro.core.mec import vanilla_mec as j_vanilla  # noqa: E402
from repro.launch import costmodel as jcost          # noqa: E402
from repro.models.layers import init_conv2d as j_init_conv2d  # noqa: E402

from repro_torch.convert import params_from_jax      # noqa: E402
from repro_torch.core import convspec as tspec       # noqa: E402
from repro_torch.core import memory as tmem          # noqa: E402
from repro_torch.core import numerics as tnum        # noqa: E402
from repro_torch.core.direct import direct_conv2d    # noqa: E402
from repro_torch.core.im2col import im2col_conv2d    # noqa: E402
from repro_torch.core.mec import (mec_conv2d, pick_solution,  # noqa: E402
                                  vanilla_mec)
from repro_torch.kernels.ref import scaled_error     # noqa: E402
from repro_torch.launch import costmodel as tcost    # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PADDINGS = ["VALID", "SAME", 2, ((1, 2), (0, 3))]
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (None, jnp.bfloat16, torch.bfloat16)}


def _specs():
    """Every Table-2 layer at batch 1 and 16, as (name, j_spec, t_spec)."""
    out = []
    for name, (ih, iw, ic, kh, kw, kc, s) in CV_LAYERS.items():
        for n in (1, 16):
            args = (n, ih, iw, ic, kh, kw, kc, s, s)
            out.append((f"{name}-n{n}", jspec.ConvSpec(*args),
                        tspec.ConvSpec(*args)))
    return out


SPECS = _specs()


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(x, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    _, jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _err(t_out, j_out) -> float:
    return scaled_error(t_out, torch.from_numpy(np.array(j_out, np.float32)))


# ---------------------------------------------------------------------------
# exact copies: convspec / memory / numerics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,js,ts", SPECS, ids=[s[0] for s in SPECS])
def test_convspec_and_memory_equal_jax(name, js, ts):
    assert dataclasses.astuple(js) == dataclasses.astuple(ts)
    assert (js.o_h, js.o_w, js.out_shape) == (ts.o_h, ts.o_w, ts.out_shape)
    for padding in PADDINGS:
        assert jspec.padding_amounts(js.i_h, js.i_w, js.k_h, js.k_w, js.s_h,
                                     js.s_w, padding) == \
            tspec.padding_amounts(ts.i_h, ts.i_w, ts.k_h, ts.k_w, ts.s_h,
                                  ts.s_w, padding)
        assert dataclasses.astuple(jspec.padded_spec(js, padding)) == \
            dataclasses.astuple(tspec.padded_spec(ts, padding))
        for alg in list(jmem.ALL_OVERHEADS) + list(jmem._DISPATCH_BASE):
            assert jmem.algorithm_overhead(js, alg, padding) == \
                tmem.algorithm_overhead(ts, alg, padding), (alg, padding)
    assert jmem.conv_flops(js) == tmem.conv_flops(ts)
    assert jmem.mec_saving(js) == tmem.mec_saving(ts)
    assert jmem.fft_overhead(js, "SAME") == tmem.fft_overhead(ts, "SAME")
    assert jmem._DISPATCH_BASE == tmem._DISPATCH_BASE
    assert list(jmem.ALL_OVERHEADS) == list(tmem.ALL_OVERHEADS)


def test_numerics_contracts_equal_jax():
    assert jnum.CONTRACT_DTYPES == tnum.CONTRACT_DTYPES
    assert list(jnum.CONTRACTS) == list(tnum.CONTRACTS)
    for alg, contract in jnum.CONTRACTS.items():
        assert contract.to_dict() == tnum.CONTRACTS[alg].to_dict()
        for dtype in jnum.CONTRACT_DTYPES:
            assert contract.allowed_dtypes(dtype) == \
                tnum.CONTRACTS[alg].allowed_dtypes(dtype)
    for d in ("float16", "bfloat16", "float32", "float64", "int8"):
        assert jnum.float_bits(d) == tnum.float_bits(d)
    assert tnum.contract_for("nope") is None


def test_fwd_tolerance_scaling():
    """f32 budgets grow like sqrt(K/27); sub-f32 budgets do not scale."""
    f32 = jnum.CONTRACTS["mec_fused"].tolerance("float32", "fwd")
    assert tnum.fwd_tolerance("mec_fused", "float32", 27) == f32
    assert tnum.fwd_tolerance("mec_fused", "float32", 3) == f32
    assert tnum.fwd_tolerance("mec_fused", "float32", 27 * 16) == \
        pytest.approx(4 * f32)
    assert tnum.fwd_tolerance("mec", "bfloat16", 4608) == \
        jnum.CONTRACTS["mec"].tolerance("bfloat16", "fwd")


def test_grad_tolerance_scaling():
    """The "grad" budgets scale as the "fwd" ones: f32 by sqrt(R/27),
    sub-f32 not at all; a backend with no budget raises."""
    f32 = jnum.CONTRACTS["mec_fused2"].tolerance("float32", "grad")
    assert tnum.grad_tolerance("mec_fused2", "float32", 27) == f32
    assert tnum.grad_tolerance("mec_fused2", "float32", 1) == f32
    assert tnum.grad_tolerance("mec_fused2", "float32", 27 * 100) == \
        pytest.approx(10 * f32)
    for dtype in ("bfloat16", "float16"):
        assert tnum.grad_tolerance("mec", dtype, 10 ** 6) == \
            jnum.CONTRACTS["mec"].tolerance(dtype, "grad")
    with pytest.raises(KeyError, match="grad"):
        tnum.grad_tolerance("mec", "float64", 27)


def test_stride_and_spec_validation_match_jax():
    for stride in (1, 3, (2, 3), [1, 4]):
        assert jspec.normalize_stride(stride) == tspec.normalize_stride(stride)
    for bad in (0, (1, 0), (-1, 2)):
        with pytest.raises(ValueError):
            tspec.normalize_stride(bad)
    with pytest.raises(ValueError, match="channel mismatch"):
        tspec.spec_of(torch.zeros(1, 5, 5, 3), torch.zeros(3, 3, 2, 4), 1)
    with pytest.raises(ValueError, match="kernel larger"):
        tspec.spec_of(torch.zeros(1, 2, 5, 3), torch.zeros(3, 3, 3, 4), 1)
    with pytest.raises(ValueError):
        tspec.padding_amounts(8, 8, 3, 3, 1, 1, ((-1, 0), (0, 0)))


@pytest.mark.parametrize("shape,k,s", [((1, 7, 8, 2), (3, 2), (1, 1)),
                                       ((2, 10, 9, 1), (4, 5), (2, 3)),
                                       ((1, 5, 5, 3), (2, 2), (3, 2))])
def test_pad_same_equals_jax(shape, k, s):
    """SAME puts the odd pad row/column at the high end in both packages."""
    x = _rand(shape, 0)
    want = np.asarray(jspec.pad_same(jnp.asarray(x), *k, *s))
    got = tspec.pad_same(torch.from_numpy(x), *k, *s).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# reference algorithms against JAX
# ---------------------------------------------------------------------------

ALGO_GEOMS = [
    # (n, ih, iw, ic, kh, kw, kc, stride)
    (2, 9, 9, 4, 3, 3, 6, 1),
    (2, 12, 14, 3, 5, 3, 8, 2),
    (1, 11, 13, 2, 4, 5, 3, (2, 3)),
    (2, 16, 16, 8, 7, 7, 16, 2),
    (1, 56, 56, 3, 11, 11, 8, 4),
]


@pytest.mark.parametrize("geom", ALGO_GEOMS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_reference_algorithms_match_jax(geom, dtype):
    n, ih, iw, ic, kh, kw, kc, s = geom
    jx, tx = _pair(_rand((n, ih, iw, ic), 1), dtype)
    jk, tk = _pair(_rand((kh, kw, ic, kc), 2) * (kh * kw * ic) ** -0.5, dtype)
    stride = s if isinstance(s, int) else tuple(s)
    cases = {
        "direct": (direct_conv2d(tx, tk, stride), j_direct(jx, jk, stride)),
        "im2col": (im2col_conv2d(tx, tk, stride), j_im2col(jx, jk, stride)),
    }
    for sol in ("A", "B", "auto"):
        cases[f"mec{sol}"] = (mec_conv2d(tx, tk, stride, solution=sol),
                              j_mec(jx, jk, stride, solution=sol))
    for name, (t_out, j_out) in cases.items():
        alg = "mec" if name.startswith("mec") else name
        tol = 2 * tnum.fwd_tolerance(alg, dtype, kh * kw * ic)
        assert tuple(t_out.shape) == j_out.shape, name
        assert t_out.dtype == DTYPES[dtype][2], name
        err = _err(t_out, j_out)
        assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("shape,k,s", [((7, 7), (3, 3), 1), ((12, 15), (5, 4), 2),
                                       ((9, 11), (2, 3), (3, 2))])
def test_vanilla_mec_matches_jax(shape, k, s):
    x, w = _rand(shape, 3), _rand(k, 4)
    want = j_vanilla(jnp.asarray(x), jnp.asarray(w), s)
    got = vanilla_mec(torch.from_numpy(x), torch.from_numpy(w), s)
    tol = 2 * tnum.fwd_tolerance("mec", "float32", k[0] * k[1])
    assert tuple(got.shape) == want.shape
    assert _err(got, want) <= tol


def test_mec_rejects_unknown_solution():
    with pytest.raises(ValueError, match="solution"):
        mec_conv2d(torch.zeros(1, 5, 5, 1), torch.zeros(3, 3, 1, 1), 1,
                   solution="C")


# ---------------------------------------------------------------------------
# pickers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,js,ts", SPECS, ids=[s[0] for s in SPECS])
def test_pickers_match_jax(name, js, ts):
    assert pick_solution(ts) == j_pick_solution(js)
    for t in (10, 50, 100, 1000):
        assert pick_solution(ts, t) == j_pick_solution(js, t)
    assert tcost.conv2d_algorithm_costs(ts) == \
        jcost.conv2d_algorithm_costs(js, calibration=None)
    # the accelerator rule: port "cuda" <-> JAX "tpu"; CPU <-> CPU
    assert tcost.pick_conv2d_algorithm(ts, backend="cuda") == \
        jcost.pick_conv2d_algorithm(js, backend="tpu", calibration=None)
    assert tcost.pick_conv2d_algorithm(ts, backend="cpu") == \
        jcost.pick_conv2d_algorithm(js, backend="cpu", calibration=None)


def test_pickers_on_1x1_and_non_overlapping_kernels():
    for args in [(1, 8, 8, 4, 1, 1, 4, 1, 1), (1, 8, 8, 4, 2, 2, 4, 2, 2),
                 (2, 9, 9, 3, 3, 3, 5, 3, 3)]:
        js, ts = jspec.ConvSpec(*args), tspec.ConvSpec(*args)
        for jb, tb in (("tpu", "cuda"), ("cpu", "cpu")):
            assert tcost.pick_conv2d_algorithm(ts, backend=tb) == \
                jcost.pick_conv2d_algorithm(js, backend=jb, calibration=None)


# ---------------------------------------------------------------------------
# parameters from JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax(dtype):
    jd, td = DTYPES[dtype][1], DTYPES[dtype][2]
    tree = {"conv1": j_init_conv2d(jax.random.PRNGKey(0), 3, 3, 4, 8, jd),
            "stack": [j_init_conv2d(jax.random.PRNGKey(1), 1, 1, 8, 2, jd,
                                    bias=False)]}
    host = jax.device_get(tree)
    assert not host["conv1"]["w"].flags.writeable
    with warnings.catch_warnings():
        warnings.simplefilter("error")       # no read-only-array warning
        got = params_from_jax(host, device="cpu")
    assert set(got) == {"conv1", "stack"} and isinstance(got["stack"], list)
    for t, j in ((got["conv1"]["w"], host["conv1"]["w"]),
                 (got["conv1"]["b"], host["conv1"]["b"]),
                 (got["stack"][0]["w"], host["stack"][0]["w"])):
        assert t.dtype == td and tuple(t.shape) == j.shape
        np.testing.assert_array_equal(t.to(torch.float32).numpy(),
                                      np.asarray(j, np.float32))
    # a copy, not an alias of the host array
    got["conv1"]["w"].zero_()
    assert np.abs(np.asarray(host["conv1"]["w"], np.float32)).max() > 0


# ---------------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------------

def test_port_imports_no_jax_and_no_repro():
    """Import every module of the port, found by walking its packages
    (every directory of the port has an ``__init__.py``, so the walk
    reaches them all), and find no jax and no ``repro`` loaded."""
    code = (
        "import sys, pkgutil, importlib, repro_torch\n"
        "walked = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for name in walked:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('\\n'.join(walked))\n")
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    walked = set(out.stdout.split())
    src = REPO / "src"
    modules = {".".join(p.relative_to(src).with_suffix("").parts)
               for p in (src / "repro_torch").rglob("*.py")}
    modules = {m[:-len(".__init__")] if m.endswith(".__init__") else m
               for m in modules} - {"repro_torch"}
    assert modules <= walked, sorted(modules - walked)
    assert {"repro_torch.launch.costmodel", "repro_torch.launch.serve",
            "repro_torch.models.layers", "repro_torch.models.serve",
            "repro_torch.configs.archs", "repro_torch.kernels.mec_conv1d",
            "repro_torch.bench.scenarios", "repro_torch.bench.report",
            "repro_torch.bench.harness", "repro_torch.bench.check",
            "repro_torch.bench.__main__", "repro_torch.analysis",
            "repro_torch.analysis.memaudit", "repro_torch.analysis.__main__",
            "repro_torch.plan.__main__", "repro_torch.plan.calibrate"} \
        <= walked


def test_port_sources_never_import_jax_or_repro():
    files = list((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for path in files:
        for line in path.read_text().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(("import jax", "from jax",
                                            "import repro ", "import repro.",
                                            "from repro.", "from repro ")), \
                (path, line)


# ---------------------------------------------------------------------------
# F6: the plain paths' memory repaired, the same function as before
# ---------------------------------------------------------------------------

def _stacked_mec(inp, kernel, stride, solution):
    """The plain MEC before F6's repair: every row's product kept in a
    list, ``torch.stack``, then the n-h-w-c copy."""
    from repro_torch.core.direct import accum_dtype
    from repro_torch.core.mec import mec_lower
    spec = tspec.spec_of(inp, kernel, stride)
    low = mec_lower(inp, spec.k_w, spec.s_w)
    kmat = kernel.reshape(spec.k_h * spec.k_w * spec.i_c, spec.k_c) \
        .to(low.dtype)
    rs, win = spec.s_h * spec.k_w * spec.i_c, spec.k_h * spec.k_w * spec.i_c
    if solution == "A":
        l_mat = low.reshape(spec.i_n * spec.o_w, -1)
    else:
        l_mat = low.reshape(spec.i_n, spec.o_w, -1)
    acc = accum_dtype(l_mat.dtype)
    rows = [torch.matmul(l_mat[..., h * rs:h * rs + win].to(acc),
                         kmat.to(acc)).to(l_mat.dtype)
            for h in range(spec.o_h)]
    out = torch.stack(rows).reshape(spec.o_h, spec.i_n, spec.o_w, spec.k_c)
    return out.permute(1, 0, 2, 3).contiguous()


def _old_im2col(inp, kernel, stride):
    from repro_torch.core.direct import accum_dtype
    spec = tspec.spec_of(inp, kernel, stride)
    win = inp.unfold(1, spec.k_h, spec.s_h).unfold(2, spec.k_w, spec.s_w)
    low = win.permute(0, 1, 2, 4, 5, 3).reshape(
        spec.i_n * spec.o_h * spec.o_w, -1)
    acc = accum_dtype(low.dtype)
    kmat = kernel.reshape(-1, spec.k_c)
    out = torch.matmul(low.to(acc), kmat.to(low.dtype).to(acc))
    return out.to(low.dtype).reshape(spec.out_shape)


def _old_direct(inp, kernel, stride):
    from repro_torch.core.direct import accum_dtype
    acc = accum_dtype(inp.dtype)
    y = torch.nn.functional.conv2d(inp.permute(0, 3, 1, 2).to(acc),
                                   kernel.permute(3, 2, 0, 1).to(acc),
                                   stride=tspec.normalize_stride(stride))
    return y.permute(0, 2, 3, 1).to(inp.dtype).contiguous()


@pytest.mark.parametrize("geom", ALGO_GEOMS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_f6_repaired_paths_give_the_old_formulas_bits(geom, dtype):
    """The plain MEC writes each row into the output in place, with the
    same products in the same order: equal bits to the stacked formula.
    im2col and direct compute exactly what they did."""
    n, ih, iw, ic, kh, kw, kc, s = geom
    _, tx = _pair(_rand((n, ih, iw, ic), 5), dtype)
    _, tk = _pair(_rand((kh, kw, ic, kc), 6), dtype)
    stride = s if isinstance(s, int) else tuple(s)
    for sol in ("A", "B"):
        assert torch.equal(mec_conv2d(tx, tk, stride, solution=sol),
                           _stacked_mec(tx, tk, stride, sol)), sol
    assert torch.equal(im2col_conv2d(tx, tk, stride),
                       _old_im2col(tx, tk, stride))
    assert torch.equal(direct_conv2d(tx, tk, stride),
                       _old_direct(tx, tk, stride))
    assert mec_conv2d(tx, tk, stride).is_contiguous()


# odd output sizes (Winograd's last tile past the input), fewer input
# channels than FFT blocks (RGB, the blocks split the output channels),
# batches and strides
F6_GEOMS = [(1, 9, 11, 3, 3, 3, 16, 1), (3, 8, 10, 2, 3, 3, 5, 1),
            (2, 13, 12, 17, 3, 3, 9, 1), (1, 16, 15, 4, 5, 3, 3, 2),
            (2, 12, 14, 1, 3, 3, 1, 1)]


@pytest.mark.parametrize("geom", F6_GEOMS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_f6_fft_and_winograd_match_jax(geom, dtype):
    from repro.core.fft_conv import fft_conv2d as j_fft
    from repro.core.winograd import winograd_conv2d as j_wino

    from repro_torch.core.fft_conv import fft_conv2d
    from repro_torch.core.winograd import winograd_conv2d
    n, ih, iw, ic, kh, kw, kc, s = geom
    jx, tx = _pair(_rand((n, ih, iw, ic), 7), dtype)
    jk, tk = _pair(_rand((kh, kw, ic, kc), 8) * (kh * kw * ic) ** -0.5, dtype)
    cases = {"fft": (fft_conv2d(tx, tk, s), j_fft(jx, jk, s))}
    if (kh, kw, s) == (3, 3, 1):
        cases["winograd"] = (winograd_conv2d(tx, tk), j_wino(jx, jk))
    for alg, (t_out, j_out) in cases.items():
        tol = 2 * tnum.fwd_tolerance(alg, dtype, kh * kw * ic)
        assert tuple(t_out.shape) == j_out.shape and \
            t_out.dtype == DTYPES[dtype][2], alg
        assert t_out.is_contiguous()
        err = _err(t_out, j_out)
        assert err <= tol, (alg, err, tol)
