"""The slice as a whole: ``repro_torch.core.conv2d`` against
``repro.core.conv2d``, and the conv layer with parameters carried over
from JAX.

Inputs are made with numpy from a seed and fed to both packages.  On the
CPU the port's MEC kernels run their plain versions, and the JAX
package's Pallas kernels run in interpret mode, as its own tests run
them.  Tolerance: 2 x the contract's forward tolerance
(``numerics.fwd_tolerance``, f32 scaled by sqrt(K/27)) as a
scale-normalized max error, because each package is held to the budget
on its own.  Gradients through the MEC VJP are held to 2 x the
contract's grad tolerance (``numerics.grad_tolerance``, f32 scaled by
sqrt(R/27) with R = k_h*k_w*k_c for d_input and i_n*o_h*o_w for
d_kernel) against ``jax.vjp`` of the JAX package's ``conv2d`` on the same
cotangent.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                           # noqa: E402
import jax.numpy as jnp                              # noqa: E402

from repro.core import conv2d as j_conv2d            # noqa: E402
from repro.core import conv2d_spec as j_conv2d_spec  # noqa: E402
from repro.core.direct import direct_conv2d as j_direct  # noqa: E402
from repro.models.layers import conv2d_layer as j_conv2d_layer  # noqa: E402
from repro.models.layers import init_conv2d as j_init_conv2d  # noqa: E402

from repro_torch.convert import params_from_jax      # noqa: E402
from repro_torch.core import conv2d, conv2d_spec     # noqa: E402
from repro_torch.core.conv_api import ALGORITHMS, resolve_algorithm  # noqa: E402
from repro_torch.core.convspec import ConvSpec       # noqa: E402
from repro_torch.core.numerics import fwd_tolerance, grad_tolerance  # noqa: E402
from repro_torch.kernels import mec_conv as K        # noqa: E402
from repro_torch.kernels.ref import scaled_error     # noqa: E402
from repro_torch.models.layers import conv2d_layer, init_conv2d  # noqa: E402

ALGOS = ["direct", "im2col", "mec", "mec_lowered", "mec_fused", "mec_fused2",
         "auto"]
PLAN_ENV = ("REPRO_TORCH_PLAN_CACHE_DIR", "REPRO_TORCH_CALIBRATION",
            "REPRO_PLAN_CACHE_DIR", "REPRO_CALIBRATION")
MEC_ALGOS = ["mec", "mec_lowered", "mec_fused", "mec_fused2"]
PADDINGS = {"VALID": "VALID", "SAME": "SAME", "explicit": ((1, 2), (0, 3))}
STRIDES = {"s1": 1, "s2": 2, "s2x3": (2, 3)}
# (n, ih, iw, ic, kh, kw, kc): odd sizes, a non-square kernel
GEOM = (2, 11, 13, 3, 3, 4, 5)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def plan_env(tmp_path, monkeypatch):
    """``algorithm="auto"`` resolves through both packages' plan caches:
    keep them, and the calibrations they consult, under tmp_path."""
    import repro.plan as jplan
    import repro_torch.plan as tplan
    for name in PLAN_ENV:
        monkeypatch.setenv(name, str(tmp_path / name))
    for mod in (tplan, jplan):
        mod.reset_global_plan_cache()
        mod.reset_calibration_cache()
    yield
    for mod in (tplan, jplan):
        mod.reset_global_plan_cache()
        mod.reset_calibration_cache()


def _operands(dtype, geom=GEOM, seed=0):
    """The same seeded values as (jax, torch) input and kernel pairs."""
    n, ih, iw, ic, kh, kw, kc = geom
    rng = np.random.RandomState(seed)
    x = rng.randn(n, ih, iw, ic).astype(np.float32)
    k = (rng.randn(kh, kw, ic, kc) * (kh * kw * ic) ** -0.5).astype(np.float32)
    jd, td = DTYPES[dtype]
    return (jnp.asarray(x, jd), jnp.asarray(k, jd),
            torch.from_numpy(x).to(td), torch.from_numpy(k).to(td))


def _as_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _check(t_out, j_out, algorithm, dtype, reduction):
    assert tuple(t_out.shape) == j_out.shape
    assert t_out.dtype == DTYPES[dtype][1]
    alg = "mec" if algorithm == "auto" else algorithm
    tol = 2 * fwd_tolerance(alg, dtype, reduction)
    err = scaled_error(t_out, _as_torch(j_out))
    assert err <= tol, (algorithm, err, tol)


@pytest.mark.parametrize("stride", list(STRIDES.values()), ids=list(STRIDES))
@pytest.mark.parametrize("padding", list(PADDINGS.values()), ids=list(PADDINGS))
@pytest.mark.parametrize("algorithm", ALGOS)
def test_conv2d_matches_jax(algorithm, padding, stride):
    jx, jk, tx, tk = _operands("float32")
    j_out = j_conv2d(jx, jk, stride=stride, padding=padding,
                     algorithm=algorithm)
    t_out = conv2d(tx, tk, stride=stride, padding=padding, algorithm=algorithm)
    _check(t_out, j_out, algorithm, "float32", 3 * 4 * 3)


@pytest.mark.parametrize("algorithm", ALGOS)
def test_conv2d_matches_jax_bf16(algorithm):
    jx, jk, tx, tk = _operands("bfloat16", seed=1)
    j_out = j_conv2d(jx, jk, stride=2, padding="SAME", algorithm=algorithm)
    t_out = conv2d(tx, tk, stride=2, padding="SAME", algorithm=algorithm)
    _check(t_out, j_out, algorithm, "bfloat16", 3 * 4 * 3)


@pytest.mark.parametrize("padding", list(PADDINGS.values()), ids=list(PADDINGS))
@pytest.mark.parametrize("stride", list(STRIDES.values()), ids=list(STRIDES))
def test_conv2d_spec_matches_jax(padding, stride):
    jx, jk, tx, tk = _operands("float32")
    assert dataclasses.astuple(conv2d_spec(tx, tk, stride=stride,
                                           padding=padding)) == \
        dataclasses.astuple(j_conv2d_spec(jx, jk, stride=stride,
                                          padding=padding))


def test_cpu_slice_launches_no_kernel():
    """On CPU tensors every MEC path runs the plain versions."""
    _, _, tx, tk = _operands("float32")
    K.reset_launch_counts()
    for algorithm in ALGOS:
        conv2d(tx, tk, padding="SAME", algorithm=algorithm)
    assert K.launch_counts() == {"mec_conv_fused": 0, "mec_lower": 0,
                                 "mec_gemm": 0, "mec_conv_fused2": 0}


def test_auto_resolves_to_the_fused_kernel_on_cuda():
    """The ResNet-101 Table-3 layers at batch 16 resolve to K1 on CUDA."""
    # (i_h = i_w, i_c, k_h = k_w, k_c, stride): cv4, cv9, cv10, cv11, cv12
    for ih, ic, kh, kc, s in ((224, 64, 7, 64, 2), (56, 64, 3, 64, 1),
                              (28, 128, 3, 128, 1), (14, 256, 3, 256, 1),
                              (7, 512, 3, 512, 1)):
        spec = ConvSpec(16, ih, ih, ic, kh, kh, kc, s, s)
        assert resolve_algorithm(spec, "cuda") == "mec_fused"
        assert resolve_algorithm(spec, torch.device("cuda:0")) == "mec_fused"
    assert resolve_algorithm(ConvSpec(1, 8, 8, 4, 1, 1, 4), "cuda") == "direct"


# ---------------------------------------------------------------------------
# mixed operand dtypes (fault F4), what the slice does not run, gradients
# ---------------------------------------------------------------------------

# (input dtype, kernel dtype)
MIXED = {"x_bf16_k_f32": ("bfloat16", "float32"),
         "x_f32_k_bf16": ("float32", "bfloat16"),
         "x_f16_k_bf16": ("float16", "bfloat16")}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
              "float16": jnp.float16}


@pytest.mark.parametrize("pair", list(MIXED))
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_mixed_operand_dtypes_compute_the_references_function(algorithm,
                                                              pair):
    """An input and a kernel of two dtypes: the JAX package's result, or
    its error type (``direct`` raises ``TypeError``).  The output is in the
    input's dtype, within 2 x the contract of the input's dtype of the JAX
    package's output; a sub-f32 output equals it on all but a few
    elements, where two f32 sums summed in another order round apart
    (the kernel cast to the input's dtype, the port's rule before, made
    30% or more of the elements differ)."""
    x_d, k_d = MIXED[pair]
    rng = np.random.RandomState(11)
    x = rng.randn(2, 12, 12, 8).astype(np.float32)
    k = (rng.randn(3, 3, 8, 16) / np.sqrt(72)).astype(np.float32)
    jx, jk = jnp.asarray(x, JAX_DTYPES[x_d]), jnp.asarray(k, JAX_DTYPES[k_d])
    tx = torch.from_numpy(x).to(getattr(torch, x_d))
    tk = torch.from_numpy(k).to(getattr(torch, k_d))
    if algorithm == "direct":
        with pytest.raises(TypeError):
            j_conv2d(jx, jk, padding="SAME", algorithm=algorithm)
        with pytest.raises(TypeError, match="same dtypes"):
            conv2d(tx, tk, padding="SAME", algorithm=algorithm)
        return
    j_out = np.array(j_conv2d(jx, jk, padding="SAME",
                              algorithm=algorithm).astype(jnp.float32))
    t_out = conv2d(tx, tk, padding="SAME", algorithm=algorithm)
    assert t_out.dtype == tx.dtype and tuple(t_out.shape) == j_out.shape
    alg = "mec" if algorithm == "auto" else algorithm
    assert scaled_error(t_out, torch.from_numpy(j_out)) <= \
        2 * fwd_tolerance(alg, x_d, 3 * 3 * 8)
    if x_d != "float32":
        assert (t_out.float().numpy() != j_out).mean() <= 0.01


def test_plan_partition_and_bad_arguments_raise():
    _, _, tx, tk = _operands("float32")
    with pytest.raises(TypeError, match="ConvPlan"):
        conv2d(tx, tk, plan=object())
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        conv2d(tx, tk, partition="batch")
    assert conv2d(tx, tk, partition="none").shape == conv2d(tx, tk).shape
    with pytest.raises(ValueError, match="unknown algorithm"):
        conv2d(tx, tk, algorithm="gemm")
    with pytest.raises(ValueError, match="non-negative"):
        conv2d(tx, tk, padding=((-1, 0), (0, 0)))
    with pytest.raises(ValueError, match="kernel on"):
        conv2d(tx, tk.to("meta"))


@pytest.mark.parametrize("stride", list(STRIDES.values()), ids=list(STRIDES))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("algorithm", MEC_ALGOS)
def test_mec_gradients_match_jax(algorithm, dtype, stride):
    """d_input and d_kernel of sum(out * g) through the port's MEC VJP
    against ``jax.vjp`` of the JAX package's custom VJP, same cotangent."""
    jx, jk, tx, tk = _operands(dtype, seed=4)
    jd, td = DTYPES[dtype]
    j_out, vjp = jax.vjp(lambda a, b: j_conv2d(a, b, stride=stride,
                                               padding="SAME",
                                               algorithm=algorithm), jx, jk)
    g = np.random.RandomState(6).randn(*j_out.shape).astype(np.float32)
    j_dx, j_dk = vjp(jnp.asarray(g, jd))
    tx.requires_grad_()
    tk.requires_grad_()
    y = conv2d(tx, tk, stride=stride, padding="SAME", algorithm=algorithm)
    y.backward(torch.from_numpy(g).to(td))
    assert tx.grad.dtype == td and tk.grad.dtype == td
    i_n, o_h, o_w, k_c = y.shape
    kh, kw = tk.shape[:2]
    assert scaled_error(tx.grad, _as_torch(j_dx)) <= \
        2 * grad_tolerance(algorithm, dtype, kh * kw * k_c)
    assert scaled_error(tk.grad, _as_torch(j_dk)) <= \
        2 * grad_tolerance(algorithm, dtype, i_n * o_h * o_w)


def test_mec_backward_skips_gradients_not_asked_for():
    """Only the operands that require a gradient get one, and the
    backward launches no kernel."""
    _, _, tx, tk = _operands("float32")
    tk.requires_grad_()
    K.reset_launch_counts()
    conv2d(tx, tk, padding="SAME", algorithm="mec_fused2").sum().backward()
    assert tx.grad is None and tk.grad.shape == tk.shape
    assert sum(K.launch_counts().values()) == 0


def test_direct_gradients_match_jax():
    """The oracle's gradients (autograd through the f32 conv) against the
    JAX package's direct custom VJP, on the same cotangent."""
    jx, jk, tx, tk = _operands("float32")
    g = np.random.RandomState(5).randn(2, 9, 10, 5).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: j_direct(a, b, 1), jx, jk)
    j_dx, j_dk = vjp(jnp.asarray(g))
    tx.requires_grad_()
    tk.requires_grad_()
    conv2d(tx, tk, algorithm="direct").backward(torch.from_numpy(g))
    tol = 2 * fwd_tolerance("direct", "float32", 3 * 4 * 3)
    assert scaled_error(tx.grad, _as_torch(j_dx)) <= tol
    assert scaled_error(tk.grad, _as_torch(j_dk)) <= tol


# ---------------------------------------------------------------------------
# the conv layer, with JAX parameters carried over
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algorithm", ["auto", "mec_fused", "mec_fused2",
                                       "mec_lowered"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_conv2d_layer_with_jax_params(dtype, algorithm):
    jd, td = DTYPES[dtype]
    params = jax.device_get(j_init_conv2d(jax.random.PRNGKey(3), 3, 3, 3, 6,
                                          jd))
    params["b"] = (np.arange(6, dtype=np.float32) / 10).astype(params["b"].dtype)
    jx, _, tx, _ = _operands(dtype, seed=2)
    j_out = j_conv2d_layer(params, jx, stride=2, algorithm=algorithm)
    t_out = conv2d_layer(params_from_jax(params, device="cpu"), tx, stride=2,
                         algorithm=algorithm)
    _check(t_out, j_out, algorithm, dtype, 3 * 3 * 3)


def test_init_conv2d_is_seeded_and_scaled():
    def draw(seed):
        gen = torch.Generator(device="cpu").manual_seed(seed)
        return init_conv2d(gen, 3, 3, 64, 32, device="cpu")

    a, b, c = draw(0), draw(0), draw(1)
    assert torch.equal(a["w"], b["w"]) and not torch.equal(a["w"], c["w"])
    assert tuple(a["w"].shape) == (3, 3, 64, 32) and a["w"].dtype == torch.float32
    assert torch.equal(a["b"], torch.zeros(32))
    # N(0, 1/fan_in): the sample std of 18432 draws is within 5% of 1/24
    assert abs(a["w"].std().item() * 24 - 1) < 0.05
    gen = torch.Generator(device="cpu").manual_seed(0)
    p = init_conv2d(gen, 1, 1, 4, 2, dtype=torch.bfloat16, bias=False,
                    device="cpu")
    assert set(p) == {"w"} and p["w"].dtype == torch.bfloat16
