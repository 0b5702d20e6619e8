"""The port's serving slice against the JAX package: the zamba2 (hybrid)
model's layers, the Mamba2 block, the LM assembly and ``models.serve``
prefill and decode, and the serving launcher.

Inputs are made with numpy from a seed and fed to both packages; model
parameters and caches are drawn by the JAX package and carried across
with ``convert.params_from_jax``, since the two packages' random streams
differ.  Tolerances, as scale-normalized max errors (max|port - jax| /
max|jax|): 1e-5 for each ported function in f32; 1e-4 for the logits of
every step and every cache leaf of a smoke-size prefill plus four decode
steps in f32; 2e-2 for the same in bf16, the tolerance of
``tests/test_archs.py`` ``test_decode_matches_prefill``.

The bf16 reference runs op by op (``jax.disable_jit``).  Compiled, XLA's
CPU backend keeps excess precision across the bf16 casts that a fused
region contains (``xla_allow_excess_precision``), so it rounds in fewer
places than the source says; op by op it rounds where the source says,
as the port does.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                           # noqa: E402
import jax.numpy as jnp                              # noqa: E402

from repro.configs import archs as jarchs            # noqa: E402
from repro.core import mec as jmec                   # noqa: E402
from repro.models import layers as JL                # noqa: E402
from repro.models import mamba2 as JM                # noqa: E402
from repro.models import serve as jserve             # noqa: E402
from repro.models.lm import LM as JLM                # noqa: E402
from repro.models.lm import init_dense_block as j_init_dense_block  # noqa: E402

from repro_torch.configs import archs as tarchs      # noqa: E402
from repro_torch.convert import params_from_jax      # noqa: E402
from repro_torch.core import mec as tmec             # noqa: E402
from repro_torch.examples import serve_lm            # noqa: E402
from repro_torch.kernels import mec_conv1d as C      # noqa: E402
from repro_torch.launch import serve as tlaunch      # noqa: E402
from repro_torch.models import layers as TL          # noqa: E402
from repro_torch.models import lm as tlm             # noqa: E402
from repro_torch.models import mamba2 as TM          # noqa: E402
from repro_torch.models import serve as tserve       # noqa: E402

F32_TOL = 1e-5
SLICE_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
ARCH = "zamba2-7b"


def _err(port, ref) -> float:
    """max|port - ref| / max|ref|."""
    p = (port.to(torch.float64).numpy() if isinstance(port, torch.Tensor)
         else np.asarray(port, np.float64))
    r = np.asarray(ref, np.float64)
    assert p.shape == r.shape, (p.shape, r.shape)
    scale = np.abs(r).max()
    return float(np.abs(p - r).max() / (scale if scale > 0 else 1.0))


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _pair(arr):
    return jnp.asarray(arr), torch.from_numpy(arr)


def _to_torch(tree):
    return params_from_jax(jax.device_get(tree), device="cpu")


def _configs(dtype="float32", **kw):
    return (jarchs.smoke_config(ARCH).with_(dtype=dtype, **kw),
            tarchs.smoke_config(ARCH).with_(dtype=dtype, **kw))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# ---------------------------------------------------------------------------
# configuration copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(jarchs.ARCHS))
def test_configs_are_copies_of_the_jax_package(arch):
    j, t = jarchs.ARCHS[arch], tarchs.ARCHS[arch]
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    for active in (False, True):
        assert j.param_count(active) == t.param_count(active)
    assert (dataclasses.asdict(jarchs.smoke_config(arch))
            == dataclasses.asdict(tarchs.smoke_config(arch)))
    assert t.with_(conv_impl="fused").conv_impl == "fused"


def test_zamba2_7b_is_6_75b_parameters():
    assert round(tarchs.ARCHS[ARCH].param_count() / 1e9, 2) == 6.75


# ---------------------------------------------------------------------------
# conv1d (core.mec)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("fn", ["mec_conv1d_shift", "mec_conv1d_depthwise"])
@pytest.mark.parametrize("t,c,k_w", [(10, 5, 4), (33, 7, 3), (7, 4, 1),
                                     (2, 3, 4)])
def test_conv1d_functions_match_jax(fn, causal, t, c, k_w):
    (jx, tx), (jk, tk) = _pair(_rand((2, t, c), t)), _pair(_rand((k_w, c), c))
    if fn == "mec_conv1d_shift" and not causal and k_w > 1:
        # the shifted slices are shorter than t: both packages refuse
        with pytest.raises(TypeError):
            jmec.mec_conv1d_shift(jx, jk, causal=False)
        with pytest.raises(ValueError, match="k_w = 1"):
            tmec.mec_conv1d_shift(tx, tk, causal=False)
        return
    out = getattr(tmec, fn)(tx, tk, causal=causal)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    assert _err(out, getattr(jmec, fn)(jx, jk, causal=causal)) <= F32_TOL


def test_conv1d_lowered_form_materializes_l():
    """The lowered conv1d builds L (n*t*k_w*c elements) and reads it
    through a view: its output is a permuted view of the GEMM's result."""
    x, k = torch.from_numpy(_rand((2, 9, 5), 1)), torch.from_numpy(_rand((3, 5), 2))
    out = tmec.mec_conv1d_depthwise(x, k)
    assert out.shape == (2, 9, 5) and not out.is_contiguous()
    assert torch.allclose(out, tmec.mec_conv1d_shift(x, k), atol=1e-6)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    x, w = _rand((2, 5, 64), 0, 3.0), _rand((64,), 1, 0.1) + 1
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    j = JL.rms_norm(jnp.asarray(x, jd), jnp.asarray(w, jd), 1e-6)
    t = TL.rms_norm(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td), 1e-6)
    assert t.dtype == td
    # bf16: within one rounding of the output (2^-8 relative)
    assert _err(t, np.asarray(j, np.float32)) <= (F32_TOL if dtype == "float32"
                                                  else 2.0 ** -8)


@pytest.mark.parametrize("bias", [False, True])
def test_linear_and_init_linear_match_jax(bias):
    p = JL.init_linear(jax.random.key(0), 48, 80, jnp.float32, bias=bias)
    if bias:
        p["b"] = jnp.asarray(_rand((80,), 3))
    (jx, tx) = _pair(_rand((3, 4, 48), 2))
    assert _err(TL.linear(tx, _to_torch(p)), JL.linear(jx, p)) <= F32_TOL
    tp = TL.init_linear(torch.Generator().manual_seed(0), 48, 80,
                        torch.float32, bias=bias, device="cpu")
    assert sorted(tp) == sorted(p) and tp["w"].shape == (48, 80)
    assert abs(tp["w"].std().item() - 48 ** -0.5) < 0.1 * 48 ** -0.5


def test_swiglu_matches_jax():
    p = JL.init_swiglu(jax.random.key(1), 32, 96, jnp.float32)
    jx, tx = _pair(_rand((2, 7, 32), 4))
    assert _err(TL.swiglu(tx, _to_torch(p)), JL.swiglu(jx, p)) <= F32_TOL


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_jax(theta):
    pos = np.array([0, 1, 5, 17, 300, 1023], np.int32)
    jc, js = JL.rope_cos_sin(jnp.asarray(pos), 16, theta)
    tc, ts = TL.rope_cos_sin(torch.from_numpy(pos), 16, theta)
    assert _err(tc, jc) <= F32_TOL and _err(ts, js) <= F32_TOL
    jx, tx = _pair(_rand((2, 6, 3, 16), 5))
    assert _err(TL.apply_rope(tx, tc, ts), JL.apply_rope(jx, jc, js)) <= F32_TOL


@pytest.mark.parametrize("sq,q_chunk,kv_chunk,kv,causal", [
    (16, 16, 16, 4, True),      # one chunk
    (16, 4, 8, 2, True),        # several chunks, GQA
    (13, 4, 8, 4, True),        # s not a multiple of either chunk
    (13, 16, 5, 1, True),       # chunks wider than s, MQA
    (11, 4, 3, 2, False),       # bidirectional
])
def test_chunked_attention_matches_jax(sq, q_chunk, kv_chunk, kv, causal):
    jq, tq = _pair(_rand((2, sq, 4, 8), 6))
    jk, tk = _pair(_rand((2, sq, kv, 8), 7))
    jv, tv = _pair(_rand((2, sq, kv, 8), 8))
    t = TL.chunked_attention(tq, tk, tv, causal=causal, q_chunk=q_chunk,
                             kv_chunk=kv_chunk)
    j = JL.chunked_attention(jq, jk, jv, causal=causal, q_chunk=q_chunk,
                             kv_chunk=kv_chunk)
    assert t.shape == tq.shape and _err(t, j) <= F32_TOL


@pytest.mark.parametrize("cache_len", [1, 9, 12])
def test_decode_attention_matches_jax(cache_len):
    jq, tq = _pair(_rand((2, 1, 4, 8), 9))
    jk, tk = _pair(_rand((2, 12, 2, 8), 10))
    jv, tv = _pair(_rand((2, 12, 2, 8), 11))
    t = TL.decode_attention(tq, tk, tv, torch.tensor(cache_len, dtype=torch.int32))
    j = JL.decode_attention(jq, jk, jv, jnp.asarray(cache_len, jnp.int32))
    assert _err(t, j) <= F32_TOL


def test_attention_decode_writes_the_cache_at_len():
    _, tcfg = _configs()
    jcfg, _ = _configs()
    p = JL.init_attention(jax.random.key(2), jcfg, jnp.float32)
    jc = JL.init_kv_cache(jcfg, 2, 10, jnp.float32)
    jc = dict(jc, k=jnp.asarray(_rand(jc["k"].shape, 12)),
              v=jnp.asarray(_rand(jc["v"].shape, 13)),
              len=jnp.asarray(6, jnp.int32))
    tc = _to_torch(jc)
    jx, tx = _pair(_rand((2, 1, jcfg.d_model), 14))
    j_out, j_new = JL.attention_decode(p, jcfg, jx, jc)
    t_out, t_new = TL.attention_decode(_to_torch(p), tcfg, tx, tc)
    assert _err(t_out, j_out) <= F32_TOL
    for leaf in ("k", "v"):
        assert _err(t_new[leaf], j_new[leaf]) <= F32_TOL
        assert t_new[leaf] is tc[leaf]                 # written in place
    assert int(t_new["len"]) == 7 and t_new["len"].dtype == torch.int32


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk", [(16, 8), (16, 16), (12, 4), (5, 128)])
def test_ssd_chunked_matches_jax(s, chunk):
    b, h, p, n = 2, 3, 4, 5
    x, b_mat, c_mat = _rand((b, s, h, p), 15), _rand((b, s, n), 16), _rand((b, s, n), 17)
    dt = np.log1p(np.exp(_rand((b, s, h), 18)))
    a = -np.exp(_rand((h,), 19, 0.5))
    j_y, j_state = JM.ssd_chunked(*map(jnp.asarray, (x, dt, a, b_mat, c_mat)),
                                  chunk=chunk)
    t_y, t_state = TM.ssd_chunked(*map(torch.from_numpy, (x, dt, a, b_mat, c_mat)),
                                  chunk=chunk)
    assert _err(t_y, j_y) <= F32_TOL and _err(t_state, j_state) <= F32_TOL


def test_ssd_chunked_rejects_a_ragged_chunk():
    x = torch.zeros((1, 13, 2, 3))
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        TM.ssd_chunked(x, torch.zeros((1, 13, 2)), torch.zeros(2),
                       torch.zeros((1, 13, 4)), torch.zeros((1, 13, 4)),
                       chunk=8)


@pytest.mark.parametrize("conv_impl", ["lowered", "fused"])
def test_mamba_core_and_decode_match_jax(conv_impl):
    jcfg, tcfg = _configs(conv_impl=conv_impl)
    p = JM.init_mamba(jax.random.key(3), jcfg, jnp.float32)
    tp = _to_torch(p)
    jx, tx = _pair(_rand((2, 16, jcfg.d_model), 20))
    C.mec_conv1d.launches = 0
    t_out, t_cache = TM.mamba_core(tp, tcfg, tx)
    j_out, j_cache = JM.mamba_core(p, jcfg, jx)
    assert C.mec_conv1d.launches == 0                   # CPU: plain version
    assert _err(t_out, j_out) <= F32_TOL
    for leaf in ("state", "conv"):
        assert _err(t_cache[leaf], j_cache[leaf]) <= F32_TOL
    assert _err(TM.mamba_forward(tp, tcfg, tx), j_out) <= F32_TOL
    jy, ty = _pair(_rand((2, 1, jcfg.d_model), 21))
    j_dec, j_new = JM.mamba_decode(p, jcfg, jy, j_cache)
    t_dec, t_new = TM.mamba_decode(tp, tcfg, ty, t_cache)
    assert _err(t_dec, j_dec) <= F32_TOL
    for leaf in ("state", "conv"):
        assert _err(t_new[leaf], j_new[leaf]) <= F32_TOL


def test_mamba_conv1d_routes_by_conv_impl(monkeypatch):
    """``fused`` goes through the K5 entry point, ``lowered`` through the
    compact-L form, as ``mamba2.conv1d`` picks in the JAX package."""
    seen = []
    monkeypatch.setattr(TM, "mec_conv1d_cuda",
                        lambda x, w: seen.append("K5") or C.mec_conv1d(x, w))
    monkeypatch.setattr(TM, "mec_conv1d_depthwise",
                        lambda x, w: seen.append("L") or tmec.mec_conv1d_depthwise(x, w))
    x, w = torch.from_numpy(_rand((1, 6, 4), 22)), torch.from_numpy(_rand((4, 4), 23))
    _, tcfg = _configs()
    for impl in ("fused", "lowered"):
        TM.conv1d(tcfg.with_(conv_impl=impl), x, w)
    assert seen == ["K5", "L"]


# ---------------------------------------------------------------------------
# the LM and its serving paths
# ---------------------------------------------------------------------------

def test_init_has_the_jax_tree_shapes_and_dtypes():
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = _configs(dtype)
        shapes = _leaves(jax.eval_shape(JLM(jcfg).init, jax.random.key(0)))
        params = _leaves(tlm.LM(tcfg).init(torch.Generator().manual_seed(0),
                                           device="cpu"))
        assert sorted(shapes) == sorted(params)
        for name, sds in shapes.items():
            assert tuple(params[name].shape) == sds.shape, name
            assert str(params[name].dtype).split(".")[-1] == str(sds.dtype), name
    emb = params["/emb"].to(torch.float32)
    assert abs(emb.std().item() - 0.02) < 0.002
    blk = _leaves(j_init_dense_block(jax.random.key(0), jcfg, jnp.float32))
    assert sorted(blk) == sorted(k[len("/shared"):] for k in params
                                 if k.startswith("/shared"))


def test_init_decode_cache_has_the_jax_tree():
    jcfg, tcfg = _configs()
    j = _leaves(jax.device_get(jserve.init_decode_cache(JLM(jcfg), 2, 9)))
    t = _leaves(tserve.init_decode_cache(tlm.LM(tcfg), 2, 9, device="cpu"))
    assert sorted(j) == sorted(t)
    for name in j:
        assert tuple(t[name].shape) == np.shape(j[name]), name
        assert _err(t[name], j[name]) == 0.0


@pytest.mark.parametrize("dtype,conv_impl", [("float32", "lowered"),
                                             ("float32", "fused"),
                                             ("bfloat16", "fused")])
def test_hybrid_serving_matches_jax(dtype, conv_impl):
    """smoke_config("zamba2-7b"): 5 layers, two super-blocks of 2 and a
    tail of 1.  A 16-token prefill, then 4 decode steps fed the same
    tokens in both packages: the logits of every step and every cache
    leaf agree."""
    jcfg, tcfg = _configs(dtype, conv_impl=conv_impl)
    jm, tm = JLM(jcfg), tlm.LM(tcfg)
    jp = jm.init(jax.random.key(0))
    tp = _to_torch(jp)
    toks = np.random.RandomState(1).randint(0, jcfg.vocab, (2, 20))
    max_len, tol = 24, SLICE_TOL[dtype]
    errs = {}
    with jax.disable_jit(dtype != "float32"):
        j_logits, j_cache = jserve.prefill(
            jm, jp, {"tokens": jnp.asarray(toks[:, :16], jnp.int32)}, max_len)
        t_logits, t_cache = tserve.prefill(
            tm, tp, {"tokens": torch.from_numpy(toks[:, :16])}, max_len)
        errs["prefill"] = _err(t_logits, j_logits)
        for step in range(4):
            tok = toks[:, 16 + step:17 + step]
            j_logits, j_cache = jserve.decode_step(
                jm, jp, j_cache, jnp.asarray(tok, jnp.int32))
            t_logits, t_cache = tserve.decode_step(
                tm, tp, t_cache, torch.from_numpy(tok))
            assert t_logits.dtype == torch.float32
            errs[f"decode{step}"] = _err(t_logits, j_logits)
    j_leaves = _leaves(jax.device_get(j_cache))
    t_leaves = _leaves(t_cache)
    assert sorted(j_leaves) == sorted(t_leaves)
    assert "/tail/state" in t_leaves and int(t_leaves["/len"]) == 20
    for name, leaf in j_leaves.items():
        errs[name] = _err(t_leaves[name], leaf)
    assert max(errs.values()) <= tol, errs


@pytest.mark.parametrize("conv_impl", ["lowered", "fused"])
def test_decode_matches_prefill(conv_impl):
    """test_archs.py test_decode_matches_prefill for the port: a prefill
    of s - 1 tokens and one decode step against a prefill of all s."""
    _, cfg = _configs(conv_impl=conv_impl)
    model = tlm.LM(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 17),
                         generator=torch.Generator().manual_seed(1))
    _, cache = tserve.prefill(model, params, {"tokens": toks[:, :16]}, 25)
    logits_dec, _ = tserve.decode_step(model, params, cache, toks[:, 16:])
    logits_ref, _ = tserve.prefill(model, params, {"tokens": toks}, 25)
    rel = ((logits_dec - logits_ref).abs().max()
           / (logits_ref.abs().max() + 1e-9)).item()
    assert rel < 2e-2


def test_params_from_jax_carries_stacks_none_and_int32():
    jcfg, _ = _configs()
    cache = jax.device_get(jserve.prefill(
        JLM(jcfg), JLM(jcfg).init(jax.random.key(0)),
        {"tokens": jnp.zeros((1, 4), jnp.int32)}, 6)[1])
    cache["tail"] = None            # as when attn_every divides n_layers
    got = params_from_jax(cache, device="cpu")
    assert got["tail"] is None
    assert got["len"].dtype == torch.int32 and got["len"].dim() == 0
    assert int(got["len"]) == 4
    assert tuple(got["mamba"]["state"].shape) == cache["mamba"]["state"].shape


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

SMOKE_ARGS = ["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len",
              "8", "--gen", "5", "--device", "cpu"]


def test_serve_main_greedy_decode_is_deterministic():
    g1 = tlaunch.main(SMOKE_ARGS)
    g2 = tlaunch.main(SMOKE_ARGS)
    assert g1.shape == (2, 5) and int(g1.min()) >= 0
    assert torch.equal(g1, g2)


def test_serve_returns_tokens_logits_and_timings():
    _, cfg = _configs()
    res = tlaunch.serve(cfg.with_(conv_impl="fused"), batch=2, prompt_len=8,
                        gen=4, temperature=0.8, device="cpu", seed=3)
    again = tlaunch.serve(cfg.with_(conv_impl="fused"), batch=2,
                          prompt_len=8, gen=4, temperature=0.8, device="cpu",
                          seed=3)
    assert res["tokens"].shape == (2, 4) and torch.equal(res["tokens"],
                                                         again["tokens"])
    assert res["prefill_logits"].shape == (2, cfg.vocab)
    assert bool(torch.isfinite(res["logits"]).all())
    assert res["prefill_s"] > 0 and res["decode_tokens_per_s"] > 0
    greedy = tlaunch.serve(cfg, batch=2, prompt_len=8, gen=4, device="cpu",
                           seed=3)
    assert torch.equal(greedy["tokens"][:, :1],
                       res["prefill_logits"].argmax(-1)[:, None])


def test_example_serve_lm_runs_on_cpu():
    gen = serve_lm.main(["--device", "cpu"])
    assert gen.shape == (4, 12)


@pytest.mark.parametrize("flags,item", [
    (["--mesh", "production"], "need 256 devices"),
    (["--mesh", "multipod"], "need 512 devices")])
def test_unported_flags_raise(flags, item):
    """The production meshes raise the JAX package's "need N devices" on a
    world of one process."""
    with pytest.raises(ValueError, match=item):
        tlaunch.main(SMOKE_ARGS + flags)


def test_warm_plans_serves_llava_through_the_patch_embed(tmp_path,
                                                         monkeypatch, capsys):
    """The vlm family's frontend: ``--warm-plans`` warms the patch embed
    and serves its vision tokens ahead of the prompt."""
    from repro_torch import plan
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    monkeypatch.setenv("REPRO_TORCH_CALIBRATION", str(tmp_path / "off.json"))
    plan.reset_global_plan_cache()
    try:
        gen = tlaunch.main(SMOKE_ARGS + ["--warm-plans", "--arch",
                                         "llava-next-34b"])
    finally:
        plan.reset_global_plan_cache()
    assert gen.shape == (2, 5)
    out = capsys.readouterr().out
    assert "warmed 2/2 shape class(es)" in out and "warmed 1 conv service" in out


def test_warm_plans_on_a_family_without_a_frontend(capsys):
    gen = tlaunch.main(SMOKE_ARGS + ["--warm-plans"])
    assert gen.shape == (2, 5)
    assert "has no conv frontend; nothing to warm" in capsys.readouterr().out
