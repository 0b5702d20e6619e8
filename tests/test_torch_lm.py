"""The port's dense and vlm families, the int8 KV cache and triangle
attention against the JAX package, on the CPU.

The four dense architectures (qwen3-4b, phi3-medium-14b, command-r-35b,
yi-6b) and llava-next-34b at their smoke sizes: ``LM.init``'s tree,
``models.serve`` prefill, four decode steps and every cache leaf;
``quantize_kv``, the int8 branches of ``decode_attention``,
``attention_decode``, ``init_kv_cache`` and ``init_decode_cache`` (the
five tests of ``tests/test_kv_quant.py``, ported), and
``chunked_attention_tri`` (``attn_skip_masked``).  Inputs are made with
numpy from a seed; parameters and caches are drawn by the JAX package and
carried across with ``convert.params_from_jax``.

Tolerances, as scale-normalised max errors (max|port - jax| / max|jax|),
those of ``tests/test_torch_serve.py``: 1e-5 for a function in f32, 1e-4
for the logits of every step and every cache leaf of a prefill plus four
decode steps in f32, 2e-2 for the same in bf16 (the JAX side op by op,
``jax.disable_jit``); int8 against float within the JAX package's gates
(``tests/test_kv_quant.py``: 0.03 for attention, 0.05 for dense decode).
``quantize_kv`` equals the JAX package's to the bit, and triangle
attention equals ``chunked_attention`` to the bit with the same chunks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                           # noqa: E402
import jax.numpy as jnp                              # noqa: E402

import repro_torch.plan as plan_mod                  # noqa: E402
from repro.configs import archs as jarchs            # noqa: E402
from repro.models import layers as JL                # noqa: E402
from repro.models import serve as jserve             # noqa: E402
from repro.models.lm import LM as JLM                # noqa: E402

from repro_torch.configs import archs as tarchs      # noqa: E402
from repro_torch.convert import params_from_jax      # noqa: E402
from repro_torch.launch import serve as tlaunch      # noqa: E402
from repro_torch.models import layers as TL          # noqa: E402
from repro_torch.models import lm as tlm             # noqa: E402
from repro_torch.models import serve as tserve       # noqa: E402

F32_TOL = 1e-5
SLICE_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DENSE = ["qwen3-4b", "phi3-medium-14b", "command-r-35b", "yi-6b"]
ATTN_ARCHS = DENSE + ["llava-next-34b"]
SSM_ARCH = "xlstm-125m"
INT8_ATTN_GATE, INT8_DECODE_GATE = 0.03, 0.05


@pytest.fixture(autouse=True)
def plan_env(tmp_path, monkeypatch):
    """The port's plan cache and calibration under tmp_path (the warmed
    patch embed plans through the cache)."""
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE_DIR", str(tmp_path / "plans"))
    monkeypatch.setenv("REPRO_TORCH_CALIBRATION", str(tmp_path / "off.json"))
    plan_mod.reset_global_plan_cache()
    plan_mod.reset_calibration_cache()
    yield
    plan_mod.reset_global_plan_cache()
    plan_mod.reset_calibration_cache()


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


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _configs(arch, dtype="float32", **kw):
    return (jarchs.smoke_config(arch).with_(dtype=dtype, **kw),
            tarchs.smoke_config(arch).with_(dtype=dtype, **kw))


def _batches(cfg, toks):
    """The prefill batch of both packages: tokens, and for the vlm family
    seeded vision tokens (B, prefix_len, d_model)."""
    jb = {"tokens": jnp.asarray(toks, jnp.int32)}
    tb = {"tokens": torch.from_numpy(toks)}
    if cfg.family == "vlm":
        jb["vision"], tb["vision"] = _pair(
            _rand((toks.shape[0], cfg.prefix_len, cfg.d_model), 30))
    return jb, tb


# ---------------------------------------------------------------------------
# the LM's tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ATTN_ARCHS + [SSM_ARCH])
def test_init_has_the_jax_tree(arch, dtype):
    jcfg, tcfg = _configs(arch, dtype)
    shapes = _leaves(jax.eval_shape(JLM(jcfg).init, jax.random.key(0)))
    params = _leaves(tlm.LM(tcfg).init(torch.Generator().manual_seed(0),
                                       device="cpu"))
    assert sorted(shapes) == sorted(params)
    for name, sds in shapes.items():
        assert tuple(params[name].shape) == sds.shape, name
        assert str(params[name].dtype).split(".")[-1] == str(sds.dtype), name
    assert ("/vision_proj/w" in params) == (tcfg.family == "vlm")
    if tcfg.family == "ssm":
        n_super = tcfg.n_layers // tcfg.slstm_every
        assert params["/mlstm/wq/w"].shape[:2] == (n_super,
                                                   tcfg.slstm_every - 1)
        assert params["/slstm/r_gates"].shape[0] == n_super
    else:
        assert params["/blocks/attn/wq/w"].shape[0] == tcfg.n_layers


def test_llava_next_34b_is_34_39b_parameters():
    assert round(tarchs.ARCHS["llava-next-34b"].param_count() / 1e9, 2) == 34.39
    assert round(tarchs.ARCHS["qwen3-4b"].param_count() / 1e9, 2) == 4.02


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("arch", ["qwen3-4b", "llava-next-34b", SSM_ARCH])
def test_init_decode_cache_has_the_jax_tree(arch, int8):
    jcfg, tcfg = _configs(arch, kv_cache_int8=int8)
    j = _leaves(jax.device_get(jserve.init_decode_cache(JLM(jcfg), 2, 9)))
    t = _leaves(tserve.init_decode_cache(tlm.LM(tcfg), 2, 9, device="cpu"))
    assert sorted(j) == sorted(t)
    for name in j:
        assert tuple(t[name].shape) == np.shape(j[name]), name
        assert str(t[name].dtype).split(".")[-1] == str(j[name].dtype), name
        assert _err(t[name], j[name]) == 0.0


# ---------------------------------------------------------------------------
# serving: prefill and decode against the JAX package
# ---------------------------------------------------------------------------

def _serve_both(arch, dtype, n_prefill=16, steps=4, max_len=24, **kw):
    """Prefill and ``steps`` decode steps fed the same tokens in both
    packages; the scale-normalised error of every step's logits and every
    cache leaf."""
    jcfg, tcfg = _configs(arch, dtype, **kw)
    jm, tm = JLM(jcfg), tlm.LM(tcfg)
    jp = jm.init(jax.random.key(0))
    tp = _to_torch(jp)
    toks = np.random.RandomState(1).randint(0, jcfg.vocab,
                                            (2, n_prefill + steps))
    jb, tb = _batches(jcfg, toks[:, :n_prefill])
    max_len += jcfg.prefix_len if jcfg.family == "vlm" else 0
    errs = {}
    with jax.disable_jit(dtype != "float32"):
        j_logits, j_cache = jserve.prefill(jm, jp, jb, max_len)
        t_logits, t_cache = tserve.prefill(tm, tp, tb, max_len)
        errs["prefill"] = _err(t_logits, j_logits)
        for step in range(steps):
            tok = toks[:, n_prefill + step:n_prefill + step + 1]
            j_logits, j_cache = jserve.decode_step(
                jm, jp, j_cache, jnp.asarray(tok, jnp.int32))
            t_logits, t_cache = tserve.decode_step(tm, tp, t_cache,
                                                   torch.from_numpy(tok))
            assert t_logits.dtype == torch.float32
            errs[f"decode{step}"] = _err(t_logits, j_logits)
    j_leaves = _leaves(jax.device_get(j_cache))
    t_leaves = _leaves(t_cache)
    assert sorted(j_leaves) == sorted(t_leaves)
    for name, leaf in j_leaves.items():
        errs[name] = _err(t_leaves[name], leaf)
    return errs, t_cache


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_attention_families_serving_matches_jax(arch):
    """Smoke size, f32: a 16-token prefill (the vlm family behind 8 vision
    tokens), then 4 decode steps: every step's logits and every cache leaf
    within 1e-4; the cache's length counts the prefix."""
    errs, cache = _serve_both(arch, "float32")
    assert max(errs.values()) <= SLICE_TOL["float32"], errs
    prefix = tarchs.smoke_config(arch).prefix_len if "llava" in arch else 0
    assert int(cache["len"]) == 20 + prefix


@pytest.mark.parametrize("arch", ["qwen3-4b", "llava-next-34b"])
def test_attention_families_serving_matches_jax_bf16(arch):
    errs, _ = _serve_both(arch, "bfloat16")
    assert max(errs.values()) <= SLICE_TOL["bfloat16"], errs


@pytest.mark.parametrize("arch", ["yi-6b", "phi3-medium-14b"])
def test_serving_with_attn_skip_masked_matches_jax(arch):
    """attn_skip_masked routes prefill through the triangle attention in
    both packages; a 40-token prefill crosses the 16-wide chunks."""
    errs, _ = _serve_both(arch, "float32", n_prefill=40, max_len=48,
                          attn_skip_masked=True)
    assert max(errs.values()) <= SLICE_TOL["float32"], errs


@pytest.mark.parametrize("arch", ATTN_ARCHS + [SSM_ARCH])
def test_decode_matches_prefill(arch):
    """tests/test_archs.py test_decode_matches_prefill for the port: a
    prefill of s - 1 tokens and one decode step against a prefill of all
    s."""
    cfg = tarchs.smoke_config(arch)
    model = tlm.LM(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.RandomState(2).randint(0, cfg.vocab, (2, 17))
    _, tb = _batches(cfg, toks)
    short = dict(tb, tokens=tb["tokens"][:, :16])
    max_len = 25 + cfg.prefix_len
    _, cache = tserve.prefill(model, params, short, max_len)
    logits_dec, _ = tserve.decode_step(model, params, cache,
                                       tb["tokens"][:, 16:])
    logits_ref, _ = tserve.prefill(model, params, tb, max_len)
    rel = ((logits_dec - logits_ref).abs().max()
           / (logits_ref.abs().max() + 1e-9)).item()
    assert rel < 2e-2


def test_decode_writes_the_cache_in_place():
    _, tcfg = _configs("yi-6b")
    model = tlm.LM(tcfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    cache = tserve.init_decode_cache(model, 2, 8, device="cpu")
    cache["len"].zero_()
    k = cache["k"]
    _, new = tserve.decode_step(model, params, cache,
                                torch.zeros((2, 1), dtype=torch.long))
    assert new["k"] is k and int(new["len"]) == 1
    assert float(k[:, :, 0].abs().sum()) > 0 and float(k[:, :, 1:].abs().sum()) == 0


# Fault F9: a second witness for the bf16 drift of decode against prefill.
# qwen3-4b at its published widths (d_model 2560, vocab 151936) and 4 of
# its 36 layers, bf16, one set of weights, 2 prompts of 16 tokens and 4
# decode steps.  Measured on the CPU (jax 0.9.0, torch 2.13): the JAX
# package (compiled, as it serves) 0.0183, the port 0.0162, a factor of
# 0.88; the port's logits against the JAX package's at most 0.0159 a step
# (the test prints them).
F9_LAYERS, F9_PROMPT, F9_STEPS = 4, 16, 4
#: the port's drift over the JAX package's must lie within this factor
#: either way, and the packages' logits within it of the JAX drift
F9_FACTOR = 2.0


def _drift(prefill, decode_step, model, params, toks, to_tokens, to_np):
    """(each step's logits, the last decode step's error against a prefill
    of all the tokens) of one package."""
    n = F9_PROMPT + F9_STEPS
    logits, cache = prefill(model, params,
                            {"tokens": to_tokens(toks[:, :F9_PROMPT])}, n)
    steps = [to_np(logits)]
    for t in range(F9_PROMPT, n):
        logits, cache = decode_step(model, params, cache,
                                    to_tokens(toks[:, t:t + 1]))
        steps.append(to_np(logits))
    full, _ = prefill(model, params, {"tokens": to_tokens(toks)}, n)
    return steps, _err(steps[-1], to_np(full))


def test_bf16_drift_at_full_width_is_the_jax_package_own():
    """Fault F9: in bf16 the decode-against-prefill error of random-weight
    layers is the rounding of two differently shaped computations, and the
    JAX package shows it as much as the port does.  Both packages on the
    JAX package's weights (carried across) and the same tokens: the port's
    error within a factor F9_FACTOR of the JAX package's either way, and
    every step's logits of the two packages within F9_FACTOR x the JAX
    package's own error of each other."""
    jcfg = jarchs.ARCHS["qwen3-4b"].with_(n_layers=F9_LAYERS)
    tcfg = tarchs.ARCHS["qwen3-4b"].with_(n_layers=F9_LAYERS)
    assert jcfg.dtype == tcfg.dtype == "bfloat16"
    jm = JLM(jcfg)
    jp = jax.jit(jm.init)(jax.random.key(0))
    toks = np.random.RandomState(1).randint(0, jcfg.vocab,
                                            (2, F9_PROMPT + F9_STEPS))
    j_steps, j_err = _drift(
        jax.jit(jserve.prefill, static_argnums=(0, 3)),
        jax.jit(jserve.decode_step, static_argnums=0), jm, jp, toks,
        lambda t: jnp.asarray(t, jnp.int32),
        lambda x: np.asarray(x, np.float32))
    host = jax.device_get(jp)
    del jp
    tp = params_from_jax(host, device="cpu")
    del host
    with torch.inference_mode():
        t_steps, t_err = _drift(tserve.prefill, tserve.decode_step,
                                tlm.LM(tcfg), tp, toks, torch.from_numpy,
                                lambda x: x.numpy())
    cross = [_err(a, b) for a, b in zip(t_steps, j_steps)]
    print(f"F9: decode against prefill, jax {j_err:.4g}, port {t_err:.4g}; "
          f"port against jax, a step at most {max(cross):.4g}")
    assert 1 / F9_FACTOR <= t_err / j_err <= F9_FACTOR, (t_err, j_err)
    assert max(cross) <= F9_FACTOR * j_err, (cross, j_err)


# ---------------------------------------------------------------------------
# the int8 KV cache (tests/test_kv_quant.py, ported)
# ---------------------------------------------------------------------------

def test_quantize_kv_roundtrip():
    x = _rand((2, 7, 3, 16), 0, 2.5)
    q, s = TL.quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    assert tuple(s.shape) == (2, 7, 3, 1)
    back = q.to(torch.float32) * s.to(torch.float32)
    err = (back - torch.from_numpy(x)).abs()
    # half an int8 step plus the bf16 rounding of the scale itself
    assert bool((err <= s.to(torch.float32) * 1.01 + 1e-6).all())


@pytest.mark.parametrize("scale", [2.5, 1e-3, 300.0])
def test_quantize_kv_equals_jax_bits(scale):
    x = _rand((2, 9, 3, 16), 1, scale)
    x[0, 0, 0] = 0.0                           # an all-zero row
    jq, js = JL.quantize_kv(jnp.asarray(x))
    tq, ts = TL.quantize_kv(torch.from_numpy(x))
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.to(torch.float32).numpy(),
                          np.asarray(js, np.float32))


def test_decode_attention_int8_close_to_exact():
    b, smax, kv, g, d = 2, 24, 2, 2, 16
    q = torch.from_numpy(_rand((b, 1, kv * g, d), 1))
    k = torch.from_numpy(_rand((b, smax, kv, d), 2))
    v = torch.from_numpy(_rand((b, smax, kv, d), 3))
    length = torch.tensor(20, dtype=torch.int32)
    exact = TL.decode_attention(q, k, v, length)
    kq, ks = TL.quantize_kv(k)
    vq, vs = TL.quantize_kv(v)
    quant = TL.decode_attention(q, kq, vq, length, k_scale=ks, v_scale=vs)
    rel = ((quant - exact).abs().max() / exact.abs().max()).item()
    assert rel < INT8_ATTN_GATE, rel


@pytest.mark.parametrize("cache_len", [1, 13, 24])
def test_decode_attention_int8_matches_jax(cache_len):
    jq, tq = _pair(_rand((2, 1, 4, 16), 4))
    jk, tk = _pair(_rand((2, 24, 2, 16), 5))
    jv, tv = _pair(_rand((2, 24, 2, 16), 6))
    jkq, jks = JL.quantize_kv(jk)
    jvq, jvs = JL.quantize_kv(jv)
    tkq, tks = TL.quantize_kv(tk)
    tvq, tvs = TL.quantize_kv(tv)
    j = JL.decode_attention(jq, jkq, jvq, jnp.asarray(cache_len, jnp.int32),
                            k_scale=jks, v_scale=jvs)
    t = TL.decode_attention(tq, tkq, tvq,
                            torch.tensor(cache_len, dtype=torch.int32),
                            k_scale=tks, v_scale=tvs)
    assert _err(t, j) <= F32_TOL


def test_attention_decode_int8_writes_the_planes_in_place():
    jcfg, tcfg = _configs("qwen3-4b", kv_cache_int8=True)
    p = JL.init_attention(jax.random.key(2), jcfg, jnp.float32)
    jc = JL.init_kv_cache(jcfg, 2, 10, jnp.float32)
    kq, ks = JL.quantize_kv(jnp.asarray(_rand(jc["k"].shape, 12)))
    vq, vs = JL.quantize_kv(jnp.asarray(_rand(jc["v"].shape, 13)))
    jc = dict(jc, k=kq, v=vq, k_s=ks, v_s=vs, len=jnp.asarray(6, jnp.int32))
    tc = _to_torch(jc)
    jx, tx = _pair(_rand((2, 1, jcfg.d_model), 14))
    j_out, j_new = JL.attention_decode(p, jcfg, jx, jc)
    t_out, t_new = TL.attention_decode(_to_torch(p), tcfg, tx, tc)
    assert _err(t_out, j_out) <= F32_TOL
    assert sorted(t_new) == sorted(j_new)
    for leaf in ("k", "v", "k_s", "v_s"):
        assert t_new[leaf] is tc[leaf]                 # written in place
        assert _err(t_new[leaf], j_new[leaf]) == 0.0, leaf
    assert int(t_new["len"]) == 7


def test_init_kv_cache_int8_matches_jax():
    jcfg, tcfg = _configs("yi-6b", kv_cache_int8=True)
    j = jax.device_get(JL.init_kv_cache(jcfg, 2, 5, jnp.float32))
    t = TL.init_kv_cache(tcfg, 2, 5, torch.float32, device="cpu")
    assert sorted(j) == sorted(t)
    for name in j:
        assert tuple(t[name].shape) == np.shape(j[name])
        assert str(t[name].dtype).split(".")[-1] == str(j[name].dtype)


def _int8_run(model_cfg, params, toks, cache_fn):
    model = tlm.LM(model_cfg)
    c = cache_fn(model)
    for t in range(6):
        logits, c = tserve.decode_step(model, params, c, toks[:, t:t + 1])
    return logits


@pytest.mark.parametrize("arch", ["yi-6b", "qwen3-4b"])
def test_int8_cache_decode_dense(arch):
    """Full decode loop: the int8 cache tracks the float cache within the
    JAX package's gate, and the JAX package's int8 decode within the same
    gate (an f32 ulp apart before quantization can round an int8 entry
    the other way, one quantization step, as large as int8 against
    float)."""
    jcfg, tcfg = _configs(arch)
    jp = JLM(jcfg).init(jax.random.key(0))
    tp = _to_torch(jp)
    toks = np.random.RandomState(1).randint(0, tcfg.vocab, (2, 8))

    def cache(model):
        c = tserve.init_decode_cache(model, 2, 16, device="cpu")
        c["len"].zero_()
        return c

    tt = torch.from_numpy(toks)
    l_exact = _int8_run(tcfg, tp, tt, cache)
    l_q = _int8_run(tcfg.with_(kv_cache_int8=True), tp, tt, cache)
    rel = ((l_exact - l_q).abs().max() / l_exact.abs().max()).item()
    assert rel < INT8_DECODE_GATE, rel
    jm8 = JLM(jcfg.with_(kv_cache_int8=True))
    jc = dict(jserve.init_decode_cache(jm8, 2, 16), len=jnp.asarray(0, jnp.int32))
    for t in range(6):
        j_logits, jc = jserve.decode_step(jm8, jp, jc,
                                          jnp.asarray(toks[:, t:t + 1]))
    assert _err(l_q, j_logits) < INT8_DECODE_GATE


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_int8_decode_matches_jax_on_the_same_cache(arch):
    """Each of 6 int8 decode steps from the same int8 cache (the JAX
    package's, carried across) in both packages: logits within the f32
    tolerance; the new token's int8 entries at most one quantization step
    apart (an f32 ulp before rounding can round one the other way) in at
    most one entry in a thousand, its bf16 scales within a bf16 step."""
    jcfg, tcfg = _configs(arch, kv_cache_int8=True)
    jp = JLM(jcfg).init(jax.random.key(0))
    tp = _to_torch(jp)
    jm, tm = JLM(jcfg), tlm.LM(tcfg)
    toks = np.random.RandomState(1).randint(0, tcfg.vocab, (2, 8))
    jc = dict(jserve.init_decode_cache(jm, 2, 16), len=jnp.asarray(0, jnp.int32))
    for t in range(6):
        tl, tc = tserve.decode_step(tm, tp, _to_torch(jc),
                                    torch.from_numpy(toks[:, t:t + 1]))
        jl, jc = jserve.decode_step(jm, jp, jc, jnp.asarray(toks[:, t:t + 1]))
        assert _err(tl, jl) <= F32_TOL, t
        for name in ("k", "v"):
            diff = (tc[name].to(torch.int32).numpy()
                    - np.asarray(jc[name], np.int32))
            assert np.abs(diff).max() <= 1 and (diff != 0).mean() <= 1e-3
        for name in ("k_s", "v_s"):
            assert _err(tc[name], np.asarray(jc[name], np.float32)) <= 2 ** -8
        assert int(tc["len"]) == int(jc["len"]) == t + 1


@pytest.mark.parametrize("arch", ["yi-6b", "llava-next-34b"])
def test_int8_cache_half_bytes(arch):
    cfg = tarchs.smoke_config(arch)

    def nbytes(c):
        return sum(t.numel() * t.element_size() for t in _leaves(
            tserve.init_decode_cache(tlm.LM(c), 4, 64, device="cpu")).values())

    assert nbytes(cfg.with_(kv_cache_int8=True)) < 0.6 * nbytes(
        cfg.with_(dtype="bfloat16"))


# ---------------------------------------------------------------------------
# triangle attention (attn_skip_masked)
# ---------------------------------------------------------------------------

TRI_CASES = [
    (16, 16, 16, 4),      # one chunk
    (40, 8, 16, 2),       # kv chunks wider than q chunks, GQA
    (40, 16, 8, 4),       # q chunks wider than kv chunks
    (37, 8, 8, 1),        # ragged, MQA
    (13, 16, 5, 2),       # chunks wider than s
]


@pytest.mark.parametrize("s,q_chunk,kv_chunk,kv", TRI_CASES)
def test_chunked_attention_tri_matches_jax(s, q_chunk, kv_chunk, kv):
    jq, tq = _pair(_rand((2, s, 4, 8), 6))
    jk, tk = _pair(_rand((2, s, kv, 8), 7))
    jv, tv = _pair(_rand((2, s, kv, 8), 8))
    t = TL.chunked_attention_tri(tq, tk, tv, q_chunk=q_chunk,
                                 kv_chunk=kv_chunk)
    j = JL.chunked_attention_tri(jq, jk, jv, q_chunk=q_chunk,
                                 kv_chunk=kv_chunk)
    assert t.shape == tq.shape and _err(t, j) <= F32_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,q_chunk,kv_chunk,kv", TRI_CASES)
def test_chunked_attention_tri_equals_plain_bits(s, q_chunk, kv_chunk, kv,
                                                 dtype):
    """With the same chunks the triangle skips only chunks that add exactly
    0: equal bits to the plain streaming attention."""
    q = torch.from_numpy(_rand((2, s, 4, 8), 9)).to(dtype)
    k = torch.from_numpy(_rand((2, s, kv, 8), 10)).to(dtype)
    v = torch.from_numpy(_rand((2, s, kv, 8), 11)).to(dtype)
    tri = TL.chunked_attention_tri(q, k, v, q_chunk=q_chunk, kv_chunk=kv_chunk)
    plain = TL.chunked_attention(q, k, v, causal=True, q_chunk=q_chunk,
                                 kv_chunk=kv_chunk)
    assert torch.equal(tri, plain)


def test_attention_block_routes_to_the_triangle(monkeypatch):
    jcfg, tcfg = _configs("yi-6b", attn_skip_masked=True)
    p = JL.init_attention(jax.random.key(3), jcfg, jnp.float32)
    jx, tx = _pair(_rand((2, 40, jcfg.d_model), 15))
    pos = np.arange(40, dtype=np.int32)
    j_out, _ = JL.attention_block(p, jcfg, jx, jnp.asarray(pos))
    calls = []
    real = TL.chunked_attention_tri
    monkeypatch.setattr(TL, "chunked_attention_tri",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    t_out, _ = TL.attention_block(_to_torch(p), tcfg, tx,
                                  torch.from_numpy(pos))
    TL.attention_block(_to_torch(p), tcfg, tx, torch.from_numpy(pos),
                       causal=False)
    assert calls == [1]                     # causal only
    assert _err(t_out, j_out) <= F32_TOL


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_serve_main_serves_the_attention_families_on_cpu(arch):
    args = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "6",
            "--gen", "4", "--device", "cpu"]
    g1 = tlaunch.main(args)
    assert g1.shape == (2, 4) and torch.equal(g1, tlaunch.main(args))


def test_serve_vlm_through_the_warmed_patch_embed():
    """llava-next-34b at smoke size: a seeded image of the first class
    through the warmed patch embed ahead of the prompt; max_len counts the
    prefix; greedy tokens repeat."""
    cfg = tarchs.smoke_config("llava-next-34b")
    res = tlaunch.serve(cfg, batch=2, prompt_len=6, gen=4, device="cpu",
                        warm_plans=True, shape_classes=[(2, 8, 8)])
    again = tlaunch.serve(cfg, batch=2, prompt_len=6, gen=4, device="cpu",
                          warm_plans=True, shape_classes=[(2, 8, 8)])
    assert [r.warning_count for r in res["warmup"]] == [0]
    assert res["frontend_s"] > 0 and res["decode_graph"] is False
    assert torch.equal(res["tokens"], again["tokens"])
    stub = tlaunch.serve(cfg, batch=2, prompt_len=6, gen=4, device="cpu")
    assert stub["frontend_s"] is None and stub["tokens"].shape == (2, 4)
    assert not torch.equal(stub["prefill_logits"], res["prefill_logits"])


def test_serve_vlm_prefill_reads_the_frontend_tokens():
    """The vision tokens the launcher builds are what the prefill reads:
    serve()'s prefill logits equal a prefill of the same image's tokens."""
    from repro_torch.models.layers import f32_accumulation
    cfg = tarchs.smoke_config("llava-next-34b")
    res = tlaunch.serve(cfg, batch=2, prompt_len=6, gen=1, device="cpu",
                        warm_plans=True, shape_classes=[(2, 12, 12)])
    with torch.inference_mode(), f32_accumulation():
        frontend, services = tlaunch.warm_frontend(cfg, [(2, 12, 12)], 0,
                                                   "cpu")
        inputs = tlaunch._frontend_inputs(cfg, frontend, services, 2, 0, "cpu")
        assert tuple(inputs["vision"].shape) == (2, cfg.prefix_len,
                                                 cfg.d_model)
        params = tlaunch.init_params(cfg, 0, "cpu")
        tokens = tlaunch.make_prompt(cfg, 2, 6, 0, "cpu")
        logits, _ = tserve.prefill(tlm.LM(cfg), params,
                                   {"tokens": tokens, **inputs},
                                   6 + 1 + cfg.prefix_len)
    assert torch.equal(logits, res["prefill_logits"])
