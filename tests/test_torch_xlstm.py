"""The port's ssm family (xLSTM) against the JAX package, on the CPU.

``models.xlstm``'s mLSTM (the chunked parallel form, the closed-form
prefill cache, the O(1) decode) and sLSTM (the scan and its decode), the
ssm branches of ``models.lm`` and ``models.serve``, and the serving
launcher.  Inputs are made with numpy from a seed and fed to both
packages; parameters and caches are drawn by the JAX package and carried
across with ``convert.params_from_jax``.

Tolerances, as scale-normalised max errors (max|port - jax| / max|jax|),
those of ``tests/test_torch_serve.py``: 1e-5 for a function in f32, 1e-4
for the logits of every step and every cache leaf of a prefill plus four
decode steps in f32, 2e-2 for the same in bf16 (the JAX side op by op,
``jax.disable_jit``: compiled XLA on the CPU keeps excess precision
across bf16 casts).  The JAX package's own tests
(``tests/test_system.py`` ``test_serve_launcher_end_to_end`` and
``test_mec_conv_used_in_ssm_blocks``, ``tests/test_archs.py``
``test_long_context_archs_have_o1_decode_state``) are ported for the
ssm family.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                           # noqa: E402
import jax.numpy as jnp                              # noqa: E402

from repro.configs import archs as jarchs            # noqa: E402
from repro.models import serve as jserve             # noqa: E402
from repro.models import xlstm as JX                 # noqa: E402
from repro.models.lm import LM as JLM                # noqa: E402

from repro_torch.configs import archs as tarchs      # noqa: E402
from repro_torch.convert import params_from_jax      # noqa: E402
from repro_torch.launch import serve as tlaunch      # noqa: E402
from repro_torch.models import lm as tlm             # noqa: E402
from repro_torch.models import serve as tserve       # noqa: E402
from repro_torch.models import xlstm as TX           # noqa: E402
from repro_torch.serving.step_graph import DecodeProgram  # noqa: E402

F32_TOL = 1e-5
SLICE_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
ARCH = "xlstm-125m"


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


def _tree_errs(port, ref, prefix=""):
    t, j = _leaves(port, prefix), _leaves(jax.device_get(ref), prefix)
    assert sorted(t) == sorted(j)
    return {name: _err(t[name], j[name]) for name in j}


def _configs(dtype="float32", **kw):
    return (jarchs.smoke_config(ARCH).with_(dtype=dtype, **kw),
            tarchs.smoke_config(ARCH).with_(dtype=dtype, **kw))


def _block(kind, cfg_kw=None, seed=0):
    """One block's parameters (drawn by the JAX package, carried across)
    and a (2, 21, d) input: 21 steps, not a multiple of the smoke
    config's q_chunk of 16."""
    jcfg, tcfg = _configs(**(cfg_kw or {}))
    init = JX.init_mlstm if kind == "mlstm" else JX.init_slstm
    jp = init(jax.random.key(seed), jcfg, jnp.float32)
    jx, tx = _pair(_rand((2, 21, jcfg.d_model), seed + 1))
    return jcfg, tcfg, jp, _to_torch(jp), jx, tx


# ---------------------------------------------------------------------------
# models.xlstm, function by function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,q_chunk", [(37, 16), (32, 16), (5, 16), (9, 4)])
def test_mlstm_parallel_matches_jax(s, q_chunk):
    """The chunked stabilised parallel form, with the last query chunk
    padded (37 and 9 steps) and not (32; 5 under one chunk)."""
    b, h, p = 2, 3, 8
    args = [_pair(_rand((b, s, h, p), i)) for i in range(3)]
    log_i = _pair(_rand((b, s, h), 3))
    log_f = _pair(np.log(1 / (1 + np.exp(-_rand((b, s, h), 4) - 3.0)))
                  .astype(np.float32))
    want = JX.mlstm_parallel(*(a[0] for a in args), log_i[0], log_f[0],
                             q_chunk=q_chunk)
    got = TX.mlstm_parallel(*(a[1] for a in args), log_i[1], log_f[1],
                            q_chunk=q_chunk)
    assert got.dtype == torch.float32
    assert _err(got, want) <= F32_TOL


@pytest.mark.parametrize("conv_impl", ["lowered", "fused"])
def test_mlstm_prefill_matches_jax(conv_impl):
    """The block's output and its closed-form final state (c, n, m) and
    conv history."""
    jcfg, tcfg, jp, tp, jx, tx = _block("mlstm", {"conv_impl": conv_impl})
    j_out, j_cache = JX.mlstm_prefill(jp, jcfg, jx)
    t_out, t_cache = TX.mlstm_prefill(tp, tcfg, tx)
    errs = {"out": _err(t_out, j_out), **_tree_errs(t_cache, j_cache)}
    assert max(errs.values()) <= F32_TOL, errs
    assert t_cache["conv"].is_contiguous()
    assert torch.equal(TX.mlstm_forward(tp, tcfg, tx), t_out)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_matches_jax(kind):
    """Three decode steps from the prefill's cache: each step's output
    and every cache leaf after, written into the given buffers."""
    jcfg, tcfg, jp, tp, jx, tx = _block(kind)
    if kind == "mlstm":
        (_, jc), (_, tc) = (JX.mlstm_prefill(jp, jcfg, jx[:, :18]),
                            TX.mlstm_prefill(tp, tcfg, tx[:, :18]))
        jdec, tdec = JX.mlstm_decode, TX.mlstm_decode
    else:
        (_, jc), (_, tc) = (JX.slstm_core(jp, jcfg, jx[:, :18]),
                            TX.slstm_core(tp, tcfg, tx[:, :18]))
        jdec, tdec = JX.slstm_decode, TX.slstm_decode
    buffers = dict(tc)
    errs = {}
    for t in range(18, 21):
        j_out, jc = jdec(jp, jcfg, jx[:, t:t + 1], jc)
        t_out, tc = tdec(tp, tcfg, tx[:, t:t + 1], tc)
        errs[f"out{t}"] = _err(t_out, j_out)
    errs.update(_tree_errs(tc, jc))
    assert max(errs.values()) <= F32_TOL, errs
    assert all(tc[name] is buffers[name] for name in buffers)


@pytest.mark.parametrize("conv_impl", ["lowered", "fused"])
def test_slstm_core_matches_jax(conv_impl):
    """The S-step scan (a Python loop here): output and final state."""
    jcfg, tcfg, jp, tp, jx, tx = _block("slstm", {"conv_impl": conv_impl})
    j_out, j_cache = JX.slstm_core(jp, jcfg, jx)
    t_out, t_cache = TX.slstm_core(tp, tcfg, tx)
    errs = {"out": _err(t_out, j_out), **_tree_errs(t_cache, j_cache)}
    assert max(errs.values()) <= F32_TOL, errs
    assert torch.equal(TX.slstm_forward(tp, tcfg, tx), t_out)


def test_cache_builders_match_jax():
    jcfg, tcfg = _configs()
    for jfn, tfn in ((JX.init_mlstm_cache, TX.init_mlstm_cache),
                     (JX.init_slstm_cache, TX.init_slstm_cache)):
        j = _leaves(jax.device_get(jfn(jcfg, 3)))
        t = _leaves(tfn(tcfg, 3, device="cpu"))
        assert sorted(j) == sorted(t)
        for name in j:
            assert tuple(t[name].shape) == j[name].shape, name
            assert t[name].dtype == torch.float32 and _err(t[name], j[name]) == 0


# ---------------------------------------------------------------------------
# the ssm family served: prefill and decode against the JAX package
# ---------------------------------------------------------------------------

def _serve_both(jcfg, tcfg, n_prefill=21, steps=4):
    """Prefill and ``steps`` decode steps fed the same tokens in both
    packages (the bf16 reference op by op); every step's logits and every
    cache leaf."""
    jm, tm = JLM(jcfg), tlm.LM(tcfg)
    jp = jax.jit(jm.init)(jax.random.key(0))
    tp = _to_torch(jp)
    toks = np.random.RandomState(1).randint(0, jcfg.vocab,
                                            (2, n_prefill + steps))
    errs = {}
    with jax.disable_jit(jcfg.dtype != "float32"):
        j_logits, j_cache = jserve.prefill(
            jm, jp, {"tokens": jnp.asarray(toks[:, :n_prefill], jnp.int32)},
            n_prefill + steps)
        t_logits, t_cache = tserve.prefill(
            tm, tp, {"tokens": torch.from_numpy(toks[:, :n_prefill])},
            n_prefill + steps)
        errs["prefill"] = _err(t_logits, j_logits)
        for step in range(steps):
            tok = toks[:, n_prefill + step:n_prefill + step + 1]
            j_logits, j_cache = jserve.decode_step(
                jm, jp, j_cache, jnp.asarray(tok, jnp.int32))
            t_logits, t_cache = tserve.decode_step(tm, tp, t_cache,
                                                   torch.from_numpy(tok))
            assert t_logits.dtype == torch.float32
            errs[f"decode{step}"] = _err(t_logits, j_logits)
    errs.update(_tree_errs(t_cache, j_cache))
    assert int(t_cache["len"]) == n_prefill + steps
    return errs


@pytest.mark.parametrize("conv_impl", ["lowered", "fused"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_serving_matches_jax(dtype, conv_impl):
    """smoke_config("xlstm-125m") (4 layers: two super-blocks of one mLSTM
    and one sLSTM): a 21-token prefill (two query chunks, the last padded)
    and 4 decode steps."""
    errs = _serve_both(*_configs(dtype, conv_impl=conv_impl))
    assert max(errs.values()) <= SLICE_TOL[dtype], errs


def test_ssm_serving_at_full_width_matches_jax():
    """xlstm-125m at its published widths (d_model 768, d_in 1536, 4 heads
    of 384, vocab 50304) and 4 layers, one super-block of three mLSTM
    blocks and one sLSTM block, in f32."""
    cfg = jarchs.ARCHS[ARCH].with_(n_layers=4, dtype="float32")
    errs = _serve_both(cfg, tarchs.ARCHS[ARCH].with_(n_layers=4,
                                                    dtype="float32"),
                       n_prefill=12)
    assert max(errs.values()) <= SLICE_TOL["float32"], errs


def test_init_is_stacked_by_super_block():
    _, tcfg = _configs()
    params = tlm.LM(tcfg).init(torch.Generator().manual_seed(0), device="cpu")
    n_super, k_m = tcfg.n_layers // tcfg.slstm_every, tcfg.slstm_every - 1
    assert params["mlstm"]["wq"]["w"].shape[:2] == (n_super, k_m)
    assert params["slstm"]["r_gates"].shape[0] == n_super
    assert "mamba" not in params and "blocks" not in params


def test_ssm_decode_matches_prefill():
    """tests/test_archs.py test_decode_matches_prefill for the ssm family:
    a prefill of s - 1 tokens and one decode step against a prefill of all
    s, within 2e-2 (f32 reads ~1e-6)."""
    _, cfg = _configs()
    model = tlm.LM(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.RandomState(2).randint(0, cfg.vocab,
                                                             (2, 23)))
    _, cache = tserve.prefill(model, params, {"tokens": toks[:, :22]}, 23)
    dec, _ = tserve.decode_step(model, params, cache, toks[:, 22:])
    full, _ = tserve.prefill(model, params, {"tokens": toks}, 23)
    assert _err(dec, full.numpy()) < 2e-2


# ---------------------------------------------------------------------------
# in place, the decode program, and the conv path
# ---------------------------------------------------------------------------

def _smoke_model(**kw):
    cfg = tarchs.smoke_config(ARCH).with_(**kw)
    model = tlm.LM(cfg)
    return model, model.init(torch.Generator().manual_seed(0), device="cpu")


def test_decode_writes_the_cache_in_place():
    """decode_step writes every state leaf and the conv history into the
    cache's own buffers and returns len + 1 in a new tensor."""
    model, params = _smoke_model()
    toks = torch.from_numpy(np.random.RandomState(3).randint(0, 256, (2, 9)))
    _, cache = tserve.prefill(model, params, {"tokens": toks[:, :8]}, 9)
    before = tlm.tree_map(torch.clone, cache)
    buffers = _leaves(cache)
    _, new = tserve.decode_step(model, params, cache, toks[:, 8:])
    after = _leaves(new)
    for name, buf in buffers.items():
        if name == "/len":
            assert after[name] is not buf and int(after[name]) == 9
            continue
        assert after[name] is buf, name
        assert not torch.equal(buf, _leaves(before)[name]), name
    # the history shifted by one step: the old last two rows come first
    for kind in ("mlstm", "slstm"):
        old = _leaves(before)[f"/{kind}/conv"]
        assert torch.equal(new[kind]["conv"][..., :2, :], old[..., 1:, :])


def test_decode_program_on_cpu_is_the_eager_step():
    """On the CPU the program runs ``decode_step`` eagerly over the fixed
    cache: equal bits to the step itself over 4 steps, every cache leaf
    equal after, the counter advanced in the cache's own tensor."""
    model, params = _smoke_model()
    toks = torch.from_numpy(np.random.RandomState(4).randint(0, 256, (2, 12)))
    _, cache = tserve.prefill(model, params, {"tokens": toks[:, :8]}, 12)
    p_cache = tlm.tree_map(torch.clone, cache)
    counter = p_cache["len"]
    prog = DecodeProgram(
        lambda c, t: tserve.decode_step(model, params, c, t), p_cache,
        torch.zeros_like(toks[:, :1]))
    assert prog.graph is None
    for i in range(8, 12):
        prog.tokens.copy_(toks[:, i:i + 1])
        got = prog()
        want, cache = tserve.decode_step(model, params, cache, toks[:, i:i + 1])
        assert torch.equal(got, want), i
    t, e = _leaves(p_cache), _leaves(cache)
    assert all(torch.equal(t[n], e[n]) for n in e)
    assert p_cache["len"] is counter and int(counter) == 12


def _conv_calls(monkeypatch):
    """Record the shape and strides of every conv1d input of the xLSTM
    blocks (``models.mamba2.conv1d``, K5 with conv_impl="fused")."""
    calls = []
    real = TX.conv1d

    def recorded(cfg, x, w):
        calls.append((tuple(x.shape), x.stride()))
        return real(cfg, x, w)

    monkeypatch.setattr(TX, "conv1d", recorded)
    return calls


def test_k5_runs_once_a_block_in_prefill_and_never_in_decode(monkeypatch):
    """conv_impl="fused": one conv1d a block in prefill (on the CPU K5's
    plain version), none in decode; the mLSTM block passes x_in as the
    strided view of its up projection (time stride 2 d_in, no copy)."""
    model, params = _smoke_model(conv_impl="fused")
    cfg = model.cfg
    calls = _conv_calls(monkeypatch)
    toks = torch.from_numpy(np.random.RandomState(5).randint(0, 256, (2, 10)))
    _, cache = tserve.prefill(model, params, {"tokens": toks[:, :9]}, 10)
    assert len(calls) == cfg.n_layers
    d_in = 2 * cfg.d_model
    strides = [s for _, s in calls]
    # super-block order: mLSTM (x_in a view of the (B, S, 2 d_in) up
    # projection), then sLSTM (its up projection is x_in itself)
    assert strides[0] == (9 * 2 * d_in, 2 * d_in, 1)
    assert strides[1] == (9 * d_in, d_in, 1)
    tserve.decode_step(model, params, cache, toks[:, 9:])
    assert len(calls) == cfg.n_layers


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_mec_conv_used_in_ssm_blocks(kind):
    """tests/test_system.py test_mec_conv_used_in_ssm_blocks for the xLSTM
    blocks: the block output changes when the conv kernel weights do."""
    _, cfg = _configs()
    gen = torch.Generator().manual_seed(0)
    init = TX.init_mlstm if kind == "mlstm" else TX.init_slstm
    fwd = TX.mlstm_forward if kind == "mlstm" else TX.slstm_forward
    p = init(gen, cfg, torch.float32, device="cpu")
    x = torch.randn((2, 16, cfg.d_model), generator=gen)
    y1 = fwd(p, cfg, x)
    y2 = fwd(dict(p, conv_w=p["conv_w"] + 1.0), cfg, x)
    assert float((y1 - y2).abs().max()) > 1e-4


def test_long_context_archs_have_o1_decode_state():
    """tests/test_archs.py test_long_context_archs_have_o1_decode_state for
    xlstm-125m: no leaf of the decode state grows with max_len."""
    model = tlm.LM(tarchs.smoke_config(ARCH))

    def nonattn_elements(tree):
        return sum(t.numel() for name, t in _leaves(tree).items()
                   if "attn" not in name and "len" not in name)

    c1 = tserve.init_decode_cache(model, batch=2, max_len=64, device="cpu")
    c2 = tserve.init_decode_cache(model, batch=2, max_len=128, device="cpu")
    assert nonattn_elements(c1) == nonattn_elements(c2) > 0


def test_init_decode_cache_leaves_are_buffers_of_their_own():
    """Zero leaves cloned, not expand views: writing one layer's slot
    leaves the others zero."""
    model = tlm.LM(tarchs.smoke_config(ARCH))
    cache = tserve.init_decode_cache(model, batch=2, max_len=8, device="cpu")
    for name, t in _leaves(cache).items():
        if name != "/len":
            assert t.is_contiguous() and 0 not in t.stride(), name
    cache["mlstm"]["c"][0, 0].fill_(1.0)
    assert float(cache["mlstm"]["c"][1:].abs().sum()) == 0


def test_serve_launcher_end_to_end():
    """tests/test_system.py test_serve_launcher_end_to_end through the
    port's launcher on the CPU."""
    gen = tlaunch.main(["--arch", ARCH, "--smoke", "--batch", "2",
                        "--prompt-len", "8", "--gen", "6", "--device", "cpu"])
    assert gen.shape == (2, 6)
    assert int(gen.min()) >= 0 and int(gen.max()) < 256


def test_serve_with_the_fused_conv_on_cpu():
    """serve() with conv_impl="fused" (K5's plain version on the CPU)
    gives the lowered path's greedy tokens."""
    cfg = tarchs.smoke_config(ARCH)
    runs = [tlaunch.serve(cfg.with_(conv_impl=impl), batch=2, prompt_len=8,
                          gen=4, device="cpu", seed=3)
            for impl in ("lowered", "fused")]
    assert torch.equal(runs[0]["tokens"], runs[1]["tokens"])
    assert _err(runs[1]["prefill_logits"], runs[0]["prefill_logits"]
                .numpy()) <= F32_TOL
