"""The port's moe family against the JAX package, on the CPU.

``models.moe`` (routing, capacity buckets, the drop set, the expert FFN,
the local executor, the drop counter) against ``repro.models.moe``, the
five tests of ``tests/test_moe.py`` ported (``test_moe_local_vs_ep_single_device``
as the local executor only: expert parallelism is ROADMAP Queue 1 item
11), and the moe family's tree, prefill, decode and int8 decode against
``repro.models.{lm,serve}`` at smoke size.  Inputs are made with numpy
from a seed; parameters and caches are drawn by the JAX package and
carried across with ``convert.params_from_jax``.

Tolerances, as scale-normalised max errors (max|port - jax| / max|jax|),
those of ``tests/test_torch_lm.py``: 1e-5 for a function in f32
(``F32_TOL``), 1e-4 for the logits and cache leaves of a prefill plus four
decode steps in f32, 2e-2 for the same in bf16 (``SLICE_TOL``; the JAX
side op by op, ``jax.disable_jit``).  Expert ids and the drop set are
equal; the JAX package's gates (``tests/test_moe.py``) hold on the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                           # noqa: E402
import jax.numpy as jnp                              # noqa: E402

from repro.configs import archs as jarchs            # noqa: E402
from repro.models import moe as jmoe                 # noqa: E402
from repro.models import serve as jserve             # noqa: E402
from repro.models.lm import LM as JLM                # noqa: E402

from repro_torch.configs import archs as tarchs      # noqa: E402
from repro_torch.convert import params_from_jax      # noqa: E402
from repro_torch.launch import serve as tlaunch      # noqa: E402
from repro_torch.models import lm as tlm             # noqa: E402
from repro_torch.models import moe as tmoe           # noqa: E402
from repro_torch.models import serve as tserve       # noqa: E402

F32_TOL = 1e-5
SLICE_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
MOE_ARCHS = ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"]
# a capacity factor low enough that assignments drop at these sizes
LOW_CF = 0.5


@pytest.fixture(autouse=True)
def one_thread():
    """Smoke-size tensors on one intra-op thread: a test runner's parallel
    workers oversubscribe the cores, and torch's thread pool over tiny ops
    then waits far more than it computes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _err(port, ref) -> float:
    p = (port.detach().to(torch.float64).numpy()
         if isinstance(port, torch.Tensor) else np.asarray(port, np.float64))
    r = np.asarray(ref, np.float64)
    assert p.shape == r.shape, (p.shape, r.shape)
    scale = np.abs(r).max()
    return float(np.abs(p - r).max() / (scale if scale > 0 else 1.0))


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _to_torch(tree):
    return params_from_jax(jax.device_get(tree), device="cpu")


def _cfgs(arch="qwen3-moe-30b-a3b", **kw):
    return (jarchs.smoke_config(arch).with_(**kw),
            tarchs.smoke_config(arch).with_(**kw))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.fixture
def cfg():
    return tarchs.smoke_config("qwen3-moe-30b-a3b")


# ---------------------------------------------------------------------------
# tests/test_moe.py, ported
# ---------------------------------------------------------------------------

def test_route_topk_properties(cfg):
    x = torch.from_numpy(_rand((64, cfg.d_model), 0))
    router = torch.from_numpy(_rand((cfg.d_model, cfg.n_experts), 1))
    gw, idx, aux = tmoe._route(x, router, cfg)
    assert gw.shape == (64, cfg.top_k) and idx.shape == (64, cfg.top_k)
    np.testing.assert_allclose(gw.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert float(aux) > 0
    for row in idx.numpy():
        assert len(set(row.tolist())) == cfg.top_k


def test_pack_unpack_roundtrip(cfg):
    """With ample capacity, pack -> identity expert -> unpack is the
    weighted sum of the token itself: y = sum_k gw_k x = x."""
    t, d = 32, cfg.d_model
    x = torch.from_numpy(_rand((t, d), 2))
    router = torch.from_numpy(_rand((d, cfg.n_experts), 3))
    gw, idx, _ = tmoe._route(x, router, cfg)
    buckets, routing = tmoe._pack(x, gw, idx, t, cfg)
    y = tmoe._unpack(buckets, routing, gw, t, d)
    np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=1e-5, atol=1e-5)


def test_capacity_drops_are_bounded(cfg):
    """Over-capacity tokens are dropped, never mis-routed: every bucket row
    is a token (all ones) or empty (all zeros)."""
    cfg = cfg.with_(capacity_factor=0.25)
    t, d = 64, cfg.d_model
    x = torch.ones((t, d))
    router = torch.from_numpy(_rand((d, cfg.n_experts), 4))
    gw, idx, _ = tmoe._route(x, router, cfg)
    cap = tmoe._capacity(t, cfg)
    buckets, routing = tmoe._pack(x, gw, idx, cap, cfg)
    assert buckets.shape == (cfg.n_experts, cap, d)
    assert set(np.unique(buckets.sum(-1).numpy())) <= {0.0, float(d)}
    assert int(tmoe._dropped(routing, cap)) > 0


def test_moe_local_single_device(cfg):
    """``test_moe_local_vs_ep_single_device``'s configuration through the
    local executor (both ``moe_impl`` values take it without a mesh)
    against the JAX package's local executor."""
    jcfg = jarchs.smoke_config("qwen3-moe-30b-a3b").with_(
        moe_impl="ep", n_experts=8, top_k=2)
    tcfg = cfg.with_(moe_impl="ep", n_experts=8, top_k=2)
    jp = jmoe.init_moe(jax.random.key(5), jcfg, jnp.float32)
    x = _rand((2, 16, cfg.d_model), 6)
    y_j, aux_j = jmoe.moe_ffn(jp, jcfg.with_(moe_impl="local"), jnp.asarray(x))
    tp = _to_torch(jp)
    for impl in ("ep", "local"):
        y_t, aux_t = tmoe.moe_ffn(tp, tcfg.with_(moe_impl=impl),
                                  torch.from_numpy(x))
        assert _err(y_t, y_j) <= F32_TOL
        assert _err(aux_t, aux_j) <= F32_TOL


def test_moe_grads_flow(cfg):
    jp = jmoe.init_moe(jax.random.key(7), jarchs.smoke_config(
        "qwen3-moe-30b-a3b"), jnp.float32)
    p = _to_torch(jp)
    leaves = list(_leaves(p).values())
    for t in leaves:
        t.requires_grad_(True)
    x = torch.from_numpy(_rand((2, 8, cfg.d_model), 8))
    y, aux = tmoe.moe_ffn(p, cfg, x)
    (torch.sum(y ** 2) + aux).backward()
    gnorm = sum(float(t.grad.abs().sum()) for t in leaves)
    assert np.isfinite(gnorm) and gnorm > 0
    # the router receives gradient through the gate weights
    assert float(p["router"].grad.abs().sum()) > 0


# ---------------------------------------------------------------------------
# parity: routing, buckets, the drop set, the executor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [16, 64])
def test_route_matches_jax(cfg, t):
    x = _rand((t, cfg.d_model), 10 + t)
    router = _rand((cfg.d_model, cfg.n_experts), 11)
    jg, ji, ja = jmoe._route(jnp.asarray(x), jnp.asarray(router), cfg)
    tg, ti, ta = tmoe._route(torch.from_numpy(x), torch.from_numpy(router),
                             cfg)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert _err(tg, jg) <= F32_TOL and _err(ta, ja) <= F32_TOL


@pytest.mark.parametrize("cf", [LOW_CF, 0.25, 8.0])
def test_pack_unpack_and_drop_set_match_jax(cfg, cf):
    """The buckets, the combine and the drop set against the JAX
    package's, at capacity factors where assignments drop (and 8.0, where
    none does)."""
    cfg = cfg.with_(capacity_factor=cf)
    t, d = 48, cfg.d_model
    x = _rand((t, d), 12)
    router = _rand((d, cfg.n_experts), 13)
    jg, ji, _ = jmoe._route(jnp.asarray(x), jnp.asarray(router), cfg)
    cap = jmoe._capacity(t, cfg)
    assert tmoe._capacity(t, cfg) == cap
    jb, (je, jpos, jtok) = jmoe._pack(jnp.asarray(x), jg, ji, cap, cfg)
    tg, ti = torch.from_numpy(np.array(jg)), torch.from_numpy(np.array(ji))
    tb, routing = tmoe._pack(torch.from_numpy(x), tg, ti, cap, cfg)
    assert torch.equal(tb, torch.from_numpy(np.array(jb)))
    te, tpos, ttok = routing
    assert np.array_equal(te.numpy(), np.asarray(je))
    assert np.array_equal(ttok.numpy(), np.asarray(jtok))
    j_drop = np.asarray(jpos) >= cap
    assert np.array_equal((tpos >= cap).numpy(), j_drop)
    assert np.array_equal(tpos.numpy()[~j_drop], np.asarray(jpos)[~j_drop])
    assert int(tmoe._dropped(routing, cap)) == int(j_drop.sum())
    if cf < 1:
        assert j_drop.any()
    else:
        assert not j_drop.any()
    out = _rand(tuple(jb.shape), 14)
    jy = jmoe._unpack(jnp.asarray(out), (je, jpos, jtok), jg, t, d)
    ty = tmoe._unpack(torch.from_numpy(out), routing, tg, t, d)
    assert _err(ty, jy) <= F32_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [LOW_CF, 1.25])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_jax(arch, cf, dtype):
    """The local executor (shared experts included for kimi-k2) against
    the JAX package's; in bf16 the port's CPU expert products round g, u
    and the output to bf16 once (``models.moe``), within the bf16 bar."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=cf, dtype=dtype)
    jdt = jnp.dtype(dtype)
    jp = jmoe.init_moe(jax.random.key(20), jcfg, jdt)
    x = _rand((2, 24, jcfg.d_model), 21)
    with jax.disable_jit(dtype != "float32"):
        jy, ja = jmoe.moe_ffn(jp, jcfg, jnp.asarray(x, jdt))
    tp = _to_torch(jp)
    assert tp["router"].dtype == torch.float32
    with tmoe.count_drops("cpu") as dropped:
        ty, ta = tmoe.moe_ffn(tp, tcfg, torch.from_numpy(x).to(
            tlm.torch_dtype(tcfg)))
    tol = F32_TOL if dtype == "float32" else SLICE_TOL[dtype]
    assert ty.dtype == tlm.torch_dtype(tcfg)
    assert _err(ty, jy) <= tol and _err(ta, ja) <= F32_TOL
    # the drop count equals the JAX package's drop set's size
    xf = jnp.asarray(x, jdt).reshape(-1, jcfg.d_model)
    jg, ji, _ = jmoe._route(xf, jp["router"], jcfg)
    cap = jmoe._capacity(xf.shape[0], jcfg)
    _, (_, jpos, _) = jmoe._pack(xf, jg, ji, cap, jcfg)
    assert int(dropped) == int((np.asarray(jpos) >= cap).sum())


def test_moe_grads_match_jax(cfg):
    """Gradients of sum(y^2) + aux through the executor, drops included,
    against ``jax.grad``."""
    jcfg = jarchs.smoke_config("qwen3-moe-30b-a3b").with_(
        capacity_factor=LOW_CF)
    tcfg = cfg.with_(capacity_factor=LOW_CF)
    jp = jmoe.init_moe(jax.random.key(9), jcfg, jnp.float32)
    x = _rand((2, 8, cfg.d_model), 22)

    def jloss(p, x):
        y, aux = jmoe.moe_ffn(p, jcfg, x)
        return jnp.sum(y ** 2) + aux
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = _to_torch(jp)
    for t in _leaves(tp).values():
        t.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.moe_ffn(tp, tcfg, tx)
    (torch.sum(y ** 2) + aux).backward()
    assert _err(tx.grad, jgx) <= 1e-4
    jl = _leaves(jax.device_get(jgp))
    for name, t in _leaves(tp).items():
        assert _err(t.grad, jl[name]) <= 1e-4, name


def test_expert_product_grads_keep_the_f32_cotangent():
    """The card's expert-product backward (``_product_f32_grads``, bf16
    operands, f32 cotangent) equals the CPU's widened product's autograd
    to the bit, and the transpose of the JAX package's
    ``preferred_element_type=float32`` einsum within F32_TOL (1e-5) of
    the gradients' f32 scale; the cotangent rounded to bf16 first, as
    before, misses both."""
    a = torch.from_numpy(_rand((4, 16, 64), 30)).to(torch.bfloat16)
    b = torch.from_numpy(_rand((4, 64, 32), 31)).to(torch.bfloat16)
    g = torch.from_numpy(_rand((4, 16, 32), 32))
    got = tmoe._product_f32_grads(a, b, g)
    aw, bw = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    torch.bmm(aw.to(torch.float32), bw.to(torch.float32)).backward(g)
    assert torch.equal(got[0], aw.grad) and torch.equal(got[1], bw.grad)
    ja, jb = (jnp.asarray(t.to(torch.float32).numpy(), jnp.bfloat16)
              for t in (a, b))
    _, vjp = jax.vjp(lambda x, y: jnp.einsum(
        "ecd,edf->ecf", x, y, preferred_element_type=jnp.float32), ja, jb)
    want = [np.asarray(t.astype(jnp.float32)) for t in vjp(jnp.asarray(g.numpy()))]
    rounded = tmoe._product_f32_grads(a, b, g.to(torch.bfloat16).to(torch.float32))
    for port, old, ref in zip(got, rounded, want):
        assert _err(port.float(), ref) <= F32_TOL < _err(old.float(), ref)


def test_drop_counter_adds_on_the_device_and_nests(cfg):
    tcfg = cfg.with_(capacity_factor=0.25)
    p = _to_torch(jmoe.init_moe(jax.random.key(3), jarchs.smoke_config(
        "qwen3-moe-30b-a3b"), jnp.float32))
    x = torch.from_numpy(_rand((2, 16, cfg.d_model), 23))
    with tmoe.count_drops("cpu") as outer:
        tmoe.moe_ffn(p, tcfg, x)
        first = int(outer)
        with tmoe.count_drops("cpu") as inner:
            tmoe.moe_ffn(p, tcfg, x)
        assert int(inner) == first > 0
        assert int(outer) == first
    assert not tmoe._COUNTERS
    tmoe.moe_ffn(p, tcfg, x)       # no counter: nothing counted, no error


def test_distributed_executors_raise(cfg):
    """The expert-parallel executor and its all-to-all need ranks: under
    rules whose "model" axis is an AbstractMesh's, ``moe_ffn`` raises, and
    ``int8_all_to_all`` outside a process group raises (they run over
    gloo ranks in ``tests/test_torch_expert_parallel.py``)."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.parallel.axes import default_rules, use_rules
    ep = cfg.with_(moe_impl="ep")
    p = tmoe.init_moe(torch.Generator().manual_seed(0), ep, torch.float32,
                      device="cpu")
    x = torch.zeros((1, 4, cfg.d_model))
    with use_rules(default_rules(AbstractMesh((1, 2), ("data", "model")))):
        with pytest.raises(ValueError, match="needs a DeviceMesh"):
            tmoe.moe_ffn(p, ep, x)
    with pytest.raises((ValueError, RuntimeError)):
        tmoe.int8_all_to_all(x, None, 0, 1)


def test_chunked_normal_draws_in_chunks(monkeypatch):
    """Expert leaves drawn chunk by chunk: the scale and dtype of
    ``init_normal``, no chunk above DRAW_ELEMENTS f32 elements."""
    from repro_torch.models import layers
    sizes = []
    real = layers.init_normal

    def spy(generator, shape, scale, dtype, device):
        sizes.append(int(np.prod(shape)))
        return real(generator, shape, scale, dtype, device)
    monkeypatch.setattr(tmoe, "init_normal", spy)
    monkeypatch.setattr(tmoe, "DRAW_ELEMENTS", 3 * 64 * 96)
    w = tmoe.chunked_normal(torch.Generator().manual_seed(0),
                            (2, 8, 64, 96), 0.5, torch.bfloat16, "cpu")
    assert w.dtype == torch.bfloat16 and w.shape == (2, 8, 64, 96)
    assert max(sizes) <= 3 * 64 * 96 and sum(sizes) == w.numel()
    assert len(sizes) == 6
    assert abs(float(w.float().std()) - 0.5) < 0.02


# ---------------------------------------------------------------------------
# the moe family: tree, prefill, decode, int8 decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_has_the_jax_tree(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype=dtype)
    shapes = _leaves(jax.eval_shape(JLM(jcfg).init, jax.random.key(0)))
    got = _leaves(tlm.LM(tcfg).init(torch.Generator().manual_seed(0),
                                    device="cpu"))
    assert sorted(got) == sorted(shapes)
    for name, t in got.items():
        assert tuple(t.shape) == tuple(shapes[name].shape), name
        assert str(t.dtype).split(".")[-1] == str(shapes[name].dtype), name
    conv = _leaves(_to_torch(JLM(jcfg).init(jax.random.key(0))))
    assert sorted(conv) == sorted(got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_jax(arch, dtype):
    """A prefill of 16 tokens and four decode steps: logits of every step
    and every cache leaf."""
    jcfg, tcfg = _cfgs(arch, dtype=dtype)
    jm, tm = JLM(jcfg), tlm.LM(tcfg)
    jp = jm.init(jax.random.key(0))
    tp = _to_torch(jp)
    toks = np.random.RandomState(1).randint(0, jcfg.vocab, (2, 20))
    tol = SLICE_TOL[dtype]
    with jax.disable_jit(dtype != "float32"):
        jl, jc = jserve.prefill(jm, jp, {"tokens": jnp.asarray(
            toks[:, :16], jnp.int32)}, 24)
        tl, tc = tserve.prefill(tm, tp, {"tokens": torch.from_numpy(
            toks[:, :16])}, 24)
        assert _err(tl, jl) <= tol
        for step in range(4):
            tok = toks[:, 16 + step:17 + step]
            jl, jc = jserve.decode_step(jm, jp, jc, jnp.asarray(tok, jnp.int32))
            tl, tc = tserve.decode_step(tm, tp, tc, torch.from_numpy(tok))
            assert _err(tl, jl) <= tol, step
    jleaves = _leaves(jax.device_get(jc))
    for name, t in _leaves(tc).items():
        if name == "/len":
            assert int(t) == int(jleaves[name]) == 20
        else:
            assert _err(t.float(), np.asarray(jleaves[name], np.float32)) <= tol


def test_int8_cache_decode_moe_finite():
    """``tests/test_kv_quant.py::test_int8_cache_decode_moe_finite``, on
    both packages: a zero int8 cache at length 0, one decode step; the
    port's logits finite and within the f32 slice bar of the JAX
    package's."""
    jcfg, tcfg = _cfgs(kv_cache_int8=True)
    jm, tm = JLM(jcfg), tlm.LM(tcfg)
    jp = jm.init(jax.random.key(0))
    jc = dict(jserve.init_decode_cache(jm, 2, 8), len=jnp.asarray(0, jnp.int32))
    jl, _ = jserve.decode_step(jm, jp, jc, jnp.ones((2, 1), jnp.int32))
    tc = tserve.init_decode_cache(tm, 2, 8, device="cpu")
    assert tc["k"].dtype == torch.int8 and tc["k_s"].dtype == torch.bfloat16
    tc["len"].zero_()
    tl, tc = tserve.decode_step(tm, _to_torch(jp), tc,
                                torch.ones((2, 1), dtype=torch.long))
    assert bool(torch.isfinite(tl).all())
    assert _err(tl, jl) <= SLICE_TOL["float32"]
    assert int(tc["len"]) == 1


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_reports_drops(arch):
    """``serve()`` on the moe family: the prefill's and every decode step's
    drop counts, each what a count_drops around the same call reads."""
    cfg = tarchs.smoke_config(arch).with_(capacity_factor=LOW_CF)
    res = tlaunch.serve(cfg, batch=2, prompt_len=12, gen=5, device="cpu")
    assert res["tokens"].shape == (2, 5)
    drops = res["drops"]
    assert len(drops["decode"]) == 4 and drops["prefill"] > 0
    params = tlaunch.init_params(cfg, 0, "cpu")
    prompt = tlaunch.make_prompt(cfg, 2, 12, 0, "cpu")
    with torch.inference_mode(), tmoe.count_drops("cpu") as dropped:
        tserve.prefill(tlm.LM(cfg), params, {"tokens": prompt}, 17)
    assert int(dropped) == drops["prefill"]


def test_serve_counts_no_drops_for_other_families():
    res = tlaunch.serve(tarchs.smoke_config("yi-6b"), batch=2, prompt_len=8,
                        gen=3, device="cpu")
    assert res["drops"] == {"prefill": 0, "decode": [0, 0]}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_launch_serve_main_serves_the_moe_family(arch, capsys):
    gen = tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    assert gen.shape == (2, 4)
    assert "tok/s" in capsys.readouterr().out
