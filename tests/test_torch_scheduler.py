"""The port's continuous batcher (``repro_torch.serving.scheduler``) and
decode program (``repro_torch.serving.step_graph``) against the JAX
package's scheduler, on the CPU.

The two tests of ``tests/test_serving_scheduler.py`` and the mixed-shape
image stream of ``tests/test_conv_service.py`` (the scheduler's test),
ported: a batcher's token streams equal the same requests served alone
through ``models.serve`` prefill and decode, EOS (at prefill or decode)
stops a stream and frees its slot.  Then the port against the JAX
package on the same parameters (carried with ``convert.params_from_jax``)
and numpy inputs: ``batched_decode_step``'s logits and pool within 1e-4
(``tests/test_torch_serve.py``'s slice tolerance), ``insert_prefill`` and
``init_pool`` exactly, the batchers' tokens equal.  The int8 pool is held
to the JAX package's int8 decode gate (0.05, ``tests/test_kv_quant.py``)
against the float path on the same tokens.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

import repro.plan as jplan                                   # noqa: E402
from repro.configs import archs as jarchs                    # noqa: E402
from repro.models import serve as jserve                     # noqa: E402
from repro.models.lm import LM as JLM                        # noqa: E402
from repro.serving import conv_service as JC                 # noqa: E402
from repro.serving import scheduler as JS                    # noqa: E402

import repro_torch.plan as plan_mod                          # noqa: E402
from repro_torch.configs import archs as tarchs              # noqa: E402
from repro_torch.convert import params_from_jax              # noqa: E402
from repro_torch.examples import continuous_batching as example  # noqa: E402
from repro_torch.models import layers as TL                  # noqa: E402
from repro_torch.models import lm as tlm                     # noqa: E402
from repro_torch.models import serve as tserve               # noqa: E402
from repro_torch.serving import conv_service as TC           # noqa: E402
from repro_torch.serving import scheduler as TS              # noqa: E402
from repro_torch.serving.step_graph import DecodeProgram     # noqa: E402

SLICE_TOL = 1e-4
INT8_DECODE_GATE = 0.05
ARCH = "yi-6b"


@pytest.fixture(autouse=True)
def plan_env(tmp_path, monkeypatch):
    """Both packages' plan caches and calibrations under tmp_path."""
    for prefix in ("REPRO", "REPRO_TORCH"):
        monkeypatch.setenv(f"{prefix}_PLAN_CACHE_DIR", str(tmp_path / prefix))
        monkeypatch.setenv(f"{prefix}_CALIBRATION",
                           str(tmp_path / f"{prefix}-calibration-off.json"))
    for mod in (plan_mod, jplan):
        mod.reset_global_plan_cache()
        mod.reset_calibration_cache()
    yield
    for mod in (plan_mod, jplan):
        mod.reset_global_plan_cache()
        mod.reset_calibration_cache()


def _err(port, ref) -> float:
    """max|port - ref| / max|ref|."""
    p = port.to(torch.float64).numpy()
    r = np.asarray(ref, np.float64)
    assert p.shape == r.shape, (p.shape, r.shape)
    return float(np.abs(p - r).max() / np.abs(r).max())


def _models(arch=ARCH, **kw):
    """Both packages' model on the JAX package's parameters."""
    jcfg = jarchs.smoke_config(arch).with_(**kw)
    tcfg = tarchs.smoke_config(arch).with_(**kw)
    jm, tm = JLM(jcfg), tlm.LM(tcfg)
    jp = jm.init(jax.random.key(0))
    return jm, jp, tm, params_from_jax(jax.device_get(jp), device="cpu")


def _prompts(vocab, n, base=5, step=3, seed=0):
    return [np.random.RandomState(seed + i).randint(0, vocab, base + step * i)
            for i in range(n)]


def _quantized(cache):
    """A prefill's float k/v cache as the int8 pool holds it."""
    planes = TL.kv_planes(cache["k"].shape, None, True, "cpu")
    for name, val in TL.kv_entries(planes, cache["k"], cache["v"]):
        planes[name].copy_(val)
    return dict(planes, len=cache["len"])


def _solo(model, params, prompt, n, max_len=64, extras=None, feed=None,
          quantize=False):
    """One request alone through prefill and decode: its greedy tokens
    and each token's logits; ``feed`` forces the tokens fed back (a
    batcher's own stream) in place of the greedy ones; ``quantize``
    decodes from the prefill's cache made int8."""
    batch = {"tokens": torch.as_tensor(prompt)[None], **(extras or {})}
    logits, cache = tserve.prefill(model, params, batch, max_len)
    if quantize:
        cache = _quantized(cache)
    out, rows = [int(torch.argmax(logits[0]))], [logits[0]]
    for i in range(n - 1):
        tok = out[-1] if feed is None else feed[i]
        logits, cache = tserve.decode_step(model, params, cache,
                                           torch.tensor([[tok]]))
        out.append(int(torch.argmax(logits[0])))
        rows.append(logits[0])
    return out, rows


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


def _run(model, params, prompts, n_slots, n_new=6, eos=None, extras=None):
    """(batcher, its finished requests, their logits rows by id)."""
    batcher = TS.ContinuousBatcher(model, params, n_slots=n_slots,
                                   max_len=64)
    rows = _record(batcher)
    for i, p in enumerate(prompts):
        batcher.submit(TS.Request(rid=i, prompt=torch.as_tensor(p),
                                  max_new_tokens=n_new, eos_id=eos,
                                  extras=extras[i] if extras else None))
    return batcher, batcher.run_until_done(), rows


# ---------------------------------------------------------------------------
# tests/test_serving_scheduler.py, ported
# ---------------------------------------------------------------------------

def test_continuous_batching_token_exact():
    """3 requests through 2 slots (waiting and slot recycling): each
    stream equals the request served alone."""
    _, _, tm, tp = _models()
    prompts = _prompts(tm.cfg.vocab, 3)
    refs = [_solo(tm, tp, p, 6)[0] for p in prompts]
    batcher, done, rows = _run(tm, tp, prompts, 2)
    assert len(done) == 3
    for req in done:
        assert req.out == refs[req.rid], (req.rid, req.out, refs[req.rid])
        assert len(rows[req.rid]) == len(req.out)
    assert batcher.cache["lens"].tolist() == [-1, -1]


def test_eos_frees_slot_early():
    _, _, tm, tp = _models()
    prompt = np.random.RandomState(9).randint(0, tm.cfg.vocab, 6)
    ref = _solo(tm, tp, prompt, 8)[0]
    eos = ref[2]     # force an early stop no later than the 3rd token
    batcher, done, _ = _run(tm, tp, [prompt], 1, n_new=8, eos=eos)
    assert done[0].out == ref[:ref.index(eos) + 1]
    assert int(batcher.cache["lens"][0]) == -1


def test_eos_at_prefill_never_decodes(monkeypatch):
    _, _, tm, tp = _models()
    prompt = np.random.RandomState(9).randint(0, tm.cfg.vocab, 6)
    first = _solo(tm, tp, prompt, 1)[0][0]
    monkeypatch.setattr(TS, "batched_decode_step",
                        lambda *a: pytest.fail("a decode step ran"))
    batcher, done, rows = _run(tm, tp, [prompt, prompt], 1, n_new=8,
                               eos=first)
    assert [r.out for r in done] == [[first], [first]]
    assert [len(r) for r in rows.values()] == [1, 1] and not batcher.live


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["yi-6b", "qwen3-4b"])
def test_batcher_tokens_equal_the_jax_batcher(arch):
    jm, jp, tm, tp = _models(arch)
    prompts = _prompts(tm.cfg.vocab, 5, base=4, step=5, seed=20)
    jb = JS.ContinuousBatcher(jm, jp, n_slots=3, max_len=64)
    for i, p in enumerate(prompts):
        jb.submit(JS.Request(rid=i, prompt=jnp.asarray(p, jnp.int32),
                             max_new_tokens=4 + i))
    want = {r.rid: r.out for r in jb.run_until_done()}
    batcher = TS.ContinuousBatcher(tm, tp, n_slots=3, max_len=64)
    for i, p in enumerate(prompts):
        batcher.submit(TS.Request(rid=i, prompt=torch.as_tensor(p),
                                  max_new_tokens=4 + i))
    got = {r.rid: r.out for r in batcher.run_until_done()}
    assert got == want


def _pools(jm, tm, lens):
    """Both packages' pools of 3 slots, filled with the same numpy values,
    with per-slot lengths ``lens`` (-1: dead)."""
    jc = JS.init_pool(jm, 3, 12)
    rng = np.random.RandomState(5)
    k = rng.randn(*jc["k"].shape).astype(np.float32)
    v = rng.randn(*jc["v"].shape).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    jc = {"k": jnp.asarray(k), "v": jnp.asarray(v), "lens": jnp.asarray(lens)}
    tc = TS.init_pool(tm, 3, 12, device="cpu")
    tc["k"].copy_(torch.from_numpy(k))
    tc["v"].copy_(torch.from_numpy(v))
    tc["lens"].copy_(torch.from_numpy(lens))
    return jc, tc, k


def test_batched_decode_step_matches_jax():
    """Three steps over slots at lengths 5, 0 and dead: logits and the live
    slots' regions within 1e-4, the pool written in place, the dead slot
    written at row 0 and kept at -1."""
    jm, jp, tm, tp = _models()
    jc, tc, k0 = _pools(jm, tm, [5, 0, -1])
    k_buf = tc["k"]
    toks = np.random.RandomState(6).randint(0, tm.cfg.vocab, (3, 3))
    for t in range(3):
        tok = toks[:, t:t + 1]
        j_logits, jc = JS.batched_decode_step(jm, jp, jc, jnp.asarray(tok))
        t_logits, tc = TS.batched_decode_step(tm, tp, tc, torch.from_numpy(tok))
        assert _err(t_logits[:2], j_logits[:2]) <= SLICE_TOL
    assert tc["k"] is k_buf
    assert tc["lens"].tolist() == [8, 3, -1]
    jk, jv = np.asarray(jc["k"]), np.asarray(jc["v"])
    assert _err(tc["k"][:, :2], jk[:, :2]) <= SLICE_TOL
    assert _err(tc["v"][:, :2], jv[:, :2]) <= SLICE_TOL
    # the dead slot's region: row 0 written, the rest as it was
    assert torch.equal(tc["k"][:, 2, 1:], torch.from_numpy(k0[:, 2, 1:]))
    assert not torch.equal(tc["k"][:, 2, :1], torch.from_numpy(k0[:, 2, :1]))


def test_insert_prefill_and_init_pool_match_jax():
    jm, jp, tm, tp = _models()
    j_pool, t_pool = JS.init_pool(jm, 2, 20), TS.init_pool(tm, 2, 20,
                                                            device="cpu")
    for name in j_pool:
        assert tuple(t_pool[name].shape) == j_pool[name].shape
        assert np.array_equal(t_pool[name].numpy(), np.asarray(j_pool[name]))
    toks = np.random.RandomState(7).randint(0, tm.cfg.vocab, (1, 9))
    _, j_pre = jserve.prefill(jm, jp, {"tokens": jnp.asarray(toks)}, 20)
    _, t_pre = tserve.prefill(tm, tp, {"tokens": torch.from_numpy(toks)}, 20)
    j_pool = JS.insert_prefill(j_pool, 1, j_pre)
    k_buf = t_pool["k"]
    assert TS.insert_prefill(t_pool, 1, t_pre) is t_pool
    assert t_pool["k"] is k_buf and t_pool["lens"].tolist() == [-1, 9]
    for name in ("k", "v"):
        assert _err(t_pool[name][:, 1], np.asarray(j_pool[name])[:, 1]) \
            <= SLICE_TOL
        assert float(t_pool[name][:, 0].abs().sum()) == 0.0


def test_int8_pool_tracks_the_float_path():
    """kv_cache_int8: the pool holds int8 k/v and bf16 scales; each request's
    logits stay within the int8 decode gate of the float path fed the same
    tokens."""
    _, _, tm, tp = _models(kv_cache_int8=True)
    float_model = tlm.LM(tm.cfg.with_(kv_cache_int8=False))
    prompts = _prompts(tm.cfg.vocab, 3, seed=40)
    batcher, done, got = _run(tm, tp, prompts, 2, n_new=8)
    assert batcher.cache["k"].dtype == torch.int8
    assert batcher.cache["k_s"].dtype == torch.bfloat16
    for req in done:
        _, rows = _solo(float_model, tp, prompts[req.rid], len(req.out),
                        feed=req.out)
        errs = [_err(a, b.numpy()) for a, b in zip(got[req.rid], rows)]
        assert errs[0] == 0.0                   # prefill is float either way
        assert max(errs) < INT8_DECODE_GATE, errs


def test_int8_batcher_equals_the_int8_path_alone():
    """The batcher's own int8 path (the pool quantized at admission and at
    each tick, per-slot positions): each request's logits within the f32
    slice tolerance of the request served alone from its prefill cache
    quantized the same way and fed the same tokens; equal tokens."""
    _, _, tm, tp = _models(kv_cache_int8=True)
    prompts = _prompts(tm.cfg.vocab, 3, seed=40)
    _, done, got = _run(tm, tp, prompts, 2, n_new=8)
    for req in done:
        out, rows = _solo(tm, tp, prompts[req.rid], len(req.out),
                          feed=req.out, quantize=True)
        assert out == req.out
        errs = [_err(a, b.numpy()) for a, b in zip(got[req.rid], rows)]
        assert len(errs) == len(req.out) and max(errs) <= SLICE_TOL, errs


# Fault F8: the f32 int8 batcher against each request served alone read
# 1.76e-3 on the card (qwen3-4b, 36 layers), not the ~1e-5 of the float
# pool.  The batcher's products over 8 slots and a request's over 1 sum in
# other orders, so the f32 k/v that the int8 pool quantizes differ by a
# few ulps; an entry that close to a .5 boundary rounds the other way, one
# quantization step, and later layers read it.  At qwen3-4b's widths (8 KV
# heads of 128) this shows in a few ticks.
F8_SLOTS, F8_LAYERS, F8_TICKS = 8, 2, 3
#: relative difference of the f32 k/v behind the two pools: at the first
#: layer of the first tick (the same cache; only summation orders differ),
#: and anywhere (later layers read entries that rounded the other way)
F8_FIRST_REL, F8_ANY_REL = 1e-5, 1e-3
#: bf16 scales may differ by one bf16 step at most
F8_SCALE_REL = 2.0 ** -7


def _quantized_inputs(monkeypatch):
    """Record every ``quantize_kv`` call's f32 input and int8 values."""
    calls = []
    real = TL.quantize_kv

    def recorded(x):
        q, s = real(x)
        calls.append((x.to(torch.float32).clone(), q, s))
        return q, s

    monkeypatch.setattr(TL, "quantize_kv", recorded)
    return calls


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def test_int8_batcher_against_alone_differs_only_by_rounding_flips(
        monkeypatch):
    """Fault F8, explained: every int8 entry in which the batcher's pool
    and a request served alone (decoded from its prefill quantized alike,
    fed the batcher's tokens) differ is one quantization step apart, and
    the .5 boundary between the two lies between the f32 values behind
    them, which differ by rounding (within F8_FIRST_REL at the first layer
    of the first tick, F8_ANY_REL anywhere); the scales agree within one
    bf16 step."""
    cfg = tarchs.ARCHS["qwen3-4b"].with_(
        dtype="float32", n_layers=F8_LAYERS, vocab=512, kv_cache_int8=True)
    model = tlm.LM(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    calls = _quantized_inputs(monkeypatch)
    prompts = _prompts(cfg.vocab, F8_SLOTS, base=24, step=9, seed=50)
    per_tick = 2 * cfg.n_layers
    with torch.inference_mode():
        batcher = TS.ContinuousBatcher(model, params, n_slots=F8_SLOTS,
                                       max_len=128)
        rows = _record(batcher)
        for i, p in enumerate(prompts):
            batcher.submit(TS.Request(rid=i, prompt=torch.as_tensor(p),
                                      max_new_tokens=F8_TICKS + 2))
        for _ in range(F8_TICKS):
            batcher.step()
        ticks = calls[2 * F8_SLOTS:]
        assert len(ticks) == F8_TICKS * per_tick
        assert len(batcher.live) == F8_SLOTS
        solo, logits_err = {}, 0.0
        for req in batcher.live.values():
            _, cache = tserve.prefill(model, params,
                                      {"tokens": req.prompt[None]}, 128)
            cache = _quantized(cache)
            del calls[:]
            for t in range(F8_TICKS):
                logits, cache = tserve.decode_step(
                    model, params, cache, torch.tensor([[req.out[t]]]))
                logits_err = max(logits_err,
                                 _err(rows[req.rid][t + 1], logits[0].numpy()))
            solo[req.slot] = list(calls)
    flips = entries = 0
    for t in range(F8_TICKS):
        for j in range(per_tick):
            xb, qb, sb = ticks[t * per_tick + j]
            for slot, rec in solo.items():
                xs, qs, ss = rec[t * per_tick + j]
                xb_, qb_, sb_ = xb[slot], qb[slot], sb[slot]
                bound = F8_FIRST_REL if (t, j // 2) == (0, 0) else F8_ANY_REL
                assert _rel(xb_, xs[0]) <= bound, (t, j, slot)
                assert _rel(sb_.float(), ss[0].float()) <= F8_SCALE_REL
                entries += qb_.numel()
                differ = qb_ != qs[0]
                flips += int(differ.sum())
                if not differ.any():
                    continue
                a, b = qb_[differ].int(), qs[0][differ].int()
                assert bool(((a - b).abs() == 1).all()), (t, j, slot)
                scale_b = xb_.abs().amax(-1, keepdim=True) / 127.0 + 1e-12
                scale_s = xs[0].abs().amax(-1, keepdim=True) / 127.0 + 1e-12
                ub = (xb_ / scale_b)[differ].double()
                us = (xs[0] / scale_s)[differ].double()
                boundary = torch.minimum(a, b).double() + 0.5
                assert bool(((ub - boundary) * (us - boundary) <= 0).all()), (
                    t, j, slot, ub, us)
    print(f"F8: {flips} of {entries} int8 entries rounded the other way; "
          f"logits against alone {logits_err:.3g}")
    assert flips <= 0.01 * entries, (flips, entries)


def test_attn_skip_masked_batcher_equals_the_plain_one():
    _, _, tm, tp = _models()
    tri = tlm.LM(tm.cfg.with_(attn_skip_masked=True))
    prompts = _prompts(tm.cfg.vocab, 3, base=30, step=7, seed=50)
    _, plain, plain_rows = _run(tm, tp, prompts, 2)
    _, skip, skip_rows = _run(tri, tp, prompts, 2)
    by_rid = {r.rid: r for r in plain}
    for req in skip:
        assert req.out == by_rid[req.rid].out
        assert all(torch.equal(a, b) for a, b in zip(skip_rows[req.rid],
                                                    plain_rows[req.rid]))


# ---------------------------------------------------------------------------
# the mixed-shape image stream (tests/test_conv_service.py, the scheduler)
# ---------------------------------------------------------------------------

IMAGE_SHAPES = [(1, 6, 7, 3), (1, 8, 8, 3), (1, 13, 16, 3)]


def _vision_stream(tm, kernel=None):
    """The three mixed-shape images through a warmed patch embed (classes
    1x8x8 and 1x16x16) into (1, prefix_len, d_model) vision tokens."""
    frontend, svc = TC.patch_embed_service(
        torch.Generator().manual_seed(1) if kernel is None else None, 3,
        tm.cfg.d_model, 4, classes=[(1, 8, 8), (1, 16, 16)],
        prefix_len=tm.cfg.prefix_len, plan_mode="analytic", device="cpu",
        kernel=kernel)
    assert len(svc.warmup.plans) == 2
    images = [np.random.RandomState(20 + i).randn(*s).astype(np.float32)
              for i, s in enumerate(IMAGE_SHAPES)]
    return [frontend(torch.from_numpy(im)) for im in images], images, svc


def test_scheduler_drains_mixed_shape_image_stream():
    """Variable-shape images -> warmed patch-embed service -> vision
    tokens -> continuous batcher: token streams equal the solo prefill and
    decode, and EOS still stops a stream and frees its slot."""
    _, _, tm, tp = _models("llava-next-34b")
    assert tm.cfg.family == "vlm"
    visions, _, _ = _vision_stream(tm)
    for v in visions:
        assert tuple(v.shape) == (1, tm.cfg.prefix_len, tm.cfg.d_model)
    prompts = _prompts(tm.cfg.vocab, 3, base=4, step=1, seed=10)
    extras = [{"vision": v} for v in visions]
    refs = [_solo(tm, tp, p, 5, extras=e)[0] for p, e in zip(prompts, extras)]
    _, done, _ = _run(tm, tp, prompts, 2, n_new=5, extras=extras)
    assert len(done) == 3
    for req in done:
        assert req.out == refs[req.rid], (req.rid, req.out, refs[req.rid])
    eos = refs[0][1]
    batcher, done, _ = _run(tm, tp, prompts[:1], 1, n_new=5, eos=eos,
                            extras=extras)
    assert done[0].out == refs[0][:refs[0].index(eos) + 1]
    assert int(batcher.cache["lens"][0]) == -1


def test_image_stream_tokens_equal_the_jax_package():
    """The same images, patch-embed kernel, parameters and prompts through
    both packages' frontends and batchers: equal tokens."""
    jm, jp, tm, tp = _models("llava-next-34b")
    jfront, jsvc = JC.patch_embed_service(
        jax.random.key(1), 3, jm.cfg.d_model, 4,
        classes=[(1, 8, 8), (1, 16, 16)], prefix_len=jm.cfg.prefix_len,
        plan_mode="analytic")
    visions, images, _ = _vision_stream(
        tm, kernel=params_from_jax(np.asarray(jsvc.kernel), device="cpu"))
    prompts = _prompts(tm.cfg.vocab, 3, base=4, step=1, seed=10)
    jb = JS.ContinuousBatcher(jm, jp, n_slots=2, max_len=64)
    for i, (p, im) in enumerate(zip(prompts, images)):
        jb.submit(JS.Request(rid=i, prompt=jnp.asarray(p, jnp.int32),
                             max_new_tokens=5,
                             extras={"vision": jfront(jnp.asarray(im))}))
    want = {r.rid: r.out for r in jb.run_until_done()}
    _, done, _ = _run(tm, tp, prompts, 2, n_new=5,
                      extras=[{"vision": v} for v in visions])
    assert {r.rid: r.out for r in done} == want


# ---------------------------------------------------------------------------
# admission, the decode program, the example
# ---------------------------------------------------------------------------

def test_submit_refuses_a_request_longer_than_the_pool():
    _, _, tm, tp = _models()
    batcher = TS.ContinuousBatcher(tm, tp, n_slots=1, max_len=16)
    batcher.submit(TS.Request(rid=0, prompt=torch.zeros(10, dtype=torch.long),
                              max_new_tokens=7))
    with pytest.raises(ValueError, match="needs 17 positions"):
        batcher.submit(TS.Request(rid=1,
                                  prompt=torch.zeros(10, dtype=torch.long),
                                  max_new_tokens=8))


@pytest.mark.parametrize("arch,err", [
    ("zamba2-7b", ValueError), ("whisper-tiny", ValueError),
    ("qwen3-moe-30b-a3b", ValueError)])
def test_batcher_refuses_the_other_families(arch, err):
    cfg = tarchs.smoke_config(arch)
    with pytest.raises(err):
        TS.ContinuousBatcher(tlm.LM(cfg), {"emb": torch.zeros(1)}, n_slots=1)


@pytest.mark.parametrize("arch", ["yi-6b", "zamba2-7b", "whisper-tiny"])
def test_decode_program_on_cpu_is_the_eager_step(arch):
    """On the CPU the program runs ``decode_step`` eagerly over the fixed
    cache: equal bits to the step itself, the counter advanced in the
    cache's own tensor."""
    cfg = tarchs.smoke_config(arch)
    model = tlm.LM(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 12),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :8]}
    if cfg.family == "audio":
        batch["frames"] = torch.randn((2, cfg.encoder_len, cfg.d_model),
                                      generator=torch.Generator().manual_seed(2))
    _, cache = tserve.prefill(model, params, batch, 16)
    ref = tlm.tree_map(torch.clone, cache)
    length = cache["len"]
    prog = DecodeProgram(lambda c, t: tserve.decode_step(model, params, c, t),
                         cache, torch.zeros((2, 1), dtype=torch.long))
    assert prog.graph is None
    for i in range(4):
        prog.tokens.copy_(toks[:, 8 + i:9 + i])
        got = prog()
        want, ref = tserve.decode_step(model, params, ref, toks[:, 8 + i:9 + i])
        assert torch.equal(got, want)
    assert prog.cache["len"] is length and int(length) == 12

    def equal(a, b):
        if isinstance(a, dict):
            return sorted(a) == sorted(b) and all(equal(a[k], b[k]) for k in a)
        return (a is None and b is None) or torch.equal(a, b)

    assert equal(cache, ref)


def test_decode_program_graph_needs_a_card():
    cache = {"len": torch.zeros((), dtype=torch.int32)}
    with pytest.raises(ValueError, match="CUDA device"):
        DecodeProgram(lambda c, t: (t, c), cache,
                      torch.zeros((1, 1), dtype=torch.long), graph=True)


def test_example_on_the_cpu(capsys):
    done = example.main(["--device", "cpu"])
    assert len(done) == 6
    assert all(len(r.out) == example.NEW_TOKENS for r in done)
    assert "[cb] 6 requests, 48 tokens" in capsys.readouterr().out
