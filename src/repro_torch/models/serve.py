"""Serving paths (counterpart of ``repro.models.serve``): prefill (build
caches from a prompt) and single-token decode.

Every family is ported: dense, vlm (llava), moe, hybrid (zamba2), ssm
(xLSTM) and audio (whisper).  Caches are dicts with the JAX package's
tree and layer-stacked leaves:

    dense, vlm, moe: {"k", "v": (n_layers, B, max_len, KV, D),
                 "len": 0-d int32}; an int8 cache (``init_decode_cache``
                 with ``cfg.kv_cache_int8``) holds int8 "k", "v" and bf16
                 "k_s", "v_s": (n_layers, B, max_len, KV, 1).  Prefill
                 builds a float cache whatever the flag, as the JAX
                 package's does; decode takes either.
    hybrid: {"mamba": {"state": (n_super, attn_every, B, H, P, N) f32,
                       "conv":  (n_super, attn_every, B, k_w - 1, C)},
             "attn_k", "attn_v": (n_super, B, max_len, KV, D),
             "tail": the tail layers' {"state", "conv"} or None,
             "len": 0-d int32}
            the published Zamba2 block (``cfg.hybrid_layer_ids``):
            {"mamba": {"state": (n_layers, B, H, P, N) f32,
                       "conv":  (n_layers, B, k_w - 1, C)},
             "attn_k", "attn_v": (hybrid layers, B, max_len, KV, D),
             "len": 0-d int32}
    ssm:    {"mlstm": {"c": (n_super, k_m, B, H, P, P), "n": (..., B, H, P),
                       "m": (..., B, H), "conv": (..., B, k_w - 1, d_in)},
             "slstm": {"c", "n", "m", "h": (n_super, B, H, P),
                       "conv": (n_super, B, k_w - 1, d_in)},
             "len": 0-d int32}, all f32, k_m = slstm_every - 1 and
            d_in = 2 d_model; no leaf grows with the sequence.
    audio:  {"k", "v": (n_layers, B, max_len, KV, D),
             "cross_k", "cross_v": (n_layers, B, T_enc, KV, D),
             "len": 0-d int32}

``decode_step`` writes the new token's state, conv history and k/v (and
int8 scales) into the cache's buffers in place (the JAX package returns updated copies) and
returns a cache dict holding the same buffers and ``len + 1``.  The audio
family's cross-attention k/v are computed once, at prefill.  ``prefill``
records the span ``lm.prefill`` and ``decode_step`` ``lm.decode``.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.models import mamba2, moe, xlstm
from repro_torch.models.layers import (attention_block, attention_decode,
                                       cross_attention_decode, kv_planes,
                                       rms_norm, swiglu)
from repro_torch.models.lm import (LM, dense_block, gelu_mlp, hybrid_block,
                                   hybrid_plan, moe_block, torch_dtype,
                                   tree_at, tree_map, tree_set)
from repro_torch.parallel import tensor
from repro_torch.parallel.axes import constrain


def _kv_heads(cfg) -> int:
    """The kv heads of a cache (the rank's under tensor parallelism)."""
    return tensor.local_kv_heads(cfg, tensor.context())


def _mlp_tp(cfg):
    return tensor.if_divides(tensor.context(), cfg.d_ff)


def _kv_into(max_len: int, k: torch.Tensor, v: torch.Tensor):
    """Embed prefill k/v (B,S,KV,D) into zero caches of length max_len."""
    b, s, kv, d = k.shape
    kc = torch.zeros((b, max_len, kv, d), dtype=k.dtype, device=k.device)
    vc = torch.zeros((b, max_len, kv, d), dtype=v.dtype, device=v.device)
    kc[:, :s] = k
    vc[:, :s] = v
    kc = constrain(kc, "batch", "seq_tp", "kv_heads", None)
    vc = constrain(vc, "batch", "seq_tp", "kv_heads", None)
    return kc, vc


def _logits_last(model: LM, params, h):
    """Last-position logits (B, V), in f32: the rank's vocab shard (B,
    V / tp) where tensor parallelism splits the vocabulary
    (``tensor.gather_vocab`` / ``tensor.argmax_vocab`` read them)."""
    w = model.head_weights(params)
    return torch.matmul(h[:, -1, :].to(torch.float32), w.to(torch.float32))


def _logits_one(model: LM, params, h):
    return _logits_last(model, params, h)


def _stacked(layer_cache: dict, prefix) -> dict:
    """One layer's zero cache stacked over ``prefix``: buffers of their own
    (clones), not ``expand`` views, since decode writes them in place."""
    return tree_map(lambda t: t.expand(prefix + tuple(t.shape)).clone(),
                    layer_cache)


def _stacked_mamba_cache(cfg, prefix, batch: int, device):
    return _stacked(mamba2.init_mamba_cache(cfg, batch, torch_dtype(cfg),
                                            device=device), prefix)


def _ssm_caches(cfg, batch: int, device):
    """The ssm family's zero mLSTM (n_super, k_m, ...) and sLSTM
    (n_super, ...) caches."""
    n_super, k_m = cfg.n_layers // cfg.slstm_every, cfg.slstm_every - 1
    return (_stacked(xlstm.init_mlstm_cache(cfg, batch, device=device),
                     (n_super, k_m)),
            _stacked(xlstm.init_slstm_cache(cfg, batch, device=device),
                     (n_super,)))


# ---------------------------------------------------------------------------
# dense / vlm / moe
# ---------------------------------------------------------------------------

def _attn_families_prefill(model: LM, params, batch, max_len: int):
    """The vlm family prepends ``linear(vision, vision_proj)`` to the
    prompt's embeddings; the moe family's blocks run the MoE FFN.  Each
    layer's k/v go straight into the stacked cache, not into a list
    stacked after."""
    cfg = model.cfg
    h = model.embed(params, batch["tokens"])
    if cfg.family == "vlm":
        h = torch.cat([model.vision_tokens(params, batch["vision"]), h],
                      dim=1)
    b, s = h.shape[:2]
    positions = torch.arange(s, device=h.device)
    shape = (cfg.n_layers, b, max_len, _kv_heads(cfg), cfg.head_dim)
    kc = torch.zeros(shape, dtype=h.dtype, device=h.device)
    vc = torch.zeros(shape, dtype=h.dtype, device=h.device)
    block = moe_block if cfg.family == "moe" else dense_block
    for i in range(cfg.n_layers):
        h, (k, v) = block(tree_at(params["blocks"], (i,)), cfg, h,
                          positions)[:2]
        kc[i, :, :s] = k
        vc[i, :, :s] = v
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    cache = {"k": kc, "v": vc,
             "len": torch.tensor(s, dtype=torch.int32, device=h.device)}
    return _logits_last(model, params, h), cache


def _attn_families_decode(model: LM, params, cache, tokens):
    cfg = model.cfg
    h = model.embed(params, tokens)          # (B, 1, d)
    ln = cache["len"]
    planes = ("k", "v", "k_s", "v_s") if "k_s" in cache else ("k", "v")
    for i in range(cfg.n_layers):
        p = tree_at(params["blocks"], (i,))
        lcache = {name: cache[name][i] for name in planes}
        xn = rms_norm(h, p["norm1"], cfg.norm_eps)
        a, _ = attention_decode(p["attn"], cfg, xn, dict(lcache, len=ln))
        h = h + a
        xn2 = rms_norm(h, p["norm2"], cfg.norm_eps)
        if cfg.family == "moe":
            h = h + moe.moe_ffn(p["moe"], cfg, xn2)[0]
        else:
            h = h + swiglu(xn2, p["mlp"], _mlp_tp(cfg))
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _logits_one(model, params, h), dict(cache, len=ln + 1)


# ---------------------------------------------------------------------------
# hybrid (zamba2)
# ---------------------------------------------------------------------------

def _published_hybrid_prefill(model: LM, params, batch, max_len: int):
    """The published Zamba2 block (``lm.hybrid_plan``): each hybrid
    layer's k/v go into its slot of the stacked KV cache, each Mamba2
    layer's state and conv history into its slot."""
    cfg = model.cfg
    h = model.embed(params, batch["tokens"])
    emb = h
    b, s = h.shape[:2]
    positions = torch.arange(s, device=h.device)
    mcaches = _stacked_mamba_cache(cfg, (cfg.n_layers,), b, h.device)
    shape = (cfg.shared_apps, b, max_len, _kv_heads(cfg), cfg.head_dim)
    kc = torch.zeros(shape, dtype=h.dtype, device=h.device)
    vc = torch.zeros(shape, dtype=h.dtype, device=h.device)
    norms = params["mamba_norms"]

    def attend(p, x):
        return attention_block(p, cfg, x, positions)
    for n, k in hybrid_plan(cfg):
        x = h
        if k is not None:
            blk = k % cfg.n_mem_blocks
            t, (kk, vv) = hybrid_block(
                tree_at(params["shared"], (blk,)),
                tree_at(params["hybrid"], (k,)), cfg, h, emb, attend, n, blk)
            kc[k, :, :s] = kk
            vc[k, :, :s] = vv
            x = h + t
        out, mc = mamba2.mamba_core(tree_at(params["mamba"], (n,)), cfg,
                                    rms_norm(x, norms[n], cfg.norm_eps))
        tree_set(mcaches, (n,), mc)
        h = h + out
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    cache = {"mamba": mcaches, "attn_k": kc, "attn_v": vc,
             "len": torch.tensor(s, dtype=torch.int32, device=h.device)}
    return _logits_last(model, params, h), cache


def _published_hybrid_decode(model: LM, params, cache, tokens):
    cfg = model.cfg
    h = model.embed(params, tokens)
    emb = h
    ln = cache["len"]
    norms = params["mamba_norms"]
    for n, k in hybrid_plan(cfg):
        x = h
        if k is not None:
            def attend(p, xn, k=k):
                return attention_decode(p, cfg, xn,
                                        {"k": cache["attn_k"][k],
                                         "v": cache["attn_v"][k], "len": ln})
            blk = k % cfg.n_mem_blocks
            t, _ = hybrid_block(tree_at(params["shared"], (blk,)),
                                tree_at(params["hybrid"], (k,)), cfg, h, emb,
                                attend, n, blk)
            x = h + t
        out, mc = mamba2.mamba_decode(tree_at(params["mamba"], (n,)), cfg,
                                      rms_norm(x, norms[n], cfg.norm_eps),
                                      tree_at(cache["mamba"], (n,)))
        tree_set(cache["mamba"], (n,), mc)
        h = h + out
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _logits_one(model, params, h), dict(cache, len=ln + 1)


def _hybrid_prefill(model: LM, params, batch, max_len: int):
    cfg = model.cfg
    if cfg.hybrid_layer_ids:
        return _published_hybrid_prefill(model, params, batch, max_len)
    h = model.embed(params, batch["tokens"])
    b, s = h.shape[:2]
    positions = torch.arange(s, device=h.device)
    n_super, tail = divmod(cfg.n_layers, cfg.attn_every)
    norms = params["mamba_norms"][:n_super * cfg.attn_every].reshape(
        n_super, cfg.attn_every, -1)

    def mamba_step(x, p, nrm, caches, idx):
        out, mc = mamba2.mamba_core(p, cfg, rms_norm(x, nrm, cfg.norm_eps))
        tree_set(caches, idx, mc)
        return x + out

    mcaches = _stacked_mamba_cache(cfg, (n_super, cfg.attn_every), b, h.device)
    kcs, vcs = [], []
    for i in range(n_super):
        for j in range(cfg.attn_every):
            h = mamba_step(h, tree_at(params["mamba"], (i, j)), norms[i, j],
                           mcaches, (i, j))
        h, kv = dense_block(params["shared"], cfg, h, positions)
        kc, vc = _kv_into(max_len, *kv)
        kcs.append(kc)
        vcs.append(vc)
    tail_cache = None
    if tail:
        tail_norms = params["mamba_norms"][n_super * cfg.attn_every:]
        tail_cache = _stacked_mamba_cache(cfg, (tail,), b, h.device)
        for j in range(tail):
            h = mamba_step(h, tree_at(params["mamba_tail"], (j,)),
                           tail_norms[j], tail_cache, (j,))
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    kv_shape = (0, b, max_len, _kv_heads(cfg), cfg.head_dim)
    empty = torch.zeros(kv_shape, dtype=h.dtype, device=h.device)
    cache = {"mamba": mcaches,
             "attn_k": torch.stack(kcs) if kcs else empty,
             "attn_v": torch.stack(vcs) if vcs else empty.clone(),
             "tail": tail_cache,
             "len": torch.tensor(s, dtype=torch.int32, device=h.device)}
    return _logits_last(model, params, h), cache


def _hybrid_decode(model: LM, params, cache, tokens):
    cfg = model.cfg
    if cfg.hybrid_layer_ids:
        return _published_hybrid_decode(model, params, cache, tokens)
    h = model.embed(params, tokens)
    n_super, tail = divmod(cfg.n_layers, cfg.attn_every)
    norms = params["mamba_norms"][:n_super * cfg.attn_every].reshape(
        n_super, cfg.attn_every, -1)
    ln = cache["len"]
    shared = params["shared"]

    def mamba_step(x, p, nrm, caches, idx):
        out, mc = mamba2.mamba_decode(p, cfg, rms_norm(x, nrm, cfg.norm_eps),
                                      tree_at(caches, idx))
        tree_set(caches, idx, mc)
        return x + out

    for i in range(n_super):
        for j in range(cfg.attn_every):
            h = mamba_step(h, tree_at(params["mamba"], (i, j)), norms[i, j],
                           cache["mamba"], (i, j))
        xn = rms_norm(h, shared["norm1"], cfg.norm_eps)
        a, _ = attention_decode(shared["attn"], cfg, xn,
                                {"k": cache["attn_k"][i],
                                 "v": cache["attn_v"][i], "len": ln})
        h = h + a
        h = h + swiglu(rms_norm(h, shared["norm2"], cfg.norm_eps),
                       shared["mlp"], _mlp_tp(cfg))
    if tail:
        tail_norms = params["mamba_norms"][n_super * cfg.attn_every:]
        for j in range(tail):
            h = mamba_step(h, tree_at(params["mamba_tail"], (j,)),
                           tail_norms[j], cache["tail"], (j,))
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _logits_one(model, params, h), dict(cache, len=ln + 1)


# ---------------------------------------------------------------------------
# ssm (xLSTM)
# ---------------------------------------------------------------------------

def _ssm_prefill(model: LM, params, batch, max_len: int):  # lint-ignore: accepted-kwarg-not-forwarded
    """Super-blocks of k_m mLSTM blocks and one sLSTM block; each block's
    state goes straight into the stacked cache.  ssm caches are
    length-free: ``max_len`` (the dispatch signature's) is not read."""
    cfg = model.cfg
    h = model.embed(params, batch["tokens"])
    b, s = h.shape[:2]
    mc, sc = _ssm_caches(cfg, b, h.device)
    n_super, k_m = mc["c"].shape[:2]
    for i in range(n_super):
        for j in range(k_m):
            out, c = xlstm.mlstm_prefill(tree_at(params["mlstm"], (i, j)),
                                         cfg, h)
            tree_set(mc, (i, j), c)
            h = h + out
        out, c = xlstm.slstm_core(tree_at(params["slstm"], (i,)), cfg, h)
        tree_set(sc, (i,), c)
        h = h + out
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    cache = {"mlstm": mc, "slstm": sc,
             "len": torch.tensor(s, dtype=torch.int32, device=h.device)}
    return _logits_last(model, params, h), cache


def _ssm_decode(model: LM, params, cache, tokens):
    cfg = model.cfg
    h = model.embed(params, tokens)
    n_super, k_m = cache["mlstm"]["c"].shape[:2]
    for i in range(n_super):
        for j in range(k_m):
            out, _ = xlstm.mlstm_decode(tree_at(params["mlstm"], (i, j)), cfg,
                                        h, tree_at(cache["mlstm"], (i, j)))
            h = h + out
        out, _ = xlstm.slstm_decode(tree_at(params["slstm"], (i,)), cfg, h,
                                    tree_at(cache["slstm"], (i,)))
        h = h + out
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _logits_one(model, params, h), dict(cache, len=cache["len"] + 1)


# ---------------------------------------------------------------------------
# audio (whisper enc-dec)
# ---------------------------------------------------------------------------

def _audio_prefill(model: LM, params, batch, max_len: int):
    cfg = model.cfg
    enc = model.encode(params, batch["frames"])
    h = model.embed(params, batch["tokens"])
    s = h.shape[1]
    positions = torch.arange(s, device=h.device)
    kcs, vcs, cks, cvs = [], [], [], []
    for i in range(cfg.n_layers):
        p = tree_at(params["dec_blocks"], (i,))
        ck, cv = model._cross_kv(p, enc)
        h, kv = model._dec_block(p, h, positions, enc, cross_kv=(ck, cv))
        kc, vc = _kv_into(max_len, *kv)
        kcs.append(kc)
        vcs.append(vc)
        cks.append(ck)
        cvs.append(cv)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    cache = {"k": torch.stack(kcs), "v": torch.stack(vcs),
             "cross_k": torch.stack(cks), "cross_v": torch.stack(cvs),
             "len": torch.tensor(s, dtype=torch.int32, device=h.device)}
    return _logits_last(model, params, h), cache


def _audio_decode(model: LM, params, cache, tokens):
    cfg = model.cfg
    h = model.embed(params, tokens)
    ln = cache["len"]
    for i in range(cfg.n_layers):
        p = tree_at(params["dec_blocks"], (i,))
        xn = rms_norm(h, p["norm1"], cfg.norm_eps)
        a, _ = attention_decode(p["attn"], cfg, xn,
                                {"k": cache["k"][i], "v": cache["v"][i],
                                 "len": ln})
        h = h + a
        # cross-attention against the static encoder cache
        xn = rms_norm(h, p["norm_x"], cfg.norm_eps)
        h = h + cross_attention_decode(p["xattn"], cfg, xn,
                                       cache["cross_k"][i],
                                       cache["cross_v"][i])
        h = h + gelu_mlp(rms_norm(h, p["norm2"], cfg.norm_eps), p["mlp"],
                         _mlp_tp(cfg))
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _logits_one(model, params, h), dict(cache, len=ln + 1)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

_PREFILL = {"dense": _attn_families_prefill, "vlm": _attn_families_prefill,
            "moe": _attn_families_prefill, "hybrid": _hybrid_prefill,
            "ssm": _ssm_prefill, "audio": _audio_prefill}
_DECODE = {"dense": _attn_families_decode, "vlm": _attn_families_decode,
           "moe": _attn_families_decode, "hybrid": _hybrid_decode,
           "ssm": _ssm_decode, "audio": _audio_decode}


def prefill(model: LM, params, batch, max_len: int):
    """-> (last-token logits (B, V) f32, cache).  Under rules over a
    "model" axis (tensor parallelism) ``params`` are the rank's slices,
    the cache holds the rank's kv heads and channels, and the logits are
    the rank's vocab shard where the vocabulary splits."""
    with obs.span("lm.prefill"):
        return _PREFILL[model.cfg.family](model, params, batch, max_len)


def decode_step(model: LM, params, cache, tokens):
    """tokens (B, 1) -> (logits (B, V) f32, cache), the cache updated in
    place."""
    with obs.span("lm.decode"):
        return _DECODE[model.cfg.family](model, params, cache, tokens)


def init_decode_cache(model: LM, batch: int, max_len: int, device="cuda"):
    """Zero caches for decode-only benchmarking (no prefill)."""
    cfg = model.cfg
    dt = torch_dtype(cfg)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    length = torch.tensor(max_len - 1, dtype=torch.int32, device=device)
    hd, kv = cfg.head_dim, _kv_heads(cfg)
    if cfg.family in ("dense", "vlm", "moe"):
        return {**kv_planes((cfg.n_layers, batch, max_len, kv, hd), dt,
                            cfg.kv_cache_int8, device), "len": length}
    if cfg.family == "audio":
        return {"k": zeros(cfg.n_layers, batch, max_len, kv, hd),
                "v": zeros(cfg.n_layers, batch, max_len, kv, hd),
                "cross_k": zeros(cfg.n_layers, batch, cfg.encoder_len, kv, hd),
                "cross_v": zeros(cfg.n_layers, batch, cfg.encoder_len, kv, hd),
                "len": length}
    if cfg.family == "ssm":
        mc, sc = _ssm_caches(cfg, batch, device)
        return {"mlstm": mc, "slstm": sc, "len": length}
    if cfg.hybrid_layer_ids:
        return {"mamba": _stacked_mamba_cache(cfg, (cfg.n_layers,), batch,
                                              device),
                "attn_k": zeros(cfg.shared_apps, batch, max_len, kv, hd),
                "attn_v": zeros(cfg.shared_apps, batch, max_len, kv, hd),
                "len": length}
    n_super, tail = divmod(cfg.n_layers, cfg.attn_every)
    return {"mamba": _stacked_mamba_cache(cfg, (n_super, cfg.attn_every),
                                          batch, device),
            "attn_k": zeros(n_super, batch, max_len, kv, hd),
            "attn_v": zeros(n_super, batch, max_len, kv, hd),
            "tail": (_stacked_mamba_cache(cfg, (tail,), batch, device)
                     if tail else None),
            "len": length}
