"""Serving paths (counterpart of ``repro.models.serve``): prefill (build
caches from a prompt) and single-token decode.

The hybrid (zamba2) and audio (whisper) families are ported; the others
raise ``NotImplementedError`` naming ROADMAP Queue 1 item 10.  Caches are
dicts with the JAX package's tree and layer-stacked leaves:

    hybrid: {"mamba": {"state": (n_super, attn_every, B, H, P, N) f32,
                       "conv":  (n_super, attn_every, B, k_w - 1, C)},
             "attn_k", "attn_v": (n_super, B, max_len, KV, D),
             "tail": the tail layers' {"state", "conv"} or None,
             "len": 0-d int32}
    audio:  {"k", "v": (n_layers, B, max_len, KV, D),
             "cross_k", "cross_v": (n_layers, B, T_enc, KV, D),
             "len": 0-d int32}

``decode_step`` writes the new token's state, conv history and k/v into
the cache's buffers in place (the JAX package returns updated copies) and
returns a cache dict holding the same buffers and ``len + 1``.  The audio
family's cross-attention k/v are computed once, at prefill.
"""
from __future__ import annotations

import torch

from repro_torch.models import mamba2
from repro_torch.models.layers import (attention_decode, decode_attention,
                                       linear, rms_norm, swiglu)
from repro_torch.models.lm import (LM, dense_block, gelu_mlp, require_ported,
                                   torch_dtype, tree_at, tree_map, tree_set)


def _kv_into(max_len: int, k: torch.Tensor, v: torch.Tensor):
    """Embed prefill k/v (B,S,KV,D) into zero caches of length max_len."""
    b, s, kv, d = k.shape
    kc = torch.zeros((b, max_len, kv, d), dtype=k.dtype, device=k.device)
    vc = torch.zeros((b, max_len, kv, d), dtype=v.dtype, device=v.device)
    kc[:, :s] = k
    vc[:, :s] = v
    return kc, vc


def _logits_last(model: LM, params, h):
    """Last-position logits (B, V), in f32."""
    w = model.head_weights(params)
    return torch.matmul(h[:, -1, :].to(torch.float32), w.to(torch.float32))


def _logits_one(model: LM, params, h):
    return _logits_last(model, params, h)


def _stacked_mamba_cache(cfg, prefix, batch: int, device):
    return tree_map(lambda t: t.expand(prefix + tuple(t.shape)).clone(),
                    mamba2.init_mamba_cache(cfg, batch, torch_dtype(cfg),
                                            device=device))


# ---------------------------------------------------------------------------
# hybrid (zamba2)
# ---------------------------------------------------------------------------

def _hybrid_prefill(model: LM, params, batch, max_len: int):
    cfg = model.cfg
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
    kv_shape = (0, b, max_len, cfg.n_kv_heads, cfg.head_dim)
    empty = torch.zeros(kv_shape, dtype=h.dtype, device=h.device)
    cache = {"mamba": mcaches,
             "attn_k": torch.stack(kcs) if kcs else empty,
             "attn_v": torch.stack(vcs) if vcs else empty.clone(),
             "tail": tail_cache,
             "len": torch.tensor(s, dtype=torch.int32, device=h.device)}
    return _logits_last(model, params, h), cache


def _hybrid_decode(model: LM, params, cache, tokens):
    cfg = model.cfg
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
                       shared["mlp"])
    if tail:
        tail_norms = params["mamba_norms"][n_super * cfg.attn_every:]
        for j in range(tail):
            h = mamba_step(h, tree_at(params["mamba_tail"], (j,)),
                           tail_norms[j], cache["tail"], (j,))
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _logits_one(model, params, h), dict(cache, len=ln + 1)


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
    b = h.shape[0]
    for i in range(cfg.n_layers):
        p = tree_at(params["dec_blocks"], (i,))
        xn = rms_norm(h, p["norm1"], cfg.norm_eps)
        a, _ = attention_decode(p["attn"], cfg, xn,
                                {"k": cache["k"][i], "v": cache["v"][i],
                                 "len": ln})
        h = h + a
        # cross-attention against the static encoder cache
        xn = rms_norm(h, p["norm_x"], cfg.norm_eps)
        q = linear(xn, p["xattn"]["wq"]).reshape(b, 1, cfg.n_heads,
                                                 cfg.head_dim)
        ck, cv = cache["cross_k"][i], cache["cross_v"][i]
        xa = decode_attention(q, ck, cv, ck.shape[1])
        xa = linear(xa.reshape(b, 1, cfg.n_heads * cfg.head_dim),
                    p["xattn"]["wo"])
        h = h + xa
        h = h + gelu_mlp(rms_norm(h, p["norm2"], cfg.norm_eps), p["mlp"])
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _logits_one(model, params, h), dict(cache, len=ln + 1)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

_PREFILL = {"hybrid": _hybrid_prefill, "audio": _audio_prefill}
_DECODE = {"hybrid": _hybrid_decode, "audio": _audio_decode}


def prefill(model: LM, params, batch, max_len: int):
    """-> (last-token logits (B, V) f32, cache)."""
    require_ported(model.cfg, "prefill")
    return _PREFILL[model.cfg.family](model, params, batch, max_len)


def decode_step(model: LM, params, cache, tokens):
    """tokens (B, 1) -> (logits (B, V) f32, cache), the cache updated in
    place."""
    require_ported(model.cfg, "decode_step")
    return _DECODE[model.cfg.family](model, params, cache, tokens)


def init_decode_cache(model: LM, batch: int, max_len: int, device="cuda"):
    """Zero caches for decode-only benchmarking (no prefill)."""
    cfg = model.cfg
    require_ported(cfg, "init_decode_cache")
    dt = torch_dtype(cfg)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    length = torch.tensor(max_len - 1, dtype=torch.int32, device=device)
    hd, kv = cfg.head_dim, cfg.n_kv_heads
    if cfg.family == "audio":
        return {"k": zeros(cfg.n_layers, batch, max_len, kv, hd),
                "v": zeros(cfg.n_layers, batch, max_len, kv, hd),
                "cross_k": zeros(cfg.n_layers, batch, cfg.encoder_len, kv, hd),
                "cross_v": zeros(cfg.n_layers, batch, cfg.encoder_len, kv, hd),
                "len": length}
    n_super, tail = divmod(cfg.n_layers, cfg.attn_every)
    return {"mamba": _stacked_mamba_cache(cfg, (n_super, cfg.attn_every),
                                          batch, device),
            "attn_k": zeros(n_super, batch, max_len, kv, hd),
            "attn_v": zeros(n_super, batch, max_len, kv, hd),
            "tail": (_stacked_mamba_cache(cfg, (tail,), batch, device)
                     if tail else None),
            "len": length}
