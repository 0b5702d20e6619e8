"""Parameters, operations and bytes of the Zamba2 hybrid LM's serving
steps, counted from a configuration file's keys (transformers'
``Zamba2Config`` names) alone, whatever implements them.

A matrix multiply of m x k by k x n is 2 m k n operations.  Attention is
causal: a sequence of s positions has s (s + 1) / 2 query-key pairs.
The scan counts its recurrence, 4 H P N a token (the state's update and
its read-out), not the quadratic form within chunks.  Prefill computes
the logits of each sequence's last position only; a decode step those of
its one token.

Bytes are what a step must move through HBM at the least: each weight
byte read once (the shared blocks once, however many hybrid layers use
them; the head's matrix once, the table itself where tied; b gathered
rows of the embedding for the lookup, not the table),
each Mamba2 layer's f32 state read and written, its conv history read
and written, the attention caches read up to the current length and
written at it, the logits written.  ``k5_bytes`` counts one call of the
conv kernel: its input and output read and written once, and its
weights.
"""
from __future__ import annotations

from typing import Mapping

from mecbench.yardstick.peaks import DTYPE_BYTES

F32_BYTES = 4


def dims(cfg: Mapping) -> dict:
    """The sizes the counts use."""
    d = cfg["hidden_size"]
    d_in = cfg["mamba_expand"] * d
    g, n = cfg["mamba_ngroups"], cfg["mamba_d_state"]
    heads = cfg["n_mamba_heads"]
    return {"d": d, "d_in": d_in, "conv_ch": d_in + 2 * g * n,
            "in_proj": 2 * d_in + 2 * g * n + heads, "heads": heads,
            "p": cfg["mamba_headdim"], "n": n, "k": cfg["mamba_d_conv"],
            "a_in": cfg["attention_hidden_size"],
            "att": cfg["num_attention_heads"] * cfg["attention_head_dim"],
            "kv": cfg["num_key_value_heads"] * cfg["attention_head_dim"],
            "f": cfg["intermediate_size"], "r": cfg["adapter_rank"],
            "v": cfg["vocab_size"], "layers": cfg["num_hidden_layers"],
            "apps": len(cfg["hybrid_layer_ids"]),
            "blocks": cfg["num_mem_blocks"]}


def params(cfg: Mapping) -> dict:
    """Parameter counts by part, and ``total``: the embedding once where
    the head is tied (``tie_word_embeddings`` absent is true)."""
    m = dims(cfg)
    d = m["d"]
    mamba = (d * m["in_proj"] + (m["k"] + 1) * m["conv_ch"]
             + 3 * m["heads"] + m["d_in"] + m["d_in"] * d + d)
    block = (m["a_in"] * (m["att"] + 2 * m["kv"]) + m["att"] * d
             + 3 * d * m["f"] + m["a_in"] + d)
    hybrid = m["r"] * (d + 2 * m["f"]) + d * d
    embed = m["v"] * d
    head = 0 if cfg.get("tie_word_embeddings", True) else embed
    out = {"mamba": m["layers"] * mamba, "blocks": m["blocks"] * block,
           "hybrid": m["apps"] * hybrid, "embed": embed, "head": head,
           "final_norm": d}
    out["total"] = sum(out.values())
    return out


def token_matmul_params(cfg: Mapping) -> int:
    """The weights of the matrix multiplies a token runs through, each
    counted as often as it is used: every Mamba2 layer's projections,
    and at each hybrid layer its shared block's, LoRA's and linear's."""
    m = dims(cfg)
    d = m["d"]
    mamba = d * m["in_proj"] + m["d_in"] * d
    app = (m["a_in"] * (m["att"] + 2 * m["kv"]) + m["att"] * d
           + 3 * d * m["f"] + m["r"] * (d + 2 * m["f"]) + d * d)
    return m["layers"] * mamba + m["apps"] * app


def _per_token_flops(cfg: Mapping) -> float:
    """A token's operations outside attention's scores and the head: the
    matrix multiplies, the conv and the scan."""
    m = dims(cfg)
    conv = 2 * m["k"] * m["conv_ch"]
    scan = 4 * m["heads"] * m["p"] * m["n"]
    return 2 * token_matmul_params(cfg) + m["layers"] * (conv + scan)


def prefill_flops(cfg: Mapping, batch: int, seq: int) -> float:
    """One prefill batch of ``batch`` prompts of ``seq`` tokens."""
    m = dims(cfg)
    pairs = seq * (seq + 1) / 2
    attention = m["apps"] * batch * 2 * 2 * pairs * m["att"]
    head = 2 * batch * m["d"] * m["v"]
    return batch * seq * _per_token_flops(cfg) + attention + head


def decode_flops(cfg: Mapping, batch: int, length: int) -> float:
    """One decode step of ``batch`` tokens, each attending to ``length``
    positions (its own included)."""
    m = dims(cfg)
    attention = m["apps"] * batch * 2 * 2 * length * m["att"]
    head = 2 * batch * m["d"] * m["v"]
    return batch * _per_token_flops(cfg) + attention + head


def decode_bytes(cfg: Mapping, batch: int, length: int, dtype: str) -> float:
    """One decode step of ``batch`` tokens whose caches hold ``length``
    positions after it (see the module's docstring)."""
    m = dims(cfg)
    e = DTYPE_BYTES[dtype]
    p = params(cfg)
    # the lookup's b rows, and the head's matrix (the table where tied)
    weights = (p["total"] - p["embed"] - p["head"] + batch * m["d"]
               + m["v"] * m["d"]) * e
    state = 2 * m["layers"] * batch * m["heads"] * m["p"] * m["n"] * F32_BYTES
    conv = 2 * m["layers"] * batch * (m["k"] - 1) * m["conv_ch"] * e
    kv = m["apps"] * batch * 2 * m["kv"] * (length + 1) * e
    logits = batch * m["v"] * F32_BYTES
    return weights + state + conv + kv + logits


def k5_bytes(cfg: Mapping, batch: int, seq: int, dtype: str) -> float:
    """One call of the Mamba2 conv kernel over ``batch`` x ``seq``
    positions: input read, output written, weights read."""
    m = dims(cfg)
    return (2 * batch * seq + m["k"]) * m["conv_ch"] * DTYPE_BYTES[dtype]
