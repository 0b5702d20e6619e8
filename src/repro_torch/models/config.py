"""Model configuration schema covering every assigned architecture family:
dense / moe / hybrid (Mamba2+shared-attn) / ssm (xLSTM) / vlm / audio.

A copy of ``repro.models.config`` (the port imports nothing of ``repro``);
the fields, defaults and ``param_count`` are the same.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int = 0                # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    use_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden (d_ff of each expert)
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    # hybrid (zamba2-style): Mamba2 layers + one shared attention block
    attn_every: int = 0              # apply shared attn block after every k layers
    ssm_state: int = 0               # Mamba2 N
    ssm_head_dim: int = 64           # Mamba2 P
    ssm_expand: int = 2              # d_inner = expand * d_model
    conv_width: int = 4              # depthwise causal conv (MEC conv1d kernel)

    # ssm (xLSTM): mLSTM blocks with sLSTM every slstm_every layers
    slstm_every: int = 0

    # audio (whisper): encoder-decoder
    encoder_layers: int = 0
    encoder_len: int = 1500          # stub frame-embedding length

    # vlm (llava): patch-embedding prefix (stub)
    prefix_len: int = 0

    max_seq: int = 8192
    dtype: str = "bfloat16"
    remat: bool = True
    # remat policy: "full" recomputes everything; "dots" saves matmul
    # outputs (skips re-running dots AND their TP collectives in the
    # recompute pass, at the cost of saved-activation memory)
    remat_policy: str = "full"
    # Megatron-style sequence parallelism: residual stream is seq-sharded
    # over the model axis between attention and FFN/MoE (RS+AG replaces AR)
    seq_parallel: bool = False
    # MoE execution: 'ep' = shard_map expert parallel (needs mesh), 'local'
    moe_impl: str = "local"
    # int8-quantized EP all_to_all (2x fewer dispatch/combine bytes)
    moe_dispatch_int8: bool = False
    # conv1d dataflow inside SSM blocks: "lowered" materializes the MEC
    # compact L (paper-faithful Algorithm 2 data movement); "fused" is the
    # shift-add dataflow of the fused Pallas kernel (no L at all)
    conv_impl: str = "lowered"
    # int8 KV cache (per token x head scales): ~1.9x less decode HBM
    kv_cache_int8: bool = False
    # int8 error-feedback DP gradient reduction (partial-manual shard_map;
    # not yet composable with moe_impl='ep')
    grad_compress_int8: bool = False
    # causal attention visits only lower-triangle chunk pairs (half the
    # score FLOPs; exact)
    attn_skip_masked: bool = False

    # attention chunking (memory-efficient streaming attention)
    q_chunk: int = 512
    kv_chunk: int = 1024

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    # Parameter counts (for MODEL_FLOPS = 6*N*D roofline term)
    # ------------------------------------------------------------------
    def param_count(self, active_only: bool = False) -> int:
        d, h = self.d_model, self.head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        attn = d * h * (n_q + 2 * n_kv) + n_q * h * d
        dense_ffn = 3 * d * self.d_ff if self.d_ff else 0
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "vlm"):
            return self.n_layers * (attn + dense_ffn) + emb
        if self.family == "moe":
            e = self.top_k if active_only else self.n_experts
            moe_ffn = 3 * d * self.moe_d_ff * e + d * self.n_experts  # + router
            shared = 3 * d * self.moe_d_ff * self.n_shared_experts
            return self.n_layers * (attn + moe_ffn + shared) + emb
        if self.family == "hybrid":
            d_in = self.ssm_expand * d
            n_h = d_in // self.ssm_head_dim
            mamba = (d * (2 * d_in + 2 * self.ssm_state + n_h)  # in_proj
                     + self.conv_width * (d_in + 2 * self.ssm_state)
                     + d_in * d)                                  # out_proj
            n_attn_apps = self.n_layers // max(1, self.attn_every)
            shared_blk = attn + dense_ffn                          # shared weights
            return self.n_layers * mamba + shared_blk + emb
        if self.family == "ssm":  # xLSTM
            d_in = 2 * d
            mlstm = d * 2 * d_in + 3 * d_in * h * n_q // max(n_q, 1) + d_in * d
            mlstm = 2 * d * d_in + 3 * d_in * d_in + d_in * d      # approx
            return self.n_layers * mlstm + emb
        if self.family == "audio":
            enc = self.encoder_layers * (attn + dense_ffn)
            dec = self.n_layers * (2 * attn + dense_ffn)           # self + cross
            return enc + dec + emb
        raise ValueError(self.family)
