"""Model configuration schema covering every assigned architecture family:
dense / moe / hybrid (Mamba2+shared-attn) / ssm (xLSTM) / vlm / audio.

A copy of ``repro.models.config`` (the port imports nothing of ``repro``);
the fields, defaults and ``param_count`` are the same.
:class:`HybridConfig` adds the settings of the published Zamba2 block
(Zyphra, arXiv:2411.15242), which the JAX package does not have: every
``ModelConfig`` reads them as class attributes with the behaviour of the
fields above, so its ``dataclasses.asdict`` stays the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


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

    # The published Zamba2 block's settings, set by :class:`HybridConfig`;
    # here, class attributes (no annotation, so not fields) with the
    # behaviour of the fields above.
    #: Mamba2 layers fed by a shared block (empty: ``attn_every`` stacking)
    hybrid_layer_ids = ()
    #: shared blocks, used in turn by the hybrid layers
    n_mem_blocks = 1
    #: rank of each hybrid layer's LoRA on the shared MLP's gate-up (0: none)
    adapter_rank = 0
    #: attention's score scale (0: head_dim ** -0.5)
    attn_scale = 0.0
    #: Mamba2 B/C groups: head h reads group h // (heads / groups), and the
    #: gated RMSNorm runs over each group's d_in / groups channels
    ssm_groups = 1
    #: a bias on the Mamba2 depthwise conv
    conv_bias = False
    #: the SSD scan's chunk
    ssm_chunk = 128
    #: (time_step_min, time_step_max, time_step_floor) the dt biases are
    #: drawn from, and A = -(1..heads) (empty: dt bias -2, A = -1)
    dt_init = ()

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def shared_apps(self) -> int:
        """Applications of the shared block(s) in a hybrid forward."""
        return (len(self.hybrid_layer_ids)
                or self.n_layers // max(1, self.attn_every))

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
            bc = 2 * self.ssm_groups * self.ssm_state
            mamba = (d * (2 * d_in + bc + n_h)                    # in_proj
                     + (self.conv_width + self.conv_bias) * (d_in + bc)
                     + d_in * d)                                  # out_proj
            if not self.hybrid_layer_ids:
                shared_blk = attn + dense_ffn                      # shared weights
                return self.n_layers * mamba + shared_blk + emb
            # the shared block reads the hidden state and the embeddings
            attn = 2 * d * h * (n_q + 2 * n_kv) + n_q * h * d
            per_app = (self.adapter_rank * (d + 2 * self.d_ff)     # LoRA
                       + d * d)                                    # linear
            return (self.n_layers * mamba
                    + self.n_mem_blocks * (attn + dense_ffn)
                    + self.shared_apps * per_app + emb)
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


@dataclasses.dataclass(frozen=True)
class HybridConfig(ModelConfig):
    """A hybrid config with the published Zamba2 block's settings as
    fields (their meanings and defaults are :class:`ModelConfig`'s)."""
    hybrid_layer_ids: Tuple[int, ...] = ModelConfig.hybrid_layer_ids
    n_mem_blocks: int = ModelConfig.n_mem_blocks
    adapter_rank: int = ModelConfig.adapter_rank
    attn_scale: float = ModelConfig.attn_scale
    ssm_groups: int = ModelConfig.ssm_groups
    conv_bias: bool = ModelConfig.conv_bias
    ssm_chunk: int = ModelConfig.ssm_chunk
    dt_init: Tuple[float, ...] = ModelConfig.dt_init
