"""The 10 assigned architectures (exact configs from the assignment) and
reduced smoke variants of each family.

Sources (verification tier in brackets, per assignment):
qwen3-4b [hf], phi3-medium-14b [arXiv:2404.14219], command-r-35b [hf],
yi-6b [arXiv:2403.04652], zamba2-7b [arXiv:2411.15242],
qwen3-moe-30b-a3b [hf], kimi-k2-1t-a32b [arXiv:2501.kimi2],
llava-next-34b [hf], xlstm-125m [arXiv:2405.04517],
whisper-tiny [arXiv:2212.04356].

A copy of ``repro.configs.archs``: the same ten entries and smoke variants.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig

MAX_SEQ = 32768 + 2048   # covers prefill_32k + decode headroom

ARCHS = {
    "qwen3-4b": ModelConfig(
        name="qwen3-4b", family="dense", n_layers=36, d_model=2560,
        n_heads=32, n_kv_heads=8, d_ff=9728, vocab=151936, head_dim=128,
        qk_norm=True, rope_theta=1e6, tie_embeddings=True, max_seq=MAX_SEQ),
    "phi3-medium-14b": ModelConfig(
        name="phi3-medium-14b", family="dense", n_layers=40, d_model=5120,
        n_heads=40, n_kv_heads=10, d_ff=17920, vocab=100352, head_dim=128,
        rope_theta=1e4, max_seq=MAX_SEQ),
    "command-r-35b": ModelConfig(
        name="command-r-35b", family="dense", n_layers=40, d_model=8192,
        n_heads=64, n_kv_heads=8, d_ff=22528, vocab=256000, head_dim=128,
        use_bias=False, tie_embeddings=True, rope_theta=8e6, max_seq=MAX_SEQ),
    "yi-6b": ModelConfig(
        name="yi-6b", family="dense", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=4, d_ff=11008, vocab=64000, head_dim=128,
        rope_theta=5e6, max_seq=MAX_SEQ),
    "zamba2-7b": ModelConfig(
        name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
        n_heads=32, n_kv_heads=32, d_ff=14336, vocab=32000, head_dim=112,
        attn_every=6, ssm_state=64, ssm_head_dim=64, ssm_expand=2,
        conv_width=4, max_seq=524288 + 64),
    "qwen3-moe-30b-a3b": ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe", n_layers=48, d_model=2048,
        n_heads=32, n_kv_heads=4, d_ff=768, vocab=151936, head_dim=128,
        qk_norm=True, n_experts=128, top_k=8, moe_d_ff=768,
        rope_theta=1e6, max_seq=MAX_SEQ, moe_impl="ep"),
    "kimi-k2-1t-a32b": ModelConfig(
        name="kimi-k2-1t-a32b", family="moe", n_layers=61, d_model=7168,
        n_heads=64, n_kv_heads=8, d_ff=2048, vocab=163840, head_dim=112,
        n_experts=384, top_k=8, moe_d_ff=2048, n_shared_experts=1,
        rope_theta=5e7, max_seq=MAX_SEQ, moe_impl="ep"),
    "llava-next-34b": ModelConfig(
        name="llava-next-34b", family="vlm", n_layers=60, d_model=7168,
        n_heads=56, n_kv_heads=8, d_ff=20480, vocab=64000, head_dim=128,
        prefix_len=2880, rope_theta=1e6, max_seq=MAX_SEQ),
    "xlstm-125m": ModelConfig(
        name="xlstm-125m", family="ssm", n_layers=12, d_model=768,
        n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304,
        slstm_every=4, conv_width=4, max_seq=524288 + 64),
    "whisper-tiny": ModelConfig(
        name="whisper-tiny", family="audio", n_layers=4, d_model=384,
        n_heads=6, n_kv_heads=6, d_ff=1536, vocab=51865, head_dim=64,
        encoder_layers=4, encoder_len=1500, max_seq=MAX_SEQ),
}


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (one fwd/train step)."""
    cfg = ARCHS[arch]
    common = dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                  vocab=256, max_seq=128, dtype="float32", remat=False,
                  q_chunk=16, kv_chunk=16)
    if cfg.family == "moe":
        return cfg.with_(**common, d_ff=96, moe_d_ff=96, n_experts=8,
                         top_k=2, head_dim=16, moe_impl="local",
                         capacity_factor=8.0)
    if cfg.family == "hybrid":
        common = dict(common, n_layers=5, n_kv_heads=4)
        return cfg.with_(**common, d_ff=96, attn_every=2, head_dim=16,
                         ssm_state=8, ssm_head_dim=8)
    if cfg.family == "ssm":
        return cfg.with_(**common, slstm_every=2, d_ff=0, head_dim=32)
    if cfg.family == "audio":
        common = dict(common, n_layers=2)
        return cfg.with_(**common, encoder_layers=2, d_ff=96, head_dim=16,
                         encoder_len=12)
    if cfg.family == "vlm":
        return cfg.with_(**common, d_ff=96, prefix_len=8, head_dim=16)
    return cfg.with_(**common, d_ff=96, head_dim=16)
