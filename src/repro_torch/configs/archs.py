"""The 10 assigned architectures (exact configs from the assignment) and
reduced smoke variants of each family.

Sources (verification tier in brackets, per assignment):
qwen3-4b [hf], phi3-medium-14b [arXiv:2404.14219], command-r-35b [hf],
yi-6b [arXiv:2403.04652], zamba2-7b [arXiv:2411.15242],
qwen3-moe-30b-a3b [hf], kimi-k2-1t-a32b [arXiv:2501.kimi2],
llava-next-34b [hf], xlstm-125m [arXiv:2405.04517],
whisper-tiny [arXiv:2212.04356].

A copy of ``repro.configs.archs``: the same ten entries and smoke variants.
:data:`PUBLISHED` holds the architectures the port runs beyond them, at
their published settings: ``zamba2-7b-instruct``, the published Zamba2
hybrid block (:func:`zamba2_config` reads a Zamba2 ``config.json``).
"""
from __future__ import annotations

from repro_torch.models.config import HybridConfig, ModelConfig

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


#: Zyphra/Zamba2-7B-Instruct's config.json (huggingface.co), the keys that
#: give its shape
ZAMBA2_7B_INSTRUCT = {
    "num_hidden_layers": 81, "hidden_size": 3584, "vocab_size": 32000,
    "num_attention_heads": 32, "num_key_value_heads": 32,
    "attention_head_dim": 224, "attention_hidden_size": 7168,
    "intermediate_size": 14336, "hidden_act": "gelu", "rms_norm_eps": 1e-5,
    "rope_theta": 10000, "use_mem_rope": True, "use_long_context": False,
    "max_position_embeddings": 4096, "mamba_d_state": 64, "mamba_d_conv": 4,
    "mamba_expand": 2, "mamba_headdim": 64, "n_mamba_heads": 112,
    "mamba_ngroups": 2, "use_conv_bias": True, "chunk_size": 256,
    "time_step_min": 0.001, "time_step_max": 0.1, "time_step_floor": 0.0001,
    "time_step_limit": None, "add_bias_linear": False,
    "hybrid_layer_ids": [6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77],
    "num_mem_blocks": 2, "adapter_rank": 128, "use_shared_mlp_adapter": True,
    "use_shared_attention_adapter": False,
}


def zamba2_config(hf: dict, name: str, **overrides) -> HybridConfig:
    """The port's config of a Zamba2 ``config.json`` (its keys, as
    transformers' ``Zamba2Config`` reads them): the Mamba2 layers, the
    hybrid layer ids, the shared blocks used in turn, the concatenated
    attention input, the LoRA on the gelu-gated MLP's gate-up projection.
    ``tie_word_embeddings`` absent is true (``PretrainedConfig``'s
    default).  Serving in bf16 with K5 for the conv.  Raises on a setting
    the port does not run."""
    unsupported = {"use_shared_attention_adapter": True,
                   "use_long_context": True, "add_bias_linear": True,
                   "use_mem_rope": False}
    for key, value in unsupported.items():
        if hf.get(key) == value:
            raise NotImplementedError(f"Zamba2 with {key}={value}")
    if hf.get("time_step_limit") not in (None, [0.0, float("inf")]):
        raise NotImplementedError("Zamba2 with a time_step_limit")
    if hf["hidden_act"] != "gelu":
        raise NotImplementedError(f"Zamba2 with {hf['hidden_act']}")
    d_in = hf["mamba_expand"] * hf["hidden_size"]
    if d_in // hf["mamba_headdim"] != hf["n_mamba_heads"]:
        raise ValueError("n_mamba_heads is not d_inner / mamba_headdim")
    if hf["attention_hidden_size"] != 2 * hf["hidden_size"]:
        raise ValueError("attention_hidden_size is not 2 hidden_size")
    ids = hf.get("hybrid_layer_ids")
    if ids is None:
        ids = [i for i, t in enumerate(hf["layers_block_type"])
               if t == "hybrid"]
    fields = dict(
        name=name, family="hybrid", n_layers=hf["num_hidden_layers"],
        d_model=hf["hidden_size"], n_heads=hf["num_attention_heads"],
        n_kv_heads=hf["num_key_value_heads"], d_ff=hf["intermediate_size"],
        vocab=hf["vocab_size"], head_dim=hf["attention_head_dim"],
        rope_theta=float(hf["rope_theta"]),
        tie_embeddings=hf.get("tie_word_embeddings", True),
        norm_eps=hf["rms_norm_eps"], ssm_state=hf["mamba_d_state"],
        ssm_head_dim=hf["mamba_headdim"], ssm_expand=hf["mamba_expand"],
        conv_width=hf["mamba_d_conv"],
        max_seq=hf["max_position_embeddings"], conv_impl="fused",
        remat=False, hybrid_layer_ids=tuple(ids),
        n_mem_blocks=hf["num_mem_blocks"],
        adapter_rank=(hf["adapter_rank"] if hf["use_shared_mlp_adapter"]
                      else 0),
        attn_scale=(hf["attention_head_dim"] / 2) ** -0.5,
        ssm_groups=hf["mamba_ngroups"], conv_bias=hf["use_conv_bias"],
        ssm_chunk=hf["chunk_size"],
        dt_init=(hf["time_step_min"], hf["time_step_max"],
                 hf["time_step_floor"]))
    fields.update(overrides)
    return HybridConfig(**fields)


PUBLISHED = {
    "zamba2-7b-instruct": zamba2_config(ZAMBA2_7B_INSTRUCT,
                                        "zamba2-7b-instruct"),
}


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (one fwd/train step)."""
    if arch in PUBLISHED:
        # five layers, two hybrid ones (both shared blocks), two groups
        return zamba2_config(dict(
            ZAMBA2_7B_INSTRUCT, num_hidden_layers=5, hidden_size=64,
            hybrid_layer_ids=[1, 3], num_attention_heads=4,
            num_key_value_heads=4, attention_head_dim=32,
            attention_hidden_size=128, intermediate_size=96, n_mamba_heads=8,
            mamba_headdim=16, mamba_d_state=8, adapter_rank=8,
            vocab_size=256, chunk_size=8, max_position_embeddings=128),
            arch, dtype="float32", q_chunk=16, kv_chunk=16)
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
