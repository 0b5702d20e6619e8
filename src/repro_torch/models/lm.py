"""Language-model assembly (counterpart of ``repro.models.lm``).

Five families are ported, for serving (``models.serve``):
  dense   a GQA transformer: stacked blocks of attention and SwiGLU;
  vlm     llava: the dense backbone, with a ``vision_proj`` linear that
          maps vision tokens into the prompt's prefix;
  hybrid  zamba2: Mamba2 layers and ONE shared attention+SwiGLU block
          applied after every ``attn_every`` layers (weight sharing);
  ssm     xLSTM: super-blocks of ``slstm_every - 1`` mLSTM blocks and one
          sLSTM block (``models.xlstm``);
  audio   whisper: an encoder over frame embeddings (non-causal attention
          and a GELU MLP) and a decoder with causal self-attention and
          cross-attention to the encoder output.
The moe family and the training path (``forward``) raise
``NotImplementedError`` naming their ROADMAP item.

Parameters are nested dicts of tensors with the JAX package's tree and
layer-stacked leaves: the dense and vlm blocks are stacked (layers, ...),
the Mamba2 layers of the super-blocks (n_super, attn_every, ...) and the
tail (tail, ...), the xLSTM super-blocks' mLSTM blocks (n_super,
slstm_every - 1, ...) and sLSTM blocks (n_super, ...), so
``convert.params_from_jax`` maps leaf for leaf.  The
JAX package's ``lax.scan`` over the stack becomes a Python loop over its
leading axes.  The audio family's encoder and decoder blocks are stacked
(layers, ...).
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import mamba2, xlstm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (attention_block,
                                       init_attention, init_linear,
                                       init_normal, init_swiglu, linear,
                                       rms_norm, swiglu)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


#: the families this package serves
PORTED_FAMILIES = ("hybrid", "audio", "dense", "vlm", "ssm")
#: the ROADMAP items that port the rest
UNPORTED_ITEMS = {"moe": "ROADMAP Queue 1 item 10.3"}
TRAINING_ITEM = "ROADMAP Queue 1 item 10.6"


def require_ported(cfg, what: str) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"{what} of the {cfg.family!r} family "
                                  f"({cfg.name}): "
                                  f"{UNPORTED_ITEMS[cfg.family]}")


def tree_map(fn: Callable, tree):
    """``fn`` on every tensor of a tree of dicts (None leaves stay)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def tree_at(tree, idx: Tuple[int, ...]):
    """The tree of the layer at ``idx`` of stacked leaves (views)."""
    return tree_map(lambda t: t[idx], tree)


def tree_set(tree, idx: Tuple[int, ...], value) -> None:
    """Write a layer's tree into slot ``idx`` of stacked leaves."""
    if isinstance(tree, dict):
        for k in tree:
            tree_set(tree[k], idx, value[k])
    else:
        tree[idx].copy_(value)


def stack_init(init_fn: Callable[[], Any], prefix: Tuple[int, ...]):
    """Stacked leaves of ``prod(prefix)`` layers, each drawn by ``init_fn``
    in index order and written into its slot, so at most one layer's
    draws are alive beside the stack."""
    out = None
    for idx in itertools.product(*map(range, prefix)):
        layer = init_fn()
        if out is None:
            out = tree_map(lambda t: torch.empty(prefix + tuple(t.shape),
                                                 dtype=t.dtype,
                                                 device=t.device), layer)
        tree_set(out, idx, layer)
    return out


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def init_dense_block(generator: torch.Generator, cfg, dtype,
                     device="cuda") -> dict:
    return {
        "norm1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "attn": init_attention(generator, cfg, dtype, device=device),
        "norm2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "mlp": init_swiglu(generator, cfg.d_model, cfg.d_ff, dtype,
                           device=device),
    }


def dense_block(p, cfg, x, positions):
    a, kv = attention_block(p["attn"], cfg,
                            rms_norm(x, p["norm1"], cfg.norm_eps), positions)
    x = x + a
    f = swiglu(rms_norm(x, p["norm2"], cfg.norm_eps), p["mlp"])
    return x + f, kv


def init_gelu_mlp(generator: torch.Generator, d: int, f: int, dtype,
                  device="cuda") -> dict:
    return {"up": init_linear(generator, d, f, dtype, bias=True,
                              device=device),
            "down": init_linear(generator, f, d, dtype, bias=True,
                                device=device)}


def gelu_mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    """up -> GELU in f32 (the tanh form, ``jax.nn.gelu``'s default) ->
    cast -> down."""
    h = F.gelu(linear(x, p["up"]).to(torch.float32),
               approximate="tanh").to(x.dtype)
    return linear(h, p["down"])


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

class LM:
    """Functional model: params are plain dicts of tensors."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def init(self, generator: torch.Generator, device="cuda") -> Dict[str, Any]:
        """Parameters drawn from ``generator`` on its device, layer by
        layer, then moved to ``device``."""
        cfg = self.cfg
        require_ported(cfg, "LM.init")
        dt = torch_dtype(cfg)
        params: Dict[str, Any] = {
            "emb": init_normal(generator, (cfg.vocab, cfg.d_model), 0.02, dt,
                               device),
            "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = init_linear(generator, cfg.d_model, cfg.vocab,
                                            dt, device=device)
        if cfg.family in ("dense", "vlm"):
            params["blocks"] = stack_init(
                lambda: init_dense_block(generator, cfg, dt, device=device),
                (cfg.n_layers,))
            if cfg.family == "vlm":
                params["vision_proj"] = init_linear(generator, cfg.d_model,
                                                    cfg.d_model, dt,
                                                    device=device)
            return params
        if cfg.family == "audio":
            params["enc_blocks"] = stack_init(
                lambda: self._init_enc_block(generator, dt, device),
                (cfg.encoder_layers,))
            params["dec_blocks"] = stack_init(
                lambda: self._init_dec_block(generator, dt, device),
                (cfg.n_layers,))
            params["enc_norm"] = torch.ones((cfg.d_model,), dtype=dt,
                                            device=device)
            return params
        if cfg.family == "ssm":
            n_super, k_m = cfg.n_layers // cfg.slstm_every, cfg.slstm_every - 1
            params["mlstm"] = stack_init(
                lambda: xlstm.init_mlstm(generator, cfg, dt, device=device),
                (n_super, k_m))
            params["slstm"] = stack_init(
                lambda: xlstm.init_slstm(generator, cfg, dt, device=device),
                (n_super,))
            return params
        n_super, tail = divmod(cfg.n_layers, cfg.attn_every)

        def layer():
            return mamba2.init_mamba(generator, cfg, dt, device=device)

        params["mamba"] = stack_init(layer, (n_super, cfg.attn_every))
        if tail:
            params["mamba_tail"] = stack_init(layer, (tail,))
        params["shared"] = init_dense_block(generator, cfg, dt, device=device)
        params["mamba_norms"] = torch.ones((cfg.n_layers, cfg.d_model),
                                           dtype=dt, device=device)
        return params

    def _init_enc_block(self, generator, dt, device) -> dict:
        cfg = self.cfg
        return {"norm1": torch.ones((cfg.d_model,), dtype=dt, device=device),
                "attn": init_attention(generator, cfg, dt, device=device),
                "norm2": torch.ones((cfg.d_model,), dtype=dt, device=device),
                "mlp": init_gelu_mlp(generator, cfg.d_model, cfg.d_ff, dt,
                                     device=device)}

    def _init_dec_block(self, generator, dt, device) -> dict:
        cfg = self.cfg
        return {"norm1": torch.ones((cfg.d_model,), dtype=dt, device=device),
                "attn": init_attention(generator, cfg, dt, device=device),
                "norm_x": torch.ones((cfg.d_model,), dtype=dt, device=device),
                "xattn": init_attention(generator, cfg, dt, device=device),
                "norm2": torch.ones((cfg.d_model,), dtype=dt, device=device),
                "mlp": init_gelu_mlp(generator, cfg.d_model, cfg.d_ff, dt,
                                     device=device)}

    def embed(self, params, tokens):
        return params["emb"][tokens]

    def head_weights(self, params):
        if self.cfg.tie_embeddings:
            return params["emb"].T
        return params["lm_head"]["w"]

    def forward(self, params, batch):
        raise NotImplementedError(f"LM training (forward): {TRAINING_ITEM}")

    # ------------------------------------------------------------- audio --
    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """The whisper encoder over frame embeddings (B, T, d): non-causal
        attention and the GELU MLP a block, then the encoder norm."""
        cfg = self.cfg
        h = frames.to(torch_dtype(cfg))
        positions = torch.arange(h.shape[1], device=h.device)
        for i in range(cfg.encoder_layers):
            p = tree_at(params["enc_blocks"], (i,))
            a, _ = attention_block(p["attn"], cfg,
                                   rms_norm(h, p["norm1"], cfg.norm_eps),
                                   positions, causal=False)
            h = h + a
            h = h + gelu_mlp(rms_norm(h, p["norm2"], cfg.norm_eps), p["mlp"])
        return rms_norm(h, params["enc_norm"], cfg.norm_eps)

    def _dec_block(self, p, x, positions, enc, cross_kv=None):
        """One decoder block over the prompt: causal self-attention, cross-
        attention to ``enc`` (its k/v ``cross_kv`` when the caller has them,
        else :meth:`_cross_kv`), the GELU MLP.  Returns (x, self k/v).  The
        JAX package's unused ``self_kv`` slot is left out."""
        cfg = self.cfg
        a, kv = attention_block(p["attn"], cfg,
                                rms_norm(x, p["norm1"], cfg.norm_eps),
                                positions)
        x = x + a
        xa, _ = attention_block(
            p["xattn"], cfg, rms_norm(x, p["norm_x"], cfg.norm_eps),
            positions, causal=False, use_rope=False,
            kv_override=cross_kv if cross_kv is not None
            else self._cross_kv(p, enc))
        x = x + xa
        x = x + gelu_mlp(rms_norm(x, p["norm2"], cfg.norm_eps), p["mlp"])
        return x, kv

    def _cross_kv(self, p, enc):
        cfg = self.cfg
        b, t, _ = enc.shape
        k = linear(enc, p["xattn"]["wk"]).reshape(b, t, cfg.n_kv_heads,
                                                  cfg.head_dim)
        v = linear(enc, p["xattn"]["wv"]).reshape(b, t, cfg.n_kv_heads,
                                                  cfg.head_dim)
        return k, v
