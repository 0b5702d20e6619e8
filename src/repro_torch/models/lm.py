"""Language-model assembly (counterpart of ``repro.models.lm``).

This slice ports the hybrid family (zamba2): Mamba2 layers and ONE shared
attention+SwiGLU block applied after every ``attn_every`` layers (weight
sharing), for serving (``models.serve``).  The dense, moe, ssm (xLSTM),
vlm and audio families, and the training path (``forward``), raise
``NotImplementedError`` naming their ROADMAP item.

Parameters are nested dicts of tensors with the JAX package's tree and
layer-stacked leaves: the Mamba2 layers of the super-blocks are stacked
(n_super, attn_every, ...) and the tail (tail, ...), so
``convert.params_from_jax`` maps leaf for leaf.  The JAX package's
``lax.scan`` over the stack becomes a Python loop over its leading axes.
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models import mamba2
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (QUEUE_1_ITEM_10, attention_block,
                                       init_attention, init_linear,
                                       init_normal, init_swiglu, rms_norm,
                                       swiglu)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def require_hybrid(cfg, what: str) -> None:
    if cfg.family != "hybrid":
        raise NotImplementedError(f"{what} of the {cfg.family!r} family "
                                  f"({cfg.name}): {QUEUE_1_ITEM_10}")


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
        require_hybrid(cfg, "LM.init")
        dt = torch_dtype(cfg)
        params: Dict[str, Any] = {
            "emb": init_normal(generator, (cfg.vocab, cfg.d_model), 0.02, dt,
                               device),
            "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = init_linear(generator, cfg.d_model, cfg.vocab,
                                            dt, device=device)
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

    def embed(self, params, tokens):
        return params["emb"][tokens]

    def head_weights(self, params):
        if self.cfg.tie_embeddings:
            return params["emb"].T
        return params["lm_head"]["w"]

    def forward(self, params, batch):
        raise NotImplementedError(f"LM training (forward): {QUEUE_1_ITEM_10}")
