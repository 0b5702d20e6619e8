"""Language-model assembly (counterpart of ``repro.models.lm``).

All six families are ported, for serving (``models.serve``) and training
(:meth:`LM.forward`):
  dense   a GQA transformer: stacked blocks of attention and SwiGLU;
  vlm     llava: the dense backbone, with a ``vision_proj`` linear that
          maps vision tokens into the prompt's prefix;
  moe     the GQA transformer with a mixture-of-experts FFN
          (``models.moe``: local dispatch, expert parallel under rules);
  hybrid  zamba2: Mamba2 layers and ONE shared attention+SwiGLU block
          applied after every ``attn_every`` layers (weight sharing); or,
          with ``cfg.hybrid_layer_ids`` (``HybridConfig``), the published
          Zamba2 block (:func:`hybrid_plan`, :func:`hybrid_block`);
  ssm     xLSTM: super-blocks of ``slstm_every - 1`` mLSTM blocks and one
          sLSTM block (``models.xlstm``);
  audio   whisper: an encoder over frame embeddings (non-causal attention
          and a GELU MLP) and a decoder with causal self-attention and
          cross-attention to the encoder output.

Parameters are nested dicts of tensors with the JAX package's tree and
layer-stacked leaves: the dense, vlm and moe blocks are stacked (layers,
...), the Mamba2 layers of the super-blocks (n_super, attn_every, ...) and
the tail (tail, ...); the published Zamba2 block's Mamba2 layers
(n_layers, ...), shared blocks (n_mem_blocks, ...) and hybrid layers'
LoRA and linear (hybrid layers, ...); the xLSTM super-blocks' mLSTM
blocks (n_super, slstm_every - 1, ...) and sLSTM blocks (n_super, ...), so
``convert.params_from_jax`` maps leaf for leaf.  The JAX package's
``lax.scan`` over the stack becomes a Python loop over its leading axes;
a layer's parameters are views into the stacked leaves, each leaf split
once a forward (:func:`layer_trees`), so gradients reach them and are
stacked once.  ``cfg.remat`` wraps each block in
``torch.utils.checkpoint`` (non-reentrant); the ``"dots"`` policy keeps
the matmul outputs and recomputes the rest, the JAX package's
``checkpoint_dots``.  The audio family's encoder and decoder blocks are
stacked (layers, ...).

Under rules over a "model" axis (``parallel.tensor``) every family runs
tensor parallel: ``LM.init(mesh=)`` gives each rank its slices, and the
blocks read the axis from the installed rules (Megatron-style layers,
``cfg.seq_parallel`` as Megatron-SP in the dense and moe blocks).
"""
from __future__ import annotations

import functools
import itertools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as torch_checkpoint

from repro_torch import obs
from repro_torch.models import mamba2, moe, xlstm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (attention_block, attention_local,
                                       init_attention, init_linear,
                                       init_normal, init_swiglu, linear,
                                       rms_norm, swiglu)
from repro_torch.parallel import tensor
from repro_torch.parallel.axes import constrain, current_rules, use_rules

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


#: the aten products the ``"dots"`` remat policy keeps
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def tree_map(fn: Callable, tree):
    """``fn`` on every tensor of a tree of dicts (None leaves stay)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def tree_at(tree, idx: Tuple[int, ...]):
    """The tree of the layer at ``idx`` of stacked leaves (views)."""
    return tree_map(lambda t: t[idx], tree)


def layer_trees(tree, prefix: Tuple[int, ...]) -> list:
    """The trees of every layer of stacked leaves over the leading axes
    ``prefix``, in index order: each leaf split once (``unbind``), so a
    backward stacks the layers' gradients once.  A view ``t[idx]`` a layer
    instead makes, in its backward, a zero tensor of the whole stack for
    that layer's gradient, which autograd adds into the stack's gradient:
    layers x stack bytes where the JAX package's scan moves the stack."""
    n = math.prod(prefix)
    parts = tree_map(lambda t: t.reshape((n,) + tuple(t.shape[len(prefix):]))
                     .unbind(0), tree)
    return [tree_map(lambda p, k=k: p[k], parts) for k in range(n)]


def tree_set(tree, idx: Tuple[int, ...], value) -> None:
    """Write a layer's tree into slot ``idx`` of stacked leaves."""
    if isinstance(tree, dict):
        for k in tree:
            tree_set(tree[k], idx, value[k])
    else:
        tree[idx].copy_(value)


def stack_init(init_fn: Callable[[], Any], prefix: Tuple[int, ...],
               local: Optional[Callable] = None):
    """Stacked leaves of ``prod(prefix)`` layers, each drawn by ``init_fn``
    in index order and written into its slot, so at most one layer's
    draws are alive beside the stack; ``local`` (a rank's slicer of a
    layer's tree) is applied to each layer first."""
    out = None
    for idx in itertools.product(*map(range, prefix)):
        layer = init_fn()
        if local is not None:
            layer = local(layer)
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


def _sp(cfg, x, ffn_tp):
    """(tp, whether Megatron-SP runs) for a block over ``x`` whose FFN
    runs over ``ffn_tp`` (None: whole on every rank, and then no SP)."""
    tp = tensor.context()
    return tp, ffn_tp is not None and tensor.sp_active(cfg, tp, x.shape[1])


def dense_block(p, cfg, x, positions):
    """Attention and the SwiGLU, each a residual.  Under tensor
    parallelism each is column-parallel in and row-parallel out; with
    ``cfg.seq_parallel`` (Megatron-SP) the attention's output is
    reduce-scattered over the sequence, the residual and ``norm2`` run on
    the rank's rows, the MLP's input is all-gathered and its output
    reduce-scattered, and the block's output is all-gathered: the JAX
    package's sequence-sharded ``seq_tp`` segment written out."""
    mlp_tp = tensor.if_divides(tensor.context(), cfg.d_ff)
    tp, sp = _sp(cfg, x, mlp_tp)
    a, kv = attention_block(p["attn"], cfg,
                            rms_norm(x, p["norm1"], cfg.norm_eps), positions,
                            sp=sp)
    if sp:
        x = tensor.shard_seq(x, tp) + a
        f = swiglu(rms_norm(x, tensor.rep_part(p["norm2"], tp),
                            cfg.norm_eps), p["mlp"], mlp_tp, sp=True)
        return tensor.gather_rep(x + f, tp), kv
    seg = "seq_tp" if cfg.seq_parallel else "seq"
    x = constrain(x + a, "batch", seg, "embed")
    f = swiglu(rms_norm(x, p["norm2"], cfg.norm_eps), p["mlp"], mlp_tp)
    return constrain(x + f, "batch", "seq", "embed"), kv


def init_moe_block(generator: torch.Generator, cfg, dtype, device="cuda",
                   prefix: Tuple[int, ...] = (), tp=(1, 0)) -> dict:
    """A moe block's tree, every leaf stacked over ``prefix`` (the layers):
    the attention of each layer drawn and written into its slot, the expert
    weights drawn in chunks (``models.moe.init_moe``), so no layer's f32
    draws sit beside the whole stack.  ``tp`` (axis size, rank): the
    rank's slices, as ``LM.init`` with a mesh."""
    n, rank = tp
    ones = torch.ones(prefix + (cfg.d_model,), dtype=dtype, device=device)
    cut = None if n == 1 else (lambda tree: tensor.shard_params(
        tree, n, cfg, rank, ("blocks", "attn")))
    return {
        "norm1": ones,
        "attn": stack_init(lambda: init_attention(generator, cfg, dtype,
                                                  device=device), prefix,
                           cut),
        "norm2": ones.clone(),
        "moe": moe.init_moe(generator, cfg, dtype, device=device,
                            prefix=prefix, tp=tp),
    }


def moe_block(p, cfg, x, positions):
    """-> (x, (k, v), aux); Megatron-SP as :func:`dense_block`, the MoE
    FFN then on the rank's rows (where it runs expert-parallel)."""
    tp, sp = _sp(cfg, x, moe.ep_context(cfg))
    a, kv = attention_block(p["attn"], cfg,
                            rms_norm(x, p["norm1"], cfg.norm_eps), positions,
                            sp=sp)
    if sp:
        x = tensor.shard_seq(x, tp) + a
        f, aux = moe.moe_ffn(p["moe"], cfg, rms_norm(
            x, tensor.rep_part(p["norm2"], tp), cfg.norm_eps), sp=True)
        return tensor.gather_rep(x + f, tp), kv, aux
    seg = "seq_tp" if cfg.seq_parallel else "seq"
    x = constrain(x + a, "batch", seg, "embed")
    f, aux = moe.moe_ffn(p["moe"], cfg, rms_norm(x, p["norm2"], cfg.norm_eps))
    return constrain(x + f, "batch", "seq", "embed"), kv, aux


def _save_dots(ctx, op, *args, **kwargs):  # lint-ignore: accepted-kwarg-not-forwarded (torch.utils.checkpoint's policy signature)
    return (torch_checkpoint.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(fn: Callable, cfg) -> Callable:
    """``fn`` under non-reentrant activation checkpointing when
    ``cfg.remat`` and autograd records: ``"dots"`` keeps the matmul
    outputs (selective checkpointing), anything else recomputes the whole
    block."""
    if not cfg.remat:
        return fn
    kw = {"use_reentrant": False}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts, _save_dots)

    def remat(*args):
        # without autograd (serving) there is nothing to recompute
        if not torch.is_grad_enabled():
            return fn(*args)
        # the recompute runs in the backward, on the autograd engine's
        # device thread on CUDA, which does not see this thread's rules:
        # it runs under the rules of the forward
        rules = current_rules()

        def under_rules(*a):
            with use_rules(rules):
                return fn(*a)
        return torch_checkpoint.checkpoint(under_rules, *args, **kw)
    return remat


def init_gelu_mlp(generator: torch.Generator, d: int, f: int, dtype,
                  device="cuda") -> dict:
    return {"up": init_linear(generator, d, f, dtype, bias=True,
                              device=device),
            "down": init_linear(generator, f, d, dtype, bias=True,
                                device=device)}


def gelu_mlp(x: torch.Tensor, p: dict, tp=None) -> torch.Tensor:
    """up -> GELU in f32 (the tanh form, ``jax.nn.gelu``'s default) ->
    cast -> down.  Under ``tp`` (an axis that splits the hidden width)
    up is column-parallel (the rank's part of its replicated bias) and
    down row-parallel, all-reduced, then its bias added once."""
    if tp is None:
        up, down = p["up"], p["down"]
    else:
        up = {"w": p["up"]["w"], "b": tensor.rep_slice(p["up"]["b"], tp)}
        down = {"w": p["down"]["w"]}
    x = tensor.copy_to(x, tp)
    h = F.gelu(linear(x, up).to(torch.float32),
               approximate="tanh").to(x.dtype)
    h = constrain(h, "batch", "seq", "ffn")
    y = tensor.reduce_from(linear(h, down), tp)
    return y if tp is None else y + p["down"]["b"].to(y.dtype)


# ---------------------------------------------------------------------------
# the published Zamba2 hybrid block (Zyphra, arXiv:2411.15242; transformers'
# ``Zamba2HybridLayer``)
# ---------------------------------------------------------------------------

def hybrid_plan(cfg) -> list:
    """(Mamba2 layer, hybrid index or None) in order: the hybrid index k
    of a layer in ``cfg.hybrid_layer_ids``, whose shared block is
    k % ``cfg.n_mem_blocks``."""
    ids = {n: k for k, n in enumerate(cfg.hybrid_layer_ids)}
    return [(n, ids.get(n)) for n in range(cfg.n_layers)]


def init_shared_block(generator: torch.Generator, cfg, dtype,
                      device="cuda") -> dict:
    """A shared block: RMSNorm over its input (the hidden state and the
    embeddings, 2 d_model), attention from it, RMSNorm, the gated MLP
    (gate and up in one projection, d_model -> 2 d_ff)."""
    d, f = cfg.d_model, cfg.d_ff
    a_in = 2 * d
    return {"norm1": torch.ones((a_in,), dtype=dtype, device=device),
            "attn": init_attention(generator, cfg, dtype, device=device,
                                   d_in=a_in),
            "norm2": torch.ones((d,), dtype=dtype, device=device),
            "mlp": {"gate_up": init_linear(generator, d, 2 * f, dtype,
                                           device=device),
                    "down": init_linear(generator, f, d, dtype,
                                        device=device)}}


def init_hybrid_layer(generator: torch.Generator, cfg, dtype,
                      device="cuda") -> dict:
    """A hybrid layer's own weights: the linear on its shared block's
    output and, with ``cfg.adapter_rank``, the LoRA on the gate-up
    projection.  Both drawn N(0, 1/fan_in), not zero, so a seeded model
    that leaves them out gives other logits."""
    d = cfg.d_model
    p = {"linear": init_linear(generator, d, d, dtype, device=device)}
    if cfg.adapter_rank:
        p["lora_a"] = init_linear(generator, d, cfg.adapter_rank, dtype,
                                  device=device)
        p["lora_b"] = init_linear(generator, cfg.adapter_rank, 2 * cfg.d_ff,
                                  dtype, device=device)
    return p


def gated_mlp(x: torch.Tensor, p: dict, adapter: dict) -> torch.Tensor:
    """gate, up = x W_gu + (x A) B (the hybrid layer's LoRA); act(gate) in
    f32, cast, times up; down.  act: the exact GELU (Zamba2's
    ``hidden_act`` "gelu", the only one ``configs.archs.zamba2_config``
    takes)."""
    gu = linear(x, p["gate_up"])
    if "lora_a" in adapter:
        gu = gu + linear(linear(x, adapter["lora_a"]), adapter["lora_b"])
    gate, up = gu.chunk(2, dim=-1)
    h = F.gelu(gate.to(torch.float32)).to(x.dtype) * up
    return linear(h, p["down"])


def hybrid_block(p: dict, adapter: dict, cfg, h: torch.Tensor,
                 emb: torch.Tensor, attend: Callable, layer: int,
                 block: int):
    """What hybrid layer ``layer`` adds to its Mamba2 input: shared block
    ``block`` (its weights ``p``) over [h, emb], with no residual
    inside, through the layer's own linear
    (``adapter``).  ``attend(attention params, normed input)`` -> (output,
    k/v).  Returns (the addend, k/v); records the span
    ``lm.shared_block``, noting the layer and the block."""
    with obs.span("lm.shared_block") as sp:
        sp.set(layer=layer, block=block)
        x = torch.cat([h, emb], dim=-1)
        a, kv = attend(p["attn"], rms_norm(x, p["norm1"], cfg.norm_eps))
        f = gated_mlp(rms_norm(a, p["norm2"], cfg.norm_eps), p["mlp"],
                      adapter)
        return linear(f, adapter["linear"]), kv


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

class LM:
    """Functional model: params are plain dicts of tensors."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def init(self, generator: torch.Generator, device="cuda",
             mesh=None) -> Dict[str, Any]:
        """Parameters drawn from ``generator`` on its device, layer by
        layer, then moved to ``device``.  With ``mesh`` (a DeviceMesh with a
        "model" axis) each rank keeps its slice of every leaf
        (``parallel.tensor.local_placement``) as each layer is drawn, from
        the same stream as one rank draws, so no rank holds the whole
        tree: the rank's leaves equal ``tensor.shard_params`` of the
        one-rank init."""
        cfg = self.cfg
        dt = torch_dtype(cfg)
        n = 1 if mesh is None else tensor.tp_size(mesh)
        rank = 0 if mesh is None else tensor.model_rank(mesh)

        def local(*path):
            def cut(tree):
                return tensor.shard_params(tree, n, cfg, rank, path)
            return cut if n > 1 else None

        def whole(tree, *path):
            cut = local(*path)
            return tree if cut is None else cut(tree)

        params: Dict[str, Any] = {
            "emb": whole(init_normal(generator, (cfg.vocab, cfg.d_model),
                                     0.02, dt, device), "emb"),
            "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = whole(init_linear(
                generator, cfg.d_model, cfg.vocab, dt, device=device),
                "lm_head")
        if cfg.family in ("dense", "vlm"):
            params["blocks"] = stack_init(
                lambda: init_dense_block(generator, cfg, dt, device=device),
                (cfg.n_layers,), local("blocks"))
            if cfg.family == "vlm":
                params["vision_proj"] = whole(init_linear(
                    generator, cfg.d_model, cfg.d_model, dt, device=device),
                    "vision_proj")
            return params
        if cfg.family == "moe":
            params["blocks"] = init_moe_block(generator, cfg, dt, device,
                                              prefix=(cfg.n_layers,),
                                              tp=(n, rank))
            return params
        if cfg.family == "audio":
            params["enc_blocks"] = stack_init(
                lambda: self._init_enc_block(generator, dt, device),
                (cfg.encoder_layers,), local("enc_blocks"))
            params["dec_blocks"] = stack_init(
                lambda: self._init_dec_block(generator, dt, device),
                (cfg.n_layers,), local("dec_blocks"))
            params["enc_norm"] = torch.ones((cfg.d_model,), dtype=dt,
                                            device=device)
            return params
        if cfg.family == "ssm":
            n_super, k_m = cfg.n_layers // cfg.slstm_every, cfg.slstm_every - 1
            params["mlstm"] = stack_init(
                lambda: xlstm.init_mlstm(generator, cfg, dt, device=device),
                (n_super, k_m), local("mlstm"))
            params["slstm"] = stack_init(
                lambda: xlstm.init_slstm(generator, cfg, dt, device=device),
                (n_super,), local("slstm"))
            return params

        def layer():
            return mamba2.init_mamba(generator, cfg, dt, device=device)

        if cfg.hybrid_layer_ids:
            if n > 1:
                raise NotImplementedError(
                    "tensor parallelism of the published hybrid block")
            params["mamba"] = stack_init(layer, (cfg.n_layers,))
            params["shared"] = stack_init(
                lambda: init_shared_block(generator, cfg, dt, device),
                (cfg.n_mem_blocks,))
            params["hybrid"] = stack_init(
                lambda: init_hybrid_layer(generator, cfg, dt, device),
                (cfg.shared_apps,))
            params["mamba_norms"] = torch.ones((cfg.n_layers, cfg.d_model),
                                               dtype=dt, device=device)
            return params
        n_super, tail = divmod(cfg.n_layers, cfg.attn_every)

        params["mamba"] = stack_init(layer, (n_super, cfg.attn_every),
                                     local("mamba"))
        if tail:
            params["mamba_tail"] = stack_init(layer, (tail,),
                                              local("mamba_tail"))
        params["shared"] = whole(init_dense_block(generator, cfg, dt,
                                                  device=device), "shared")
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

    def vocab_tp(self):
        """The tensor-parallel axis where it splits the vocabulary (the
        embedding's rows and the head's columns), else None."""
        return tensor.if_divides(tensor.context(), self.cfg.vocab)

    def embed(self, params, tokens):
        """The lookup, over the vocab shards under tensor parallelism."""
        return constrain(tensor.embed(params["emb"], tokens, self.vocab_tp()),
                         "batch", "seq", "embed")

    def vision_tokens(self, params, vision):
        """``vision`` (B, P, d) through ``vision_proj``: column-parallel and
        all-gathered over the model axis where it splits."""
        tp = tensor.if_divides(tensor.context(), self.cfg.d_model)
        dt = torch_dtype(self.cfg)
        vis = linear(tensor.copy_to(vision.to(dt), tp), params["vision_proj"])
        return vis if tp is None else tensor.gather_rep(vis, tp, dim=-1)

    def head_weights(self, params):
        if self.cfg.tie_embeddings:
            return params["emb"].T
        return params["lm_head"]["w"]

    # ------------------------------------------------------------ train --
    def forward(self, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (final hidden (B, S, d), aux loss (0-d f32)).  Logits are
        produced by the (chunked) loss, so (B, S, V) is never formed.  The
        moe family's aux is the blocks' sum scaled by ``router_aux_coef /
        n_layers``; the vlm family's hidden is its text positions only."""
        cfg = self.cfg
        fam = cfg.family
        if fam == "audio":
            return self._forward_audio(params, batch)
        h = self.embed(params, batch["tokens"])
        if fam == "vlm":
            h = torch.cat([self.vision_tokens(params, batch["vision"]), h],
                          dim=1)
        positions = torch.arange(h.shape[1], device=h.device)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        if fam in ("dense", "vlm"):
            body = _maybe_remat(
                lambda p, x: dense_block(p, cfg, x, positions)[0], cfg)
            for p in layer_trees(params["blocks"], (cfg.n_layers,)):
                h = body(p, h)
        elif fam == "moe":
            def moe_body(p, x):
                x2, _, a = moe_block(p, cfg, x, positions)
                return x2, a
            body = _maybe_remat(moe_body, cfg)
            for p in layer_trees(params["blocks"], (cfg.n_layers,)):
                h, a = body(p, h)
                aux = aux + a
            aux = aux * cfg.router_aux_coef / cfg.n_layers
        elif fam == "hybrid" and cfg.hybrid_layer_ids:
            h = self._published_hybrid_stack(params, h, positions)
        elif fam == "hybrid":
            h = self._hybrid_stack(params, h, positions)
        elif fam == "ssm":
            h = self._ssm_stack(params, h)
        else:
            raise ValueError(fam)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        if fam == "vlm":   # loss only over text positions
            h = h[:, batch["vision"].shape[1]:, :]
        return h, aux

    def _hybrid_stack(self, params, h, positions):
        """Super-blocks of ``attn_every`` Mamba2 layers (each normed by its
        row of ``mamba_norms``) and the shared attention+SwiGLU block, then
        the tail layers."""
        cfg = self.cfg
        n_super, tail = divmod(cfg.n_layers, cfg.attn_every)
        seg = "seq_tp" if cfg.seq_parallel else "seq"
        mamba_body = _maybe_remat(
            lambda p, nrm, x: constrain(x + mamba2.mamba_forward(
                p, cfg, rms_norm(x, nrm, cfg.norm_eps)), "batch", seg,
                "embed"), cfg)
        norms = params["mamba_norms"].unbind(0)
        layers = layer_trees(params["mamba"], (n_super, cfg.attn_every))
        if tail:
            layers += layer_trees(params["mamba_tail"], (tail,))
        for i in range(n_super):
            for j in range(cfg.attn_every):
                n = i * cfg.attn_every + j
                h = mamba_body(layers[n], norms[n], h)
            h, _ = dense_block(params["shared"], cfg, h, positions)
        for n in range(n_super * cfg.attn_every, cfg.n_layers):
            h = mamba_body(layers[n], norms[n], h)
        return h

    def _published_hybrid_stack(self, params, h, positions):
        """Each Mamba2 layer n adds mamba(norm_n(h + t)) to h, where t is
        what the hybrid layer adds (:func:`hybrid_block`), or 0: the
        residual carries h without t."""
        cfg = self.cfg
        emb = h
        layers = layer_trees(params["mamba"], (cfg.n_layers,))
        shared = layer_trees(params["shared"], (cfg.n_mem_blocks,))
        adapters = layer_trees(params["hybrid"], (cfg.shared_apps,))
        norms = params["mamba_norms"].unbind(0)

        def attend(p, x):
            return attention_block(p, cfg, x, positions)
        for n, k in hybrid_plan(cfg):
            x = h
            if k is not None:
                b = k % cfg.n_mem_blocks
                t, _ = hybrid_block(shared[b], adapters[k], cfg, h, emb,
                                    attend, n, b)
                x = h + t
            h = h + mamba2.mamba_forward(
                layers[n], cfg, rms_norm(x, norms[n], cfg.norm_eps))
        return h

    def _ssm_stack(self, params, h):
        """Super-blocks of ``slstm_every - 1`` mLSTM blocks and one sLSTM
        block, each a residual."""
        cfg = self.cfg
        m_body = _maybe_remat(
            lambda p, x: x + xlstm.mlstm_forward(p, cfg, x), cfg)
        s_body = _maybe_remat(
            lambda p, x: x + xlstm.slstm_forward(p, cfg, x), cfg)
        n_super, k_m = params["mlstm"]["up"]["w"].shape[:2]
        mlstm = layer_trees(params["mlstm"], (n_super, k_m))
        for i, p in enumerate(layer_trees(params["slstm"], (n_super,))):
            for j in range(k_m):
                h = m_body(mlstm[i * k_m + j], h)
            h = s_body(p, h)
        return h

    def _forward_audio(self, params, batch):
        cfg = self.cfg
        enc = self.encode(params, batch["frames"])
        h = self.embed(params, batch["tokens"])
        positions = torch.arange(h.shape[1], device=h.device)
        body = _maybe_remat(
            lambda p, x, e: self._dec_block(p, x, positions, e)[0], cfg)
        for p in layer_trees(params["dec_blocks"], (cfg.n_layers,)):
            h = body(p, h, enc)
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        return h, torch.zeros((), dtype=torch.float32, device=h.device)

    # ------------------------------------------------------------- audio --
    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """The whisper encoder over frame embeddings (B, T, d): non-causal
        attention and the GELU MLP a block, then the encoder norm."""
        cfg = self.cfg
        h = frames.to(torch_dtype(cfg))
        positions = torch.arange(h.shape[1], device=h.device)

        def enc_body(p, x):
            a, _ = attention_block(p["attn"], cfg,
                                   rms_norm(x, p["norm1"], cfg.norm_eps),
                                   positions, causal=False)
            x = x + a
            return x + gelu_mlp(rms_norm(x, p["norm2"], cfg.norm_eps),
                                p["mlp"], self._mlp_tp())
        body = _maybe_remat(enc_body, cfg)
        for p in layer_trees(params["enc_blocks"], (cfg.encoder_layers,)):
            h = body(p, h)
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
        x = x + gelu_mlp(rms_norm(x, p["norm2"], cfg.norm_eps), p["mlp"],
                         self._mlp_tp())
        return x, kv

    def _mlp_tp(self):
        return tensor.if_divides(tensor.context(), self.cfg.d_ff)

    def _cross_kv(self, p, enc):
        """The cross-attention k/v of ``enc`` (the rank's kv heads under
        tensor parallelism)."""
        cfg = self.cfg
        tp = tensor.attn_tp(cfg)
        lp = attention_local(p["xattn"], cfg, tp)
        enc = tensor.copy_to(enc, tp)
        b, t, _ = enc.shape
        k = linear(enc, lp["wk"]).reshape(b, t, -1, cfg.head_dim)
        v = linear(enc, lp["wv"]).reshape(b, t, -1, cfg.head_dim)
        return k, v
