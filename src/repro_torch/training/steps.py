"""Step builders (counterpart of ``repro.training.steps``): training and
serving (prefill / decode) on one device.

``make_train_step`` updates the parameters and the optimizer state in
place (``optim.adamw.update_``), the port's counterpart of the JAX
launcher's ``jax.jit(..., donate_argnums=(0, 1))``: a pure update holds
old and new parameters and moments together (22 bytes a parameter), in
place it is 12 (bf16 parameters and gradients, f32 moments).  The
arithmetic is the pure ``adamw.update``'s, so both give the same bits.
The int8-compressed data-parallel step and the sharding rules are
distributed execution: ``make_compressed_train_step``, a ``rules``
argument and ``init_opt_state(compressed=True)`` raise
``NotImplementedError`` naming ROADMAP Queue 1 item 11.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.models import serve
from repro_torch.models.lm import LM
from repro_torch.optim import adamw
from repro_torch.training.loss import chunked_softmax_xent

#: the ROADMAP item of the distributed steps
DIST_ITEM = "distributed execution, ROADMAP Queue 1 item 11"


def _no_rules(rules) -> None:
    if rules is not None:
        raise NotImplementedError(f"sharding rules: {DIST_ITEM}")


def make_loss_fn(model: LM) -> Callable:
    """``loss_fn(params, batch) -> (loss, metrics)``: the chunked
    cross-entropy of the final hidden against the head, plus the aux
    loss."""
    def loss_fn(params, batch):
        h, aux = model.forward(params, batch)
        loss, metrics = chunked_softmax_xent(
            h, model.head_weights(params), batch["labels"])
        return loss + aux, dict(metrics, aux=aux.detach())
    return loss_fn


def make_train_step(model: LM, opt_cfg: adamw.AdamWConfig,
                    rules=None) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss's gradient by autograd (the parameters require
    grad for the step only), then one AdamW step that writes the
    parameters and moments in place and returns the same trees.
    Metrics: ``loss``, ``nll``, ``tokens``, ``aux``, ``grad_norm``, ``lr``
    (0-d tensors on the device; reading them is the caller's sync)."""
    _no_rules(rules)
    loss_fn = make_loss_fn(model)

    def train_step(params, opt_state, batch):
        leaves = adamw.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        with torch.enable_grad():
            loss, metrics = loss_fn(params, batch)
            loss.backward()
        grads = adamw.tree_map(
            lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
            params)
        for p in leaves:
            p.grad = None
            p.requires_grad_(False)
        with torch.no_grad():
            om = adamw.update_(opt_cfg, grads, opt_state, params)
        del grads
        return params, opt_state, dict(metrics, loss=loss.detach(), **om)

    return train_step


def make_compressed_train_step(model: LM, opt_cfg: adamw.AdamWConfig,
                               rules=None):
    raise NotImplementedError(f"the int8-compressed data-parallel train "
                              f"step: {DIST_ITEM}")


def metrics_shape(model: LM):  # lint-ignore: accepted-kwarg-not-forwarded
    return {"nll": 0.0, "tokens": 0.0, "aux": 0.0}


def init_opt_state(params, compressed: bool = False) -> Dict:
    if compressed:
        raise NotImplementedError(f"error-feedback state for compressed "
                                  f"gradients: {DIST_ITEM}")
    return adamw.init(params)


def make_prefill_step(model: LM, max_len: int, rules=None) -> Callable:
    _no_rules(rules)

    def prefill_step(params, batch):
        return serve.prefill(model, params, batch, max_len)
    return prefill_step


def make_decode_step(model: LM, rules=None) -> Callable:
    _no_rules(rules)

    def decode_step(params, cache, tokens):
        return serve.decode_step(model, params, cache, tokens)
    return decode_step
