"""Step builders (counterpart of ``repro.training.steps``): training,
data-parallel and int8-compressed, and serving (prefill / decode).

``make_train_step`` updates the parameters and the optimizer state in
place (``optim.adamw.update_``), the port's counterpart of the JAX
launcher's ``jax.jit(..., donate_argnums=(0, 1))``: a pure update holds
old and new parameters and moments together (22 bytes a parameter), in
place it is 12 (bf16 parameters and gradients, f32 moments).  The
arithmetic is the pure ``adamw.update``'s, so both give the same bits.

With ``rules`` (``parallel.axes.ShardingRules`` over a ``DeviceMesh``)
the step is data parallel over ``rules.dp_axes``: every rank holds the
whole parameters and its slice of the global batch.  The uncompressed
step's gradient is the global batch's, what GSPMD computes: the ranks
sum their token-weighted loss sums (``nll_sum``, ``lse^2`` sum,
``tokens``) rather than average their means, so masked labels weigh as
on one device, and the gradients are summed in one f32 all-reduce (f32
whatever the parameter dtype: gloo's reduction of bf16 is not relied
on).  That holds for the dense, ssm, hybrid, vlm and audio families:
the moe family's routing statistics (the load-balance term, expert
capacity from the token count) are not linear in the batch, and the
uncompressed data-parallel step raises for it until they are reduced
over the ranks.  ``make_compressed_train_step`` is the JAX package's
error-feedback step: each rank's own mean loss (moe routing per rank, as
in the JAX package's ``shard_map``), the int8
``compression.compressed_psum`` divided by the rank count.  Both steps
install the rules as ``local_batch``: each rank holds its own batch, so a
conv inside stays on the rank.  The LMs' tensor parallelism is not
ported: rules over a mesh with another axis larger than one raise
``NotImplementedError`` (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import axes_group, axis_names, axis_sizes
from repro_torch.models import serve
from repro_torch.models.lm import LM
from repro_torch.optim import adamw
from repro_torch.parallel import comm, compression
from repro_torch.parallel.axes import ShardingRules, use_rules
from repro_torch.training.loss import (Z_LOSS, chunked_softmax_xent,
                                       chunked_xent_sums)

#: the ROADMAP item of what distributed execution still lacks
TP_ITEM = ("the LMs' tensor parallelism over the 'model' axis, ROADMAP "
           "Queue 1 item 11")
EP_ITEM = ("the moe family's routing statistics reduced over the ranks, "
           "with expert parallelism, ROADMAP Queue 1 item 11")


def _local_batch(rules: Optional[ShardingRules]):
    """``rules`` marked ``local_batch`` (None stays None)."""
    return None if rules is None else dataclasses.replace(rules,
                                                          local_batch=True)


def dp_group(rules: Optional[ShardingRules]):
    """The process group of ``rules``' data-parallel axes (None without
    rules).  Any other mesh axis must be 1-way: tensor parallelism of the
    LMs is not ported."""
    if rules is None:
        return None
    mesh = rules.mesh
    dp_axes = tuple(rules.dp_axes) or axis_names(mesh)
    other = {a: n for a, n in axis_sizes(mesh).items()
             if a not in dp_axes and n > 1}
    if other:
        raise NotImplementedError(f"mesh axes {other} beyond the data-"
                                  f"parallel {dp_axes}: {TP_ITEM}")
    return axes_group(mesh, dp_axes)


def _leaves_with_grad(params):
    leaves = adamw.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    return leaves


def _take_grads(params, leaves):
    grads = adamw.tree_map(
        lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
        params)
    for p in leaves:
        p.grad = None
        p.requires_grad_(False)
    return grads


def _all_reduce_tree(grads, group):
    """The trees' leaves summed over ``group`` in one f32 buffer, each cast
    back to its own dtype."""
    leaves = adamw.tree_leaves(grads)
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in leaves])
    flat = comm.all_reduce_sum(flat, group)
    out, start = {}, 0
    for g in leaves:
        out[id(g)] = flat[start:start + g.numel()].reshape(g.shape).to(
            g.dtype)
        start += g.numel()
    return adamw.tree_map(lambda g: out[id(g)], grads)


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


def make_grad_fn(model: LM, rules: Optional[ShardingRules] = None
                 ) -> Callable:
    """``grad_fn(params, batch) -> (loss, metrics, grads)``: the loss of the
    batch and its gradient by autograd; with ``rules``, the global batch's
    (every rank passes its slice) on every rank of the data-parallel
    group."""
    group = dp_group(rules)
    if group is not None and model.cfg.n_experts and \
            dist.get_world_size(group) > 1:
        raise NotImplementedError(
            f"data-parallel gradient of {model.cfg.name}: per-rank routing "
            f"(load-balance term, capacity) is not the global batch's; "
            f"{EP_ITEM}")
    rules = _local_batch(rules)
    loss_fn = make_loss_fn(model)

    def local(params, batch):
        leaves = _leaves_with_grad(params)
        with torch.enable_grad():
            loss, metrics = loss_fn(params, batch)
            loss.backward()
        return loss.detach(), metrics, _take_grads(params, leaves)

    def data_parallel(params, batch):
        n_ranks = dist.get_world_size(group)
        leaves = _leaves_with_grad(params)
        with torch.enable_grad(), use_rules(rules):
            h, aux = model.forward(params, batch)
            nll, z, n = chunked_xent_sums(h, model.head_weights(params),
                                          batch["labels"])
            sums = comm.all_reduce_sum(
                torch.stack([nll.detach(), z.detach(), n.detach()]), group)
            tokens = torch.clamp(sums[2], min=1.0)
            part = (nll + Z_LOSS * z) / tokens + aux / n_ranks
            part.backward()
        grads = _all_reduce_tree(_take_grads(params, leaves), group)
        aux_mean = comm.all_reduce_sum(aux.detach().reshape(1), group)[0] \
            / n_ranks
        loss = (sums[0] + Z_LOSS * sums[1]) / tokens + aux_mean
        return loss, {"nll": sums[0] / tokens, "tokens": tokens,
                      "aux": aux_mean}, grads

    return local if group is None else data_parallel


def make_train_step(model: LM, opt_cfg: adamw.AdamWConfig,
                    rules: Optional[ShardingRules] = None) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the gradient of :func:`make_grad_fn`, then one AdamW step
    that writes the parameters and moments in place and returns the same
    trees.  Metrics: ``loss``, ``nll``, ``tokens``, ``aux``, ``grad_norm``,
    ``lr`` (0-d tensors on the device; reading them is the caller's
    sync)."""
    grad_fn = make_grad_fn(model, rules)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = grad_fn(params, batch)
        with torch.no_grad():
            om = adamw.update_(opt_cfg, grads, opt_state, params)
        del grads
        return params, opt_state, dict(metrics, loss=loss, **om)

    return train_step


def make_compressed_train_step(model: LM, opt_cfg: adamw.AdamWConfig,
                               rules: Optional[ShardingRules]) -> Callable:
    """Training with the int8 error-feedback gradient reduction over the
    data-parallel axes: each rank's own mean loss and gradient, reduced by
    ``compression.compressed_psum`` (the mean over ranks); loss and
    metrics are averaged over the ranks.  ``opt_state`` carries ``ef``
    (:func:`init_opt_state` with ``compressed=True``)."""
    group = dp_group(rules)
    rules = _local_batch(rules)
    loss_fn = make_loss_fn(model)

    def train_step(params, opt_state, batch):
        leaves = _leaves_with_grad(params)
        with torch.enable_grad(), use_rules(rules):
            loss, metrics = loss_fn(params, batch)
            loss.backward()
        grads = _take_grads(params, leaves)
        reduced, new_ef = compression.compressed_psum(grads, opt_state["ef"],
                                                      group)
        del grads
        n = dist.get_world_size(group) if group is not None else 1
        stats = torch.stack([loss.detach(), metrics["nll"],
                             metrics["tokens"], metrics["aux"]])
        if group is not None:
            stats = comm.all_reduce_sum(stats, group) / n
        with torch.no_grad():
            om = adamw.update_(opt_cfg, reduced, opt_state, params)
            adamw.tree_map(lambda e, new: e.copy_(new), opt_state["ef"],
                           new_ef)
        return params, opt_state, dict(
            nll=stats[1], tokens=stats[2], aux=stats[3], loss=stats[0],
            **om)

    return train_step


def metrics_shape(model: LM):  # lint-ignore: accepted-kwarg-not-forwarded
    return {"nll": 0.0, "tokens": 0.0, "aux": 0.0}


def init_opt_state(params, compressed: bool = False) -> Dict:
    state = adamw.init(params)
    if compressed:
        state["ef"] = compression.init_ef(params)
    return state


def make_prefill_step(model: LM, max_len: int,
                      rules: Optional[ShardingRules] = None) -> Callable:
    """Prefill on one process; ``rules`` are installed around it (the
    layers' ``constrain`` checks their names), and any axis beyond the
    data-parallel ones raises as in :func:`dp_group`."""
    dp_group(rules)

    def prefill_step(params, batch):
        with use_rules(rules):
            return serve.prefill(model, params, batch, max_len)
    return prefill_step


def make_decode_step(model: LM, rules: Optional[ShardingRules] = None
                     ) -> Callable:
    dp_group(rules)

    def decode_step(params, cache, tokens):
        with use_rules(rules):
            return serve.decode_step(model, params, cache, tokens)
    return decode_step
