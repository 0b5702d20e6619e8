"""Step builders (counterpart of ``repro.training.steps``): training,
data-parallel and int8-compressed, and serving (prefill / decode).

``make_train_step`` updates the parameters and the optimizer state in
place (``optim.adamw.update_``), the port's counterpart of the JAX
launcher's ``jax.jit(..., donate_argnums=(0, 1))``: a pure update holds
old and new parameters and moments together (22 bytes a parameter), in
place it is 12 (bf16 parameters and gradients, f32 moments).  The
arithmetic is the pure ``adamw.update``'s, so both give the same bits.

With ``rules`` (``parallel.axes.ShardingRules`` over a ``DeviceMesh``)
the step is data parallel over ``rules.dp_axes`` and tensor parallel
over ``"model"``: each rank holds its slices of the parameters
(``parallel.tensor``; the whole leaves on a mesh without a "model" axis
larger than 1) and its data rank's slice of the global batch, the same
on every rank of a "model" group.  The uncompressed step's gradient is
the global batch's, what GSPMD computes: the ranks sum their
token-weighted loss sums (``nll_sum``, ``lse^2`` sum, ``tokens``) over
the data axis rather than average their means, so masked labels weigh
as on one device, and the gradients are summed over the data axis in
one f32 all-reduce (f32 whatever the parameter dtype: gloo's reduction
of bf16 is not relied on).  The moe family routes the global batch
(``models.moe``).  Over "model" the layers' collectives give each rank
its slices' gradients and the whole gradient of every replicated leaf
(a leaf a rank uses in part has its parts summed inside the backward),
and the clip's norm counts each split segment once
(``tensor.global_norm``).  ``make_compressed_train_step`` is the JAX
package's error-feedback step: each rank's own mean loss (moe routing per
data rank, as in the JAX package's ``shard_map``), the int8
``compression.compressed_psum`` over the data axis divided by its rank
count, local over "model".  Both steps install the rules as
``local_batch``: each rank holds its own batch, so a conv inside stays on
the rank.

``make_zero1_train_step`` applies ZeRO-1 as the JAX package's dry run
places it (``parallel.sharding.opt_state_specs`` over the data-parallel
axes): each rank keeps its slice of every AdamW moment that
``zero1_specs`` splits, along the dimension it picks on the whole leaf
(:func:`zero1_dims`; the others stay whole).  The gradient of the global
batch is reduced and scattered over the data axes, each rank updates its
slice of the parameters with its moment slice, and the updated slices are
gathered back, so every rank holds its whole (tensor-parallel) parameters
again.  :func:`init_opt_state` with ``model`` and ``rules`` builds the
rank's slices.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import (AbstractMesh, axes_group, axis_names,
                                     axis_sizes)
from repro_torch.models import serve
from repro_torch.models.lm import LM
from repro_torch.optim import adamw
from repro_torch.parallel import comm, compression, tensor
from repro_torch.parallel.axes import ShardingRules, use_rules
from repro_torch.training.loss import (Z_LOSS, chunked_softmax_xent,
                                       chunked_xent_sums)


def _local_batch(rules: Optional[ShardingRules]):
    """``rules`` marked ``local_batch`` (None stays None)."""
    return None if rules is None else dataclasses.replace(rules,
                                                          local_batch=True)


def dp_group(rules: Optional[ShardingRules]):
    """The process group of ``rules``' data-parallel axes (None without
    rules)."""
    if rules is None:
        return None
    mesh = rules.mesh
    if isinstance(mesh, AbstractMesh):
        raise ValueError(f"a distributed step needs a DeviceMesh over "
                         f"ranks, not an AbstractMesh {mesh.shape_tuple}")
    dp_axes = tuple(rules.dp_axes) or axis_names(mesh)
    return axes_group(mesh, dp_axes)


def _model_group(rules):
    """The "model" axis's group where it is larger than 1, else None."""
    if rules is None or axis_sizes(rules.mesh).get(tensor.TP_AXIS, 1) == 1:
        return None
    return rules.mesh.get_group(tensor.TP_AXIS)


def _grad_norm(model: LM, rules, grads):
    """The clip's norm of a rank's gradient tree: None (``adamw``'s own)
    without a "model" axis larger than 1, else the whole model's
    (``tensor.global_norm``)."""
    if rules is None or axis_sizes(rules.mesh).get(tensor.TP_AXIS, 1) == 1:
        return None
    with use_rules(rules):
        tp = tensor.context()
    placements = tensor.local_placement(grads, rules.mesh, model.cfg,
                                        local=True)
    return tensor.global_norm(grads, placements, tp)


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
    cross-entropy of the final hidden against the head (its vocab shards
    under tensor parallelism), plus the aux loss."""
    def loss_fn(params, batch):
        h, aux = model.forward(params, batch)
        loss, metrics = chunked_softmax_xent(
            h, model.head_weights(params), batch["labels"],
            tp=model.vocab_tp())
        return loss + aux, dict(metrics, aux=aux.detach())
    return loss_fn


def make_grad_fn(model: LM, rules: Optional[ShardingRules] = None,
                 reduce_grads: bool = True) -> Callable:
    """``grad_fn(params, batch) -> (loss, metrics, grads)``: the loss of the
    batch and its gradient by autograd; with ``rules``, the global batch's
    (every rank passes its slice) on every rank of the data-parallel
    group.  ``reduce_grads=False`` leaves each rank its own part of that
    gradient, which the parts sum to over the group."""
    group = dp_group(rules)
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
                                          batch["labels"],
                                          tp=model.vocab_tp())
            sums = comm.all_reduce_sum(
                torch.stack([nll.detach(), z.detach(), n.detach()]), group)
            tokens = torch.clamp(sums[2], min=1.0)
            part = (nll + Z_LOSS * z) / tokens + aux / n_ranks
            part.backward()
        grads = _take_grads(params, leaves)
        if n_ranks > 1 and reduce_grads:
            grads = _all_reduce_tree(grads, group)
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
            om = adamw.update_(opt_cfg, grads, opt_state, params,
                               _grad_norm(model, rules, grads))
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
    # the JAX package's shard_map body: no data-parallel routing and no
    # expert-parallel routing, the "model" axis's layers as ever
    inner = None if rules is None else dataclasses.replace(
        rules, local_batch=True, dp_axes=(), ep_axis=None)
    loss_fn = make_loss_fn(model)

    def train_step(params, opt_state, batch):
        leaves = _leaves_with_grad(params)
        with torch.enable_grad(), use_rules(inner):
            loss, metrics = loss_fn(params, batch)
            loss.backward()
        grads = _take_grads(params, leaves)
        reduced, new_ef = compression.compressed_psum(
            grads, opt_state["ef"], group, _model_group(rules))
        del grads
        n = dist.get_world_size(group) if group is not None else 1
        stats = torch.stack([loss.detach(), metrics["nll"],
                             metrics["tokens"], metrics["aux"]])
        if group is not None:
            stats = comm.all_reduce_sum(stats, group) / n
        with torch.no_grad():
            om = adamw.update_(opt_cfg, reduced, opt_state, params,
                               _grad_norm(model, rules, reduced))
            adamw.tree_map(lambda e, new: e.copy_(new), opt_state["ef"],
                           new_ef)
        return params, opt_state, dict(
            nll=stats[1], tokens=stats[2], aux=stats[3], loss=stats[0],
            **om)

    return train_step


def zero1_dims(model: LM, params, rules: ShardingRules):
    """The tree of the dimension each leaf's moments split on over the
    data-parallel axes (None: kept whole): ``sharding.zero1_specs`` of
    ``param_specs`` on the whole leaves' shapes (a rank's leaves are its
    tensor-parallel slices, ``parallel.tensor``), as the JAX package's dry
    run places the optimizer state."""
    from repro_torch.parallel import sharding
    mesh = rules.mesh
    placements = tensor.local_placement(params, mesh, model.cfg, local=True)

    def whole(pl, p):
        shape = list(p.shape)
        if pl.split:
            shape[pl.dim % p.dim()] = sum(n for n, _ in pl.segments)
        return types.SimpleNamespace(shape=tuple(shape))

    shapes = tensor._zip(whole, placements, params)
    p_specs = sharding.param_specs(shapes, mesh)
    z_specs = sharding.zero1_specs(p_specs, shapes, mesh,
                                   tuple(rules.dp_axes))
    # the dimension zero1_specs placed the data axes on (specs are tuples,
    # leaves of tree_map)
    return adamw.tree_map(
        lambda ps, zs: next((i for i, (a, b) in enumerate(zip(ps, zs))
                             if a != b), None), p_specs, z_specs)


def _zero1_slice(t: torch.Tensor, dim: Optional[int], index: int, n: int):
    return t if dim is None else t.chunk(n, dim)[index]


def _moment_bytes(opt_state) -> int:
    """Bytes of a rank's AdamW moments (m and v)."""
    return sum(t.numel() * t.element_size()
               for key in ("m", "v")
               for t in adamw.tree_leaves(opt_state[key]))


def _zero1_norm(placements, reduced, dims, group, tp) -> torch.Tensor:
    """The clip's norm from a rank's reduced gradient (f32) and its
    leaves' ``placements``: a sliced leaf's squares summed over the data
    group, a whole one's counted once, and the split segments' summed
    over "model" (``tensor.global_norm``'s terms)."""
    parts = {True: ([], []), False: ([], [])}   # sliced: (split, rep)

    def one(pl, g_dim):
        split, rep = tensor.square_parts(pl, g_dim[0])
        parts[g_dim[1] is not None][0].extend(split)
        parts[g_dim[1] is not None][1].extend(rep)

    tensor._zip(one, placements,
                adamw.tree_map(lambda g, d: (g, d), reduced, dims))
    zero = torch.zeros((), dtype=torch.float32,
                       device=adamw.tree_leaves(reduced)[0].device)

    def total(xs):
        return torch.stack(xs).sum() if xs else zero

    sliced = comm.all_reduce_sum(torch.stack(
        [total(parts[True][0]), total(parts[True][1])]), group)
    split = sliced[0] + total(parts[False][0])
    rep = sliced[1] + total(parts[False][1])
    if tp is not None:
        split = comm.all_reduce_sum(split.reshape(1), tp)[0]
    return torch.sqrt(split + rep)


def make_zero1_train_step(model: LM, opt_cfg: adamw.AdamWConfig,
                          rules: ShardingRules) -> Callable:
    """:func:`make_train_step` with ZeRO-1 over ``rules``' data-parallel
    axes: ``opt_state`` holds the rank's moment slices
    (:func:`init_opt_state` with ``model`` and ``rules``).  Each leaf's
    gradient (f32) is reduced and scattered over the data group along
    :func:`zero1_dims`' dimension (summed whole where it is None); the
    clip's norm sums the slices' squares over the data group (and the
    split segments' over "model"); AdamW updates the rank's slice of each
    parameter, and the slices are gathered back into the parameters."""
    group = dp_group(rules)
    grad_fn = make_grad_fn(model, rules, reduce_grads=False)
    tp = _model_group(rules)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = grad_fn(params, batch)
        n, me = dist.get_world_size(group), dist.get_rank(group)
        dims = zero1_dims(model, params, rules)
        reduced = adamw.tree_map(
            lambda g, d: comm.all_reduce_sum(g.to(torch.float32), group)
            if d is None else
            comm.reduce_scatter_sum(g.to(torch.float32), d, group),
            grads, dims)
        del grads
        gnorm = _zero1_norm(tensor.local_placement(
            params, rules.mesh, model.cfg, local=True), reduced, dims,
            group, tp)
        with torch.no_grad():
            own = adamw.tree_map(
                lambda p, d: _zero1_slice(p, d, me, n).contiguous(),
                params, dims)
            om = adamw.update_(opt_cfg, reduced, opt_state, own, gnorm)
            adamw.tree_map(
                lambda p, o, d: None if d is None else
                p.copy_(comm.all_gather_cat(o, d, group)),
                params, own, dims)
        del reduced, own
        return params, opt_state, dict(metrics, loss=loss, **om)

    return train_step


def metrics_shape(model: LM):  # lint-ignore: accepted-kwarg-not-forwarded
    return {"nll": 0.0, "tokens": 0.0, "aux": 0.0}


def init_opt_state(params, compressed: bool = False, *,
                   model: Optional[LM] = None,
                   rules: Optional[ShardingRules] = None) -> Dict:
    """AdamW's state of ``params`` (and the error feedback, ``compressed``).
    With ``model`` and ``rules``, ZeRO-1: the rank's slices of the moments
    (:func:`make_zero1_train_step`)."""
    if model is not None and rules is not None:
        group = dp_group(rules)
        n, me = dist.get_world_size(group), dist.get_rank(group)
        state = adamw.init(adamw.tree_map(
            lambda p, d: _zero1_slice(p, d, me, n),
            params, zero1_dims(model, params, rules)))
    else:
        state = adamw.init(params)
    if compressed:
        state["ef"] = compression.init_ef(params)
    return state


def make_prefill_step(model: LM, max_len: int,
                      rules: Optional[ShardingRules] = None) -> Callable:
    """Prefill under ``rules`` (the layers' tensor parallelism over
    "model"; the logits are the rank's vocab shard where it splits)."""
    def prefill_step(params, batch):
        with use_rules(rules):
            return serve.prefill(model, params, batch, max_len)
    return prefill_step


def make_decode_step(model: LM, rules: Optional[ShardingRules] = None
                     ) -> Callable:
    def decode_step(params, cache, tokens):
        with use_rules(rules):
            return serve.decode_step(model, params, cache, tokens)
    return decode_step
