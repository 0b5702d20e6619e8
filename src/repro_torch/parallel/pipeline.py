"""GPipe pipeline parallelism over processes (counterpart of
``repro.parallel.pipeline``).

``pipeline_apply`` runs a layer-stacked block function over a mesh axis
holding pipeline stages: stage ``s`` owns layers ``[s L/S, (s+1) L/S)``
and microbatches flow stage to stage.  The schedule is GPipe's fill,
steady state and drain over ``m + S - 1`` ticks; the last stage banks the
finished microbatches and the output is summed over the stages (zeros
elsewhere), so every stage returns the whole output, as the reference's
closing ``psum`` makes it.

JAX differentiates through its ``ppermute`` and gets the reverse schedule
for free.  Here the whole pipeline is one ``torch.autograd.Function``
whose backward runs that reverse schedule itself, tick by tick from the
last: each live stage takes its output's cotangent (the last stage from
the output's, the others from the stage after), backpropagates its stage
and sends its input's cotangent to the stage before.  Each tick's sends
and receives go in one ``batch_isend_irecv``, so the ranks cannot
deadlock on the order of posting, which per-hop autograd nodes scheduled
by each rank's own engine could.  With ``remat`` each block runs under
``torch.utils.checkpoint``: a stage keeps its blocks' inputs, and the
backward recomputes the rest (the reference's ``jax.checkpoint``).  The
parameters' and the input's gradients are summed over the stages, so
every stage holds the whole of both, the caller's view of JAX's global
arrays.
"""
from __future__ import annotations

from typing import Callable, List

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.launch.mesh import axis_sizes
from repro_torch.optim.adamw import tree_map
from repro_torch.parallel import comm


def _flatten(tree) -> List[torch.Tensor]:
    leaves: List[torch.Tensor] = []
    tree_map(leaves.append, tree)
    return leaves


def _unflatten(tree, leaves: List[torch.Tensor]):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


class _Pipeline(torch.autograd.Function):

    @staticmethod
    def forward(ctx, cfg, x, *leaves):
        (block_fn, tree, group, n_stages, stage, m, remat, build) = cfg
        per = leaves[0].shape[0] // n_stages
        lo = stage * per
        local = [t[lo:lo + per].detach().requires_grad_(build)
                 for t in leaves]
        mb = x.shape[0] // m
        xs = x.reshape((m, mb) + tuple(x.shape[1:]))

        def block(h, *layer):
            return block_fn(_unflatten(tree, list(layer)), h)

        def stage_stack(h):
            for i in range(per):
                layer = [t[i] for t in local]
                if remat and build:
                    h = torch_checkpoint.checkpoint(block, h, *layer,
                                                    use_reentrant=False)
                else:
                    h = block(h, *layer)
            return h

        outs = torch.zeros_like(xs)
        recv = torch.zeros_like(xs[0])
        ticks = []                         # (mb index, stage input, output)
        with torch.set_grad_enabled(build):
            for t in range(m + n_stages - 1):
                j = t - stage
                live = 0 <= j < m
                h = None
                if live:
                    inp = (xs[j] if stage == 0 else recv).detach()
                    inp.requires_grad_(build)
                    h = stage_stack(inp)
                    ticks.append((j, inp, h))
                    if stage == n_stages - 1:
                        outs[j] = h.detach()
                sends = [(h.detach(), stage + 1)] \
                    if live and stage < n_stages - 1 else []
                recvs = [(recv, stage - 1)] \
                    if stage > 0 and 0 <= t - (stage - 1) < m else []
                got = comm.exchange(sends, recvs, group)
                if got:
                    recv = got[0]
        ctx.cfg, ctx.ticks, ctx.local, ctx.lo = cfg, ticks, local, lo
        ctx.shapes = [t.shape for t in leaves]
        # Only the last stage holds outputs: the sum hands them to all.
        return comm.all_reduce_sum(outs, group).reshape(x.shape)

    @staticmethod
    def backward(ctx, g_out):
        (_, _, group, n_stages, stage, m, _, _) = ctx.cfg
        per = ctx.local[0].shape[0]
        g_outs = g_out.reshape((m, -1) + tuple(g_out.shape[1:]))
        d_local = [torch.zeros_like(t) for t in ctx.local]
        d_x = torch.zeros_like(g_outs)
        by_tick = {j: (inp, h) for j, inp, h in ctx.ticks}
        recv = None
        for t in reversed(range(m + n_stages - 1)):
            j = t - stage
            live = 0 <= j < m
            d_inp = None
            if live:
                g = g_outs[j] if stage == n_stages - 1 else recv
                inp, h = by_tick[j]
                grads = torch.autograd.grad(h, [inp] + ctx.local, g,
                                            allow_unused=True)
                d_inp = grads[0]
                for acc, d in zip(d_local, grads[1:]):
                    if d is not None:
                        acc += d
                if stage == 0:
                    d_x[j] = d_inp
            sends = [(d_inp, stage - 1)] if live and stage > 0 else []
            recvs = [(g_outs[0], stage + 1)] \
                if stage < n_stages - 1 and 0 <= t - (stage + 1) < m else []
            got = comm.exchange(sends, recvs, group)
            if got:
                recv = got[0]
        d_leaves = []
        for shape, d in zip(ctx.shapes, d_local):
            full = d.new_zeros(shape)
            full[ctx.lo:ctx.lo + per] = d
            d_leaves.append(comm.all_reduce_sum(full, group))
        d_x = comm.all_reduce_sum(d_x, group).reshape(g_out.shape)
        return (None, d_x, *d_leaves)


def pipeline_apply(block_fn: Callable, stacked_params, x: torch.Tensor,
                   mesh, pp_axis: str, n_microbatches: int,
                   remat: bool = True) -> torch.Tensor:
    """Run ``x`` through all layers, stage-split over ``pp_axis``; called
    by every rank of the axis with the same whole ``stacked_params`` and
    ``x``.

    block_fn(params_one_layer, h) -> h; stacked_params leaves are
    (n_layers, ...) with n_layers % n_stages == 0; x is (batch, ...) with
    batch % n_microbatches == 0.  Returns the whole output on every
    stage.
    """
    n_stages = axis_sizes(mesh)[pp_axis]
    leaves = _flatten(stacked_params)
    n_layers = leaves[0].shape[0]
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split over "
                         f"{n_stages} stages")
    if x.shape[0] % n_microbatches:
        raise ValueError(f"batch {x.shape[0]} does not split into "
                         f"{n_microbatches} microbatches")
    build = torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in leaves))
    cfg = (block_fn, stacked_params, mesh.get_group(pp_axis), n_stages,
           mesh.get_local_rank(pp_axis), n_microbatches, remat, build)
    return _Pipeline.apply(cfg, x, *leaves)
