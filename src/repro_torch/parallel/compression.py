"""Gradient compression: the int8 data-parallel reduction with error
feedback (counterpart of ``repro.parallel.compression``).

Each leaf is quantised to int8 with its own scale; the quantisation
error is carried in an error-feedback buffer folded into the next step's
gradient.  The wire carries int8 values and one f32 scale per leaf per
rank: an all-gather of int8 moves one byte an element where a ring f32
all-reduce moves eight, and the reduction is a local scale-weighted sum
of the gathered shards.  The leaves travel as one int8 buffer and one
vector of scales (two all-gathers a step, not two a leaf); the
arithmetic is per leaf, as in the JAX package.  Under tensor
parallelism a leaf's scale is the whole leaf's, as GSPMD computes it
for the JAX package's step: each rank's maximum |value| is all-reduced
(max) over the "model" group before it quantises its slice.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.parallel import comm


def quantize(x: torch.Tensor, amax=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 codes and the f32 scale ``max|x| / 127 + 1e-12``; ``amax``
    (the whole leaf's maximum, under tensor parallelism) replaces
    ``max|x|``."""
    if amax is None:
        amax = torch.max(torch.abs(x))
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """(n, *t.shape): every rank's ``t``; ``t[None]`` in a world of one."""
    if not dist.is_initialized():
        return t[None]
    return comm.all_gather_cat(t[None], 0, group)


def compressed_psum(grads, ef, group=None, model_group=None):
    """grads/ef: local trees (ef in f32).  Returns (reduced grads in f32,
    new ef): the mean over ``group``'s ranks of their quantised
    gradients, each rank's own quantisation error kept for its next
    step.  ``model_group``: the leaves are slices over it, each quantised
    with its whole leaf's scale."""
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    folded = tree_map(lambda g, e: g.to(torch.float32) + e, grads, ef)
    leaves = tree_leaves(folded)
    amax = torch.stack([torch.max(torch.abs(g)) for g in leaves])
    if model_group is not None:
        amax = comm.all_reduce_max(amax, model_group)
    quant = [quantize(g, a) for g, a in zip(leaves, amax)]
    flat_q = torch.cat([q.reshape(-1) for q, _ in quant])
    scales = torch.stack([s for _, s in quant])
    gathered = _gather_rows(flat_q, group)            # (n, total) int8
    gathered_s = _gather_rows(scales, group)          # (n, leaves) f32
    by_leaf = {}
    start = 0
    for i, (g, (q, s)) in enumerate(zip(leaves, quant)):
        rows = gathered[:, start:start + q.numel()].to(torch.float32)
        summed = (rows * gathered_s[:, i, None]).sum(0).reshape(g.shape)
        by_leaf[id(g)] = (summed / n, g - dequantize(q, s))
        start += q.numel()
    reduced = tree_map(lambda g: by_leaf[id(g)][0], folded)
    new_ef = tree_map(lambda g: by_leaf[id(g)][1], folded)
    return reduced, new_ef


def init_ef(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
