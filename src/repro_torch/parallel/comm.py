"""The collectives of the distributed layer, and the autograd Functions
built from them.

Every rank holds whole tensors, the JAX caller's view of its global
arrays.  The Functions give each collective the backward that the JAX
package's ``shard_map`` transpose gives it:

=================== ======================= ===============================
Function            forward                 backward
=================== ======================= ===============================
:class:`Shard`      this rank's slice       all-gather of the slices'
                                            cotangents (the full gradient
                                            on every rank)
:class:`Replicated` identity                all-reduce (sum) over the axes
                                            that split the other operand
:class:`Gathered`   all-gather of the       this rank's slice of the
                    ranks' slices           cotangent, not a sum: every
                                            rank takes the same loss of the
                                            same full output
:class:`Halo`       first ``halo`` rows to  the received rows' cotangent
                    the rank before, zeros  back to the rank after, added
                    to the last             into its first rows
=================== ======================= ===============================

gloo runs ``send``/``recv`` on CPU tensors only, so under gloo every
collective on a CUDA tensor goes through host memory
(:func:`stage_to_host`, then :func:`stage_to_device`): ranks that share
one card cannot use NCCL.  Under NCCL nothing is staged.  Which applies
is decided from the group's backend, never by catching an error.  Each
of the two counts the bytes it copied in ``<function>.bytes``, as the
kernels' wrappers count their launches.

Every collective here also reports its kind and operand bytes to the
counters ``launch.hlo_analysis.collective_bytes`` opens (:data:`COUNTERS`):
``all-reduce``, ``all-gather`` (the rank's operand, not the gathered
result), ``reduce-scatter`` (the whole operand), ``all-to-all`` (the whole
operand) and ``collective-permute`` (the point-to-point sends of one
:func:`exchange`).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


#: the open counters: dicts of bytes by collective kind and ``count``
COUNTERS: List[dict] = []


def _count(kind: str, nbytes: int) -> None:
    for counter in COUNTERS:
        counter[kind] += nbytes
        counter["count"] += 1


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def stage_to_host(t: torch.Tensor) -> torch.Tensor:
    """The host copy a gloo collective runs on (one device-to-host copy of
    ``t.nbytes``)."""
    stage_to_host.bytes += t.nbytes
    return t.detach().to("cpu").contiguous()


stage_to_host.bytes = 0


def stage_to_device(h: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A gloo collective's host result copied back to ``device``."""
    stage_to_device.bytes += h.nbytes
    return h.to(device)


stage_to_device.bytes = 0


def _back(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return stage_to_device(h, like.device) if like.is_cuda and \
        not h.is_cuda else h


def all_reduce_sum(t: torch.Tensor, group=None,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``t`` summed (or reduced by ``op``) over ``group``."""
    _count("all-reduce", t.nbytes)
    return _all_reduce(t, group, op)


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    if _staged(t, group):
        h = stage_to_host(t)
        dist.all_reduce(h, op=op, group=group)
        return stage_to_device(h, t.device)
    out = t.detach().contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def all_reduce_max(t: torch.Tensor, group=None) -> torch.Tensor:
    """A new tensor: the elementwise maximum of ``t`` over ``group``."""
    return all_reduce_sum(t, group, op=dist.ReduceOp.MAX)


def all_gather_cat(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The ranks' ``t`` (one shape) concatenated along ``dim`` in group
    rank order."""
    n = dist.get_world_size(group)
    _count("all-gather", t.nbytes)
    src = stage_to_host(t) if _staged(t, group) else t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return _back(torch.cat(parts, dim=dim), t)


def reduce_scatter_sum(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """This rank's slice (one of ``n`` equal ones along ``dim``, in group
    rank order) of ``t`` summed over ``group``.  Under gloo it runs as the
    all-reduce of ``t`` and the slice: ranks that share one card stage the
    whole operand through host memory either way."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    _count("reduce-scatter", t.nbytes)
    if dist.get_backend(group) == "gloo":
        return _all_reduce(t, group).chunk(n, dim)[me].contiguous()
    src = t.detach().movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def exchange(sends: Sequence[Tuple[torch.Tensor, int]],
             recvs: Sequence[Tuple[torch.Tensor, int]],
             group=None, kind: Optional[str] = "collective-permute"
             ) -> List[torch.Tensor]:
    """Point-to-point in one batch (``batch_isend_irecv``, so no order of
    posting can deadlock): ``sends`` are (tensor, group rank of the peer),
    ``recvs`` (buffer shaped like the message, group rank of the peer).
    Returns the filled receive buffers, on the buffers' device.  The sends
    are counted as one collective of ``kind`` (None: the caller counts)."""
    if kind is not None and sends:
        _count(kind, sum(t.nbytes for t, _ in sends))
    ops, bufs = [], []
    for t, peer in sends:
        src = stage_to_host(t) if _staged(t, group) else t.contiguous()
        ops.append(dist.P2POp(dist.isend, src,
                              dist.get_global_rank(group, peer)
                              if group is not None else peer, group))
    for like, peer in recvs:
        staged = _staged(like, group)
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if staged else like.device)
        bufs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(group, peer)
                              if group is not None else peer, group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [_back(b, like) for b, (like, _) in zip(bufs, recvs)]


def all_to_all(t: torch.Tensor, split_dim: int, concat_dim: int,
               group=None) -> torch.Tensor:
    """The tiled all-to-all (``lax.all_to_all(..., tiled=True)``): ``t``
    split into one equal chunk a rank along ``split_dim``, chunk ``j`` sent
    to group rank ``j``, and the chunks received concatenated along
    ``concat_dim`` in group rank order.  Point to point through
    :func:`exchange`; the bytes sent to other ranks are added to
    ``all_to_all.bytes``."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    chunks = t.chunk(n, split_dim)
    peers = [j for j in range(n) if j != me]
    all_to_all.bytes += sum(chunks[j].nbytes for j in peers)
    _count("all-to-all", t.nbytes)
    got = exchange([(chunks[j], j) for j in peers],
                   [(chunks[me], j) for j in peers], group, kind=None)
    parts = dict(zip(peers, got))
    parts[me] = chunks[me]
    return torch.cat([parts[j] for j in range(n)], dim=concat_dim)


all_to_all.bytes = 0


class Shard(torch.autograd.Function):
    """This rank's ``index``-th of ``n`` equal slices along ``dim``."""

    @staticmethod
    def forward(ctx, t, dim: int, index: int, n: int, group):
        ctx.dim, ctx.group = dim, group
        return t.chunk(n, dim)[index].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.dim, ctx.group), None, None, None, None


class Replicated(torch.autograd.Function):
    """Identity whose cotangent is summed over ``group``."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class Gathered(torch.autograd.Function):
    """The ranks' slices concatenated along ``dim``; the backward keeps
    this rank's slice of the cotangent."""

    @staticmethod
    def forward(ctx, t, dim: int, index: int, n: int, group):
        ctx.dim, ctx.index, ctx.n = dim, index, n
        return all_gather_cat(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return (g.chunk(ctx.n, ctx.dim)[ctx.index].contiguous(), None, None,
                None, None)


class Halo(torch.autograd.Function):
    """``t`` (n, h_loc, w, c) with the next rank's first ``halo`` rows
    appended (zeros on the last rank)."""

    @staticmethod
    def forward(ctx, t, halo: int, index: int, n: int, group):
        ctx.halo, ctx.index, ctx.n, ctx.group = halo, index, n, group
        like = t[:, :halo]
        sends = [(like, index - 1)] if index > 0 else []
        recvs = [(like, index + 1)] if index < n - 1 else []
        got = exchange(sends, recvs, group)
        nxt = got[0] if got else torch.zeros_like(like)
        return torch.cat([t, nxt], dim=1)

    @staticmethod
    def backward(ctx, g):
        halo, index, n = ctx.halo, ctx.index, ctx.n
        h_loc = g.shape[1] - halo
        own = g[:, :h_loc].clone()
        back = g[:, h_loc:]
        sends = [(back, index + 1)] if index < n - 1 else []
        recvs = [(back, index - 1)] if index > 0 else []
        got = exchange(sends, recvs, ctx.group)
        if got:
            own[:, :halo] += got[0]
        return own, None, None, None, None
