"""Sequence-chunked softmax cross-entropy (counterpart of
``repro.training.loss``).

Materialising (B, S, V) f32 logits for a 152k vocabulary costs ~10 GB at
(8, 2048) tokens, so the loss runs over sequence chunks: each chunk
projects (B, c, d) -> (B, c, V), reduces and discards.  A Python loop
over chunks under autograd would keep every chunk's logits for the
backward, which is the whole (B, S, V) again; here the loop sits inside
one ``torch.autograd.Function`` that keeps only each chunk's
log-sum-exp (B, c) and recomputes the chunk's logits in the backward,
each pass working on one chunk's logits in place, so the peak is one
chunk's logits beside the head's f32 copy (and, in the backward, its f32
gradient).

Over a vocab-sharded head (tensor parallelism, ``tp``) each rank holds
its columns of the head: a chunk's maximum is all-reduced (max) over the
"model" axis, then its sum of exponentials and the target's logit (from
the rank that holds it) are all-reduced (sum), so every rank has the
whole log-sum-exp, the ``nll`` and the ``lse^2`` z-term.  The backward
recomputes the rank's logits, runs the same collectives in the same
order on every rank (none: the saved log-sum-exp is whole), and sums the
hidden's partial gradients over the axis once.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.parallel import comm

_F32 = torch.float32


def _chunks(h, labels, chunk: int):
    """(h, labels) padded to a multiple of ``chunk`` (labels with -1) and
    split along the sequence: lists of (B, c, d) and (B, c)."""
    s = h.shape[1]
    pad = (-s) % chunk
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    return h.split(chunk, dim=1), labels.split(chunk, dim=1)


class _ChunkedXent(torch.autograd.Function):
    """(h, w_head, labels) -> (nll sum, z sum, valid tokens), each 0-d f32,
    summed over chunks in order."""

    @staticmethod
    def forward(ctx, h, w, labels, chunk, tp):
        w32 = w.to(_F32)
        nll = torch.zeros((), dtype=_F32, device=h.device)
        z = torch.zeros((), dtype=_F32, device=h.device)
        n = torch.zeros((), dtype=_F32, device=h.device)
        lses = []
        for h_i, l_i in zip(*_chunks(h, labels, chunk)):
            logits = torch.matmul(h_i.to(_F32), w32)          # (B, c, V)
            ids, mine = _local_ids(l_i, w.shape[-1], tp)
            gold = torch.take_along_dim(logits, ids[..., None],
                                        dim=-1)[..., 0]
            top = logits.amax(dim=-1)
            if tp is None:
                # log-sum-exp in place: max + log(sum(exp(logits - max)))
                lse = logits.sub_(top[..., None]).exp_().sum(-1).log_() \
                    .add_(top)
            else:
                gold = gold * mine
                top = comm.all_reduce_max(top, tp.group)
                sums = comm.all_reduce_sum(torch.stack(
                    [logits.sub_(top[..., None]).exp_().sum(-1), gold]),
                    tp.group)
                lse = sums[0].log_().add_(top)
                gold = sums[1]
            del logits
            valid = (l_i >= 0).to(_F32)
            nll = nll + torch.sum((lse - gold) * valid)
            z = z + torch.sum(torch.square(lse) * valid)
            n = n + valid.sum()
            lses.append(lse)
        ctx.save_for_backward(h, w, labels, *lses)
        ctx.chunk, ctx.tp = chunk, tp
        ctx.mark_non_differentiable(n)
        return nll, z, n

    @staticmethod
    def backward(ctx, g_nll, g_z, _):
        h, w, labels, *lses = ctx.saved_tensors
        tp = ctx.tp
        w32 = w.to(_F32)
        dw32 = torch.zeros_like(w32) if ctx.needs_input_grad[1] else None
        dh = []
        for h_i, l_i, lse in zip(*_chunks(h, labels, ctx.chunk), lses):
            h32 = h_i.to(_F32)
            # d/dlogits of sum((lse - gold) v) g_nll + sum(lse^2 v) g_z:
            # softmax * v (g_nll + 2 g_z lse) - onehot(gold) * v g_nll
            p = torch.matmul(h32, w32)
            p.sub_(lse[..., None]).exp_()
            valid = (l_i >= 0).to(_F32)
            p.mul_((valid * (g_nll + 2.0 * g_z * lse))[..., None])
            rows = p.view(-1, p.shape[-1])
            idx = torch.arange(rows.shape[0], device=p.device)
            ids, mine = _local_ids(l_i, w.shape[-1], tp)
            rows[idx, ids.reshape(-1)] -= (valid * g_nll * mine).reshape(-1)
            dh.append(torch.matmul(p, w32.T))
            if dw32 is not None:     # accumulated in place: no (d, V) temporary
                dw32.addmm_(h32.reshape(-1, h32.shape[-1]).T, rows)
            del p, rows
        d_h = torch.cat(dh, dim=1)[:, :h.shape[1]]
        if tp is not None:
            d_h = comm.all_reduce_sum(d_h, tp.group)
        d_w = dw32.to(w.dtype) if dw32 is not None else None
        return d_h.to(h.dtype), d_w, None, None, None


def _local_ids(labels, v_loc: int, tp):
    """(the labels' column in the rank's head, clamped into it; 1.0 where
    the rank holds the label, else 0.0; all 1.0 without ``tp``)."""
    if tp is None:
        return torch.clamp(labels, min=0).long(), 1.0
    ids = labels.long() - tp.rank * v_loc
    mine = (ids >= 0) & (ids < v_loc)
    return torch.clamp(ids, 0, v_loc - 1), mine.to(_F32)


Z_LOSS = 1e-4


def chunked_xent_sums(h: torch.Tensor, w_head: torch.Tensor,
                      labels: torch.Tensor, chunk: int = 512, tp=None):
    """(nll sum, lse^2 sum, valid tokens), each 0-d f32: the token-weighted
    sums a data-parallel step reduces over ranks before it divides.
    ``tp`` (a ``parallel.tensor.TP``): ``w_head`` is the rank's vocab
    columns."""
    return _ChunkedXent.apply(h, w_head, labels, min(chunk, h.shape[1]), tp)


def chunked_softmax_xent(h: torch.Tensor, w_head: torch.Tensor,
                         labels: torch.Tensor, chunk: int = 512,
                         z_loss: float = Z_LOSS, tp=None
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """h (B, S, d); w_head (d, V); labels (B, S) integer (-1 = ignore).

    Returns (mean_nll + z_loss * mean(lse^2), metrics dict with ``nll`` and
    ``tokens``), the logits and the log-sum-exp in f32."""
    nll, z, n = chunked_xent_sums(h, w_head, labels, chunk, tp)
    n = torch.clamp(n, min=1.0)
    loss = nll / n + z_loss * z / n
    return loss, {"nll": (nll / n).detach(), "tokens": n}
