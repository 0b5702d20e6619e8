"""Mixture-of-Experts FFN (counterpart of ``repro.models.moe``): top-k
token-choice routing with capacity buckets, and its three executors.

``moe_ffn`` reads the installed rules, as the JAX package's does:

* no rules, or the experts whole on every rank: ``_moe_local``, all
  experts resident.  Under a data-parallel train step's rules
  (``local_batch``, more than one data rank) it routes the *global*
  batch, as GSPMD does for the JAX package's local dispatch on a data
  mesh: the capacity comes from the global token count, the load-balance
  statistics are summed over the data ranks before their product, and
  each expert's bucket positions are offset by the counts of the lower
  data ranks, so the same assignments drop as on one device.
* the experts split over the "model" axis (``moe_impl="ep"``,
  ``parallel.tensor.experts_split``) and the rules' ``ep_axis`` that
  axis: ``_moe_ep``, the JAX package's expert parallelism.  Each rank
  routes its sequence slice (all tokens where the sequence does not
  divide, as decode's one token), its buckets (E, C, d) go to the experts'
  ranks by one all-to-all, (E_loc, ep * C, d) come back by another, and
  ``aux`` is averaged over the axis (the data ranks' mean is the train
  step's).  With ``cfg.moe_dispatch_int8`` both all-to-alls carry int8
  rows with a bf16 scale (:func:`int8_all_to_all`), the cotangents too.
* the experts split but no ``ep_axis`` (the compressed step's rules, the
  JAX package's ``shard_map`` body, where it routes its own batch
  locally): every rank routes all its tokens and the same all-to-alls
  carry them to the experts, the local executor's arithmetic with the
  experts on their ranks.

Dropped tokens (over capacity) fall back to the residual path.  The JAX
package's ``.at[].set(mode="drop")`` and ``.at[].get(mode="fill")`` have
no PyTorch counterpart, and boolean masks would read the device from the
host, so the buckets carry one spare row: every dropped (token, expert)
assignment is written to row C of an (E, C + 1, d) buffer, which is sliced
off, and read back from a row C of zeros.  The drop set is the JAX
package's: the running count runs over the flattened (T * k) assignments,
token-major, k-minor.  The combine adds each token's k contributions in
order j = 0 .. k - 1 in the values' dtype, as the JAX scatter-add does,
without atomics, so a captured step equals the eager one to the bit.
Nothing in a call reads a device value on the host: the decode step
captures as one CUDA graph.  Under :func:`count_drops` each call adds its
dropped assignments to a device counter.

Expert products have f32 results, the JAX package's
``preferred_element_type=float32``.  On CUDA the expert weights stay in
their dtype (qwen3-moe-30b-a3b holds 29 B expert parameters, all read by
a decode step; an f32 copy would triple a step's bytes): bf16/f16
operands take one product with an f32 result (``torch.bmm(...,
out_dtype=torch.float32)``, whose backward :class:`_ProductF32` supplies
from the f32 cotangent, as the JAX package's transpose does).
The CPU has no such product; there the operands are widened to f32, the
same function (a product of two bf16 values is exact in f32), at the
sizes the CPU runs.  The bf16 ``bmm`` instead would round g and u to bf16
before the SwiGLU: at smoke size that flipped one token's top-k choice
in a later layer against the JAX package (cache leaves 0.15-0.35 apart in
bf16, where the widened product agrees to the bit;
``tests/test_torch_moe.py``).
"""
from __future__ import annotations

import contextlib
import math
from typing import List, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.launch.mesh import axes_group
from repro_torch.models.layers import init_normal, init_swiglu, swiglu
from repro_torch.parallel import comm, tensor
from repro_torch.parallel.axes import current_rules

_F32 = torch.float32
#: most f32 elements one draw of :func:`chunked_normal` holds at a time
DRAW_ELEMENTS = 1 << 28


def chunked_normal(generator: torch.Generator, shape, scale: float, dtype,
                   device, keep=None) -> torch.Tensor:
    """N(0, scale^2) in ``dtype`` of ``shape``, drawn as
    :func:`~repro_torch.models.layers.init_normal` draws, but in chunks of
    the leading axes of at most :data:`DRAW_ELEMENTS` f32 elements each,
    written into one buffer: no f32 copy of the whole leaf (kimi-k2's
    (384, 7168, 2048) expert leaf would take 22.5 GB).  ``keep`` (lo, hi)
    keeps only those indices of axis -3 (a rank's experts): the whole
    leaf's stream is drawn, the rest dropped chunk by chunk."""
    shape = tuple(shape)
    if keep is not None:
        lo, hi = keep
        out = torch.empty(shape[:-3] + (hi - lo,) + shape[-2:], dtype=dtype,
                          device=device)
        dst = out.view(-1, *shape[-2:])
    else:
        out = torch.empty(shape, dtype=dtype, device=device)
        dst = out.view(-1, *shape[-2:]) if len(shape) > 2 \
            else out.view(1, *shape)
    rows = math.prod(shape[:-2]) if len(shape) > 2 else 1
    per = math.prod(dst.shape[1:])
    step = max(1, DRAW_ELEMENTS // per)
    for i in range(0, rows, step):
        n = min(step, rows - i)
        draw = init_normal(generator, (n,) + tuple(dst.shape[1:]), scale,
                           dtype, device)
        if keep is None:
            dst[i:i + n] = draw
            continue
        e = shape[-3]
        r = torch.arange(i, i + n)
        mine = ((r % e) >= lo) & ((r % e) < hi)
        if mine.any():
            r = r[mine]
            at = (r // e) * (hi - lo) + (r % e) - lo
            dst[at.to(device)] = draw[mine.to(draw.device)]
    return out


def init_moe(generator: torch.Generator, cfg, dtype, device="cuda",
             prefix: Tuple[int, ...] = (), tp=(1, 0)) -> dict:
    """The router (f32 in any model dtype, as the JAX package's), the
    experts' gate, up and down weights (E, d, f), (E, d, f), (E, f, d) in
    ``dtype``, and the shared experts' SwiGLU when configured; every leaf
    stacked over ``prefix`` (the layers), the expert leaves drawn in
    chunks (:func:`chunked_normal`).  ``tp`` (axis size, rank): the rank's
    experts and shared columns/rows (``parallel.tensor``) from the same
    stream."""
    n, rank = tp
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    keep = None
    if n > 1 and tensor.experts_split(cfg, n):
        keep = (rank * e // n, (rank + 1) * e // n)
    p = {
        "router": chunked_normal(generator, prefix + (d, e), d ** -0.5, _F32,
                                 device),
        "wg": chunked_normal(generator, prefix + (e, d, f), d ** -0.5, dtype,
                             device, keep),
        "wu": chunked_normal(generator, prefix + (e, d, f), d ** -0.5, dtype,
                             device, keep),
        "wd": chunked_normal(generator, prefix + (e, f, d), f ** -0.5, dtype,
                             device, keep),
    }
    if cfg.n_shared_experts:
        from repro_torch.models.lm import stack_init
        cut = None if n == 1 else (lambda tree: tensor.shard_params(
            tree, n, cfg, rank, ("blocks", "moe", "shared")))
        p["shared"] = stack_init(
            lambda: init_swiglu(generator, d, f * cfg.n_shared_experts, dtype,
                                device=device), prefix, cut)
    return p


def _capacity(t: int, cfg) -> int:
    c = int(math.ceil(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(4, -(-c // 4) * 4)


def _route(x_flat: torch.Tensor, router_w: torch.Tensor, cfg, dp=None):
    """x_flat (T, d) -> gate weights (T, k) f32, expert ids (T, k), aux
    loss (0-d f32).  Over a data-parallel group ``dp`` the load-balance
    term is the global batch's: the expert counts and the probabilities
    summed over the group (the sum's cotangent summed back) before their
    product."""
    logits = torch.matmul(x_flat.to(_F32), router_w.to(_F32))
    probs = torch.softmax(logits, dim=-1)
    gw, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gw = gw / torch.clamp(gw.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance aux: E * sum_e f_e * p_e
    e = cfg.n_experts
    if dp is None:
        fracs = torch.mean(_one_hot(idx, e, _F32).sum(1), dim=0)
        mean_probs = torch.mean(probs, dim=0)
    else:
        t = x_flat.shape[0] * dist.get_world_size(dp)
        sums = tensor.psum(torch.cat([_one_hot(idx, e, _F32).sum((0, 1)),
                                      probs.sum(0)]), dp) / t
        fracs, mean_probs = sums[:e], sums[e:]
    aux = e * torch.sum(fracs * mean_probs) / cfg.top_k
    return gw, idx, aux


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """One-hot by comparison (``F.one_hot`` checks its ids on the host)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _pack(x_flat, gw, idx, capacity: int, cfg, dp=None):  # lint-ignore: accepted-kwarg-not-forwarded
    """Scatter tokens into (E, C, d) capacity buckets.  Returns the buckets
    (a view of an (E, C + 1, d) buffer whose row C took the dropped
    assignments) and the routing (expert ids, positions with the dropped
    ones at C, token ids; each (T * k,)).  ``gw`` is applied at unpack.
    Over a data-parallel group ``dp`` the positions are the global batch's
    (the rank's tokens after the lower ranks'): each expert's running
    count starts at the lower ranks' counts of it."""
    t, d = x_flat.shape
    k, e = cfg.top_k, cfg.n_experts
    e_idx = idx.reshape(-1).long()                                # (T*k,)
    tok_idx = torch.arange(t, device=x_flat.device).repeat_interleave(k)
    onehot = _one_hot(e_idx, e, torch.int32)                      # (T*k, E)
    pos = torch.take_along_dim(torch.cumsum(onehot, dim=0) - 1,
                               e_idx[:, None], dim=1)[:, 0]
    if dp is not None:
        counts = comm.all_gather_cat(onehot.sum(0)[None].to(torch.int64), 0,
                                     dp)
        lower = counts[:dist.get_rank(dp)].sum(0)
        pos = pos + lower[e_idx].to(pos.dtype)
    pos = torch.clamp(pos, max=capacity)           # dropped -> spare row C
    buckets = torch.zeros((e, capacity + 1, d), dtype=x_flat.dtype,
                          device=x_flat.device)
    buckets = buckets.index_put((e_idx, pos), x_flat[tok_idx])
    return buckets[:, :capacity], (e_idx, pos, tok_idx)


def _dropped(routing, capacity: int) -> torch.Tensor:
    """The number of dropped assignments (0-d int64, on the device)."""
    return (routing[1] >= capacity).sum()


def _unpack(expert_out, routing, gw, t: int, d: int):
    """Gather each assignment's expert output (zeros where dropped), weight
    it by its gate and add a token's k contributions in order j = 0 ..
    k - 1 in the outputs' dtype: (T, d)."""
    e_idx, pos, _ = routing
    zero = expert_out.new_zeros((expert_out.shape[0], 1, d))
    vals = torch.cat([expert_out, zero], dim=1)[e_idx, pos]      # (T*k, d)
    w = gw.reshape(-1)[:, None].to(vals.dtype)
    contrib = (w * vals).reshape(t, -1, d)
    y = contrib[:, 0]
    for j in range(1, contrib.shape[1]):
        y = y + contrib[:, j]
    return y


def _product_f32_grads(a, b, g, need_a: bool = True, need_b: bool = True):
    """The gradients of ``a @ b`` (batched, f32 result) at the f32
    cotangent ``g``: each product takes ``g`` in f32 and the other operand
    widened to f32, its result cast to the operand's dtype.  That is the
    JAX package's transpose of a ``preferred_element_type=float32`` einsum
    (the f32 cotangent times the widened operand), and the widened
    product's autograd on the CPU; the widened weight is a transient of
    one layer's expert leaf in the backward, never on the serving path."""
    da = db = None
    if need_a:
        da = torch.bmm(g, b.transpose(1, 2).to(_F32)).to(a.dtype)
    if need_b:
        db = torch.bmm(a.transpose(1, 2).to(_F32), g).to(b.dtype)
    return da, db


class _ProductF32(torch.autograd.Function):
    """a @ b batched, 16-bit operands on CUDA, f32 result without widening
    the operands; the backward is :func:`_product_f32_grads`."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=_F32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return _product_f32_grads(a, b, g.to(_F32), *ctx.needs_input_grad)


def _product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b with an f32 result (the module docstring says how)."""
    if a.dtype == _F32 and b.dtype == _F32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return _ProductF32.apply(a, b)
    return torch.bmm(a.to(_F32), b.to(_F32))


def _expert_ffn(buckets, wg, wu, wd):
    """buckets (E, C, d) x per-expert SwiGLU -> (E, C, d); f32 results."""
    g = _product_f32(buckets, wg)
    u = _product_f32(buckets, wu)
    h = (F.silu(g) * u).to(buckets.dtype)
    return _product_f32(h, wd).to(buckets.dtype)


#: the active drop counters of :func:`count_drops`, innermost last
_COUNTERS: List[torch.Tensor] = []


@contextlib.contextmanager
def count_drops(device):
    """A 0-d int64 counter on ``device`` to which every ``moe_ffn`` call
    inside the block adds its dropped assignments, in place on the device
    (so a captured step adds at each replay).  Under activation
    checkpointing a recomputed block adds again."""
    counter = torch.zeros((), dtype=torch.int64, device=device)
    _COUNTERS.append(counter)
    try:
        yield counter
    finally:
        _COUNTERS.pop()


def _data_group():
    """The data-parallel group whose global batch the local executor
    routes: under a train step's rules (``local_batch``) with more than
    one data rank and a data-parallel ``dp_axes``; else None."""
    rules = current_rules()
    if rules is None or not rules.local_batch or not rules.dp_axes:
        return None
    group = axes_group(rules.mesh, rules.dp_axes)
    return group if dist.get_world_size(group) > 1 else None


def _moe_local(p, cfg, x, dp=None):
    b, s, d = x.shape
    x_flat = x.reshape(b * s, d)
    gw, idx, aux = _route(x_flat, p["router"], cfg, dp)
    t = b * s * (1 if dp is None else dist.get_world_size(dp))
    cap = _capacity(t, cfg)
    buckets, routing = _pack(x_flat, gw, idx, cap, cfg, dp)
    if _COUNTERS:
        _COUNTERS[-1].add_(_dropped(routing, cap))
    out = _expert_ffn(buckets, p["wg"], p["wu"], p["wd"])
    y = _unpack(out, routing, gw, b * s, d).reshape(b, s, d)
    return y, aux


# ---------------------------------------------------------------------------
# int8 all_to_all: the dispatch/return rows quantized per row to int8 with
# a bf16 scale before they cross ranks, in both directions (the backward
# quantizes the cotangents too).
# ---------------------------------------------------------------------------

def _q8(x: torch.Tensor):
    """Per-row int8 codes and bf16 scales: max |x| over the last axis /
    127 (+1e-12), values rounded half to even and clipped to [-127,
    127]."""
    x32 = x.to(_F32)
    scale = x32.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _group(ep):
    return getattr(ep, "group", ep)


def _q8_a2a(x, ep, split_axis: int, concat_axis: int):
    q, s = _q8(x)
    qr = comm.all_to_all(q, split_axis, concat_axis, _group(ep))
    sr = comm.all_to_all(s, split_axis, concat_axis, _group(ep))
    return (qr.to(_F32) * sr.to(_F32)).to(x.dtype)


class _Int8AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ep, split_axis, concat_axis):
        ctx.ep, ctx.axes = ep, (split_axis, concat_axis)
        return _q8_a2a(x, ep, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        # reverse direction: split and concat swapped, the cotangent
        # quantized too
        return _q8_a2a(g, ctx.ep, concat_axis, split_axis), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ep, split_axis, concat_axis):
        ctx.ep, ctx.axes = ep, (split_axis, concat_axis)
        return comm.all_to_all(x, split_axis, concat_axis, _group(ep))

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return (comm.all_to_all(g, concat_axis, split_axis, _group(ctx.ep)),
                None, None, None)


def int8_all_to_all(x, ep, split_axis: int, concat_axis: int):
    """The tiled all-to-all over ``ep`` (a ``parallel.tensor.TP`` or a
    process group) of ``x`` quantized per row (:func:`_q8`): int8 codes
    and bf16 scales cross, the result is their product in ``x``'s dtype.
    Its VJP is the same exchange backwards, quantizing the cotangent."""
    return _Int8AllToAll.apply(x, ep, split_axis, concat_axis)


def all_to_all(x, ep, split_axis: int, concat_axis: int):
    """The tiled all-to-all over ``ep``, differentiable (its transpose is
    the exchange with split and concat swapped)."""
    return _AllToAll.apply(x, ep, split_axis, concat_axis)


def ep_context(cfg):
    """The "model" axis where the moe block runs the JAX package's expert
    parallelism (``_moe_ep``): the experts (and any shared experts' width)
    split over it and the rules' ``ep_axis`` is it; else None."""
    rules = current_rules()
    tp = tensor.context()
    if tp is None or rules.ep_axis != rules.tp_axis or \
            not tensor.experts_split(cfg, tp.size):
        return None
    if cfg.n_shared_experts and \
            (cfg.moe_d_ff * cfg.n_shared_experts) % tp.size:
        return None
    return tp


def _moe_ep(p, cfg, x, tp, split: bool, sp: bool = False):
    """Expert parallelism over ``tp``: the rank holds E / ep experts.  With
    ``split`` each rank routes its sequence slice (``x`` the rank's rows
    already when ``sp``), else all tokens (the expert weights' gradient
    then comes from every rank's identical copy, and is scaled back).
    Returns the rank's (y, aux)."""
    n = tp.size
    x_loc = tensor.shard_seq(x, tp) if split and not sp else x
    b, s, d = x_loc.shape
    t = b * s
    router = tensor.rep_part(p["router"], tp) if split else p["router"]
    experts = [p[k] if split else tensor.scale_grad(p[k], 1.0 / n)
               for k in ("wg", "wu", "wd")]
    x_flat = x_loc.reshape(t, d)
    gw, idx, aux = _route(x_flat, router, cfg)
    cap = _capacity(t, cfg)
    buckets, routing = _pack(x_flat, gw, idx, cap, cfg)
    if _COUNTERS:
        _COUNTERS[-1].add_(_dropped(routing, cap))
    a2a = int8_all_to_all if cfg.moe_dispatch_int8 else all_to_all
    recv = a2a(buckets, tp, 0, 1)            # (E, C, d) -> (E_loc, ep*C, d)
    out = _expert_ffn(recv, *experts)
    back = a2a(out, tp, 1, 0)                # (E_loc, ep*C, d) -> (E, C, d)
    y = _unpack(back, routing, gw, t, d).reshape(b, s, d)
    if not split:
        return y, aux
    aux = tensor.reduce_from(aux, tp) / n
    return (y if sp else tensor.gather_rep(y, tp)), aux


def moe_ffn(p: dict, cfg, x: torch.Tensor, sp: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y, aux_loss).  Adds shared experts if configured
    (column/row-parallel over the "model" axis where their width splits).
    The executor follows the installed rules (the module docstring);
    ``sp``: ``x`` is the rank's rows of a sequence-parallel block (the
    caller checked :func:`ep_context`)."""
    tp = tensor.context()
    if tp is not None and tensor.experts_split(cfg, tp.size):
        per_shard = ep_context(cfg) is not None
        split = sp or (per_shard and x.shape[1] % tp.size == 0)
        y, aux = _moe_ep(p, cfg, x, tp, split, sp)
    else:
        y, aux = _moe_local(p, cfg, x, _data_group())
    if cfg.n_shared_experts:
        shared_tp = tensor.if_divides(tp, cfg.moe_d_ff * cfg.n_shared_experts)
        y = y + swiglu(x, p["shared"], shared_tp, sp)
    return y, aux
