"""Mixture-of-Experts FFN (counterpart of ``repro.models.moe``): top-k
token-choice routing with capacity buckets, all experts resident on one
device.

``moe_ffn`` runs the local executor (``_moe_local``) whenever no mesh is
given, which is the JAX package's choice whenever no sharding rules are
active, ``moe_impl="ep"`` included (both full-size configs set it).  The
expert-parallel executor over a mesh (the JAX package's ``_moe_ep``) and
its int8 all-to-all (``_q8``, ``int8_all_to_all``) are distributed
execution: ``moe_ffn(..., mesh=...)``, ``_moe_ep``, ``_q8`` and
``int8_all_to_all`` raise ``NotImplementedError`` naming ROADMAP Queue 1
item 11.

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
import torch.nn.functional as F

from repro_torch.models.layers import init_normal, init_swiglu, swiglu

_F32 = torch.float32
#: ROADMAP item of the distributed executors
EP_ITEM = "distributed execution, ROADMAP Queue 1 item 11"
#: most f32 elements one draw of :func:`chunked_normal` holds at a time
DRAW_ELEMENTS = 1 << 28


def chunked_normal(generator: torch.Generator, shape, scale: float, dtype,
                   device) -> torch.Tensor:
    """N(0, scale^2) in ``dtype`` of ``shape``, drawn as
    :func:`~repro_torch.models.layers.init_normal` draws, but in chunks of
    the leading axes of at most :data:`DRAW_ELEMENTS` f32 elements each,
    written into one buffer: no f32 copy of the whole leaf (kimi-k2's
    (384, 7168, 2048) expert leaf would take 22.5 GB)."""
    shape = tuple(shape)
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1, *shape[-2:]) if len(shape) > 2 else out.view(1, *shape)
    per = math.prod(flat.shape[1:])
    step = max(1, DRAW_ELEMENTS // per)
    for i in range(0, flat.shape[0], step):
        n = min(step, flat.shape[0] - i)
        flat[i:i + n] = init_normal(generator, (n,) + tuple(flat.shape[1:]),
                                    scale, dtype, device)
    return out


def init_moe(generator: torch.Generator, cfg, dtype, device="cuda",
             prefix: Tuple[int, ...] = ()) -> dict:
    """The router (f32 in any model dtype, as the JAX package's), the
    experts' gate, up and down weights (E, d, f), (E, d, f), (E, f, d) in
    ``dtype``, and the shared experts' SwiGLU when configured; every leaf
    stacked over ``prefix`` (the layers), the expert leaves drawn in
    chunks (:func:`chunked_normal`)."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    p = {
        "router": chunked_normal(generator, prefix + (d, e), d ** -0.5, _F32,
                                 device),
        "wg": chunked_normal(generator, prefix + (e, d, f), d ** -0.5, dtype,
                             device),
        "wu": chunked_normal(generator, prefix + (e, d, f), d ** -0.5, dtype,
                             device),
        "wd": chunked_normal(generator, prefix + (e, f, d), f ** -0.5, dtype,
                             device),
    }
    if cfg.n_shared_experts:
        from repro_torch.models.lm import stack_init
        p["shared"] = stack_init(
            lambda: init_swiglu(generator, d, f * cfg.n_shared_experts, dtype,
                                device=device), prefix)
    return p


def _capacity(t: int, cfg) -> int:
    c = int(math.ceil(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(4, -(-c // 4) * 4)


def _route(x_flat: torch.Tensor, router_w: torch.Tensor, cfg):
    """x_flat (T, d) -> gate weights (T, k) f32, expert ids (T, k), aux
    loss (0-d f32)."""
    logits = torch.matmul(x_flat.to(_F32), router_w.to(_F32))
    probs = torch.softmax(logits, dim=-1)
    gw, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gw = gw / torch.clamp(gw.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance aux: E * sum_e f_e * p_e
    e = cfg.n_experts
    fracs = torch.mean(_one_hot(idx, e, _F32).sum(1), dim=0)
    aux = e * torch.sum(fracs * torch.mean(probs, dim=0)) / cfg.top_k
    return gw, idx, aux


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """One-hot by comparison (``F.one_hot`` checks its ids on the host)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _pack(x_flat, gw, idx, capacity: int, cfg):  # lint-ignore: accepted-kwarg-not-forwarded
    """Scatter tokens into (E, C, d) capacity buckets.  Returns the buckets
    (a view of an (E, C + 1, d) buffer whose row C took the dropped
    assignments) and the routing (expert ids, positions with the dropped
    ones at C, token ids; each (T * k,)).  ``gw`` is applied at unpack."""
    t, d = x_flat.shape
    k, e = cfg.top_k, cfg.n_experts
    e_idx = idx.reshape(-1).long()                                # (T*k,)
    tok_idx = torch.arange(t, device=x_flat.device).repeat_interleave(k)
    onehot = _one_hot(e_idx, e, torch.int32)                      # (T*k, E)
    pos = torch.take_along_dim(torch.cumsum(onehot, dim=0) - 1,
                               e_idx[:, None], dim=1)[:, 0]
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


def _moe_local(p, cfg, x):
    b, s, d = x.shape
    x_flat = x.reshape(b * s, d)
    gw, idx, aux = _route(x_flat, p["router"], cfg)
    cap = _capacity(b * s, cfg)
    buckets, routing = _pack(x_flat, gw, idx, cap, cfg)
    if _COUNTERS:
        _COUNTERS[-1].add_(_dropped(routing, cap))
    out = _expert_ffn(buckets, p["wg"], p["wu"], p["wd"])
    y = _unpack(out, routing, gw, b * s, d).reshape(b, s, d)
    return y, aux


def _q8(x):
    raise NotImplementedError(f"the int8 EP all-to-all: {EP_ITEM}")


def int8_all_to_all(x, ep, split_axis, concat_axis):
    raise NotImplementedError(f"the int8 EP all-to-all: {EP_ITEM}")


def _moe_ep(p, cfg, x, mesh):
    raise NotImplementedError(f"expert-parallel MoE over a mesh: {EP_ITEM}")


def moe_ffn(p: dict, cfg, x: torch.Tensor, mesh=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y, aux_loss).  Adds shared experts if configured.
    Local dispatch whatever ``cfg.moe_impl``; a mesh raises item 11."""
    if mesh is not None:
        return _moe_ep(p, cfg, x, mesh)
    y, aux = _moe_local(p, cfg, x)
    if cfg.n_shared_experts:
        y = y + swiglu(x, p["shared"])
    return y, aux
