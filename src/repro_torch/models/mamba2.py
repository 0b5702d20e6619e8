"""Mamba2 block (SSD, chunked) for the zamba2 hybrid architecture
(counterpart of ``repro.models.mamba2``).

Prefill uses the chunked state-space-duality form (a loop over sequence
chunks, quadratic within a chunk, linear state hand-off across chunks).
Decode is the O(1) recurrent update.  The depthwise causal conv1d is the
MEC conv hot-spot: with ``cfg.conv_impl == "fused"`` it is the
hand-written kernel K5 (``kernels.ops.mec_conv1d_cuda``) on CUDA tensors
and its plain version on CPU tensors; otherwise the compact-L form
(``core.mec.mec_conv1d_depthwise``), plain PyTorch as in the JAX package.
Decode convolves its k_w-step history with a plain einsum, as the JAX
package does; K5 runs in prefill only.

The published Zamba2 block (``cfg.ssm_groups``, ``cfg.conv_bias``,
``cfg.ssm_chunk``, ``cfg.dt_init``; see
``models.config``) reads B and C in groups, head h from group
h // (heads / groups), adds a bias after the conv, takes the gated
RMSNorm over each group of channels, and draws its dt biases and A as
transformers' Zamba2 does.  Tensor parallelism runs one group only.
Prefill's pieces record the spans ``mamba2.mixer``, ``mamba2.conv1d``
(the conv, its bias and SiLU) and ``mamba2.ssd`` (the scan).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.core.mec import mec_conv1d_depthwise
from repro_torch.kernels.ops import mec_conv1d_cuda
from repro_torch.models.layers import (init_linear, init_normal, linear,
                                       rms_norm)
from repro_torch.parallel import tensor
from repro_torch.parallel.axes import constrain

_F32 = torch.float32


def conv1d(cfg, x, w):
    """MEC conv1d with the configured dataflow: ``"fused"`` is the fused
    kernel's shift-add dataflow (K5), anything else the lowered L."""
    if cfg.conv_impl == "fused":
        return mec_conv1d_cuda(x, w)
    return mec_conv1d_depthwise(x, w)


def _tp(cfg):
    """The tensor-parallel axis where it splits the block's heads."""
    tp = tensor.if_divides(tensor.context(), tensor.mamba_heads(cfg))
    if tp is not None and cfg.ssm_groups > 1:
        raise NotImplementedError("tensor parallelism over B/C groups")
    return tp


def _dims(cfg, tp=None):
    """(d_in, heads, head dim, state) of the block, or of the rank's part
    of it under ``tp``: its heads and their channels (B and C, one group,
    are whole on every rank)."""
    n = 1 if tp is None else tp.size
    d_in = cfg.ssm_expand * cfg.d_model // n
    return d_in, d_in // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state


def _local(p: dict, cfg, tp):
    """The weights the rank computes with: ``in_proj`` and ``conv_w`` with
    the gradients of their replicated B and C columns summed over the
    axis, the per-head vectors' rank's chunks."""
    if tp is None:
        return (p["in_proj"]["w"], p["conv_w"], p["a_log"], p["d_skip"],
                p["dt_bias"])
    d_in, _, _, n = _dims(cfg, tp)
    return (tensor.rep_part(p["in_proj"]["w"], tp, -1,
                            [(2 * d_in, 2 * d_in + 2 * n)]),
            tensor.rep_part(p["conv_w"], tp, -1, [(d_in, d_in + 2 * n)]),
            tensor.rep_slice(p["a_log"], tp), tensor.rep_slice(p["d_skip"], tp),
            tensor.rep_slice(p["dt_bias"], tp))


def init_mamba(generator: torch.Generator, cfg, dtype, device="cuda") -> dict:
    """With ``cfg.dt_init`` (time_step_min, max, floor): dt log-uniform in
    [min, max], floored, its bias softplus^-1(dt), and A = -(1..heads), as
    transformers' ``Zamba2PreTrainedModel._init_weights``; the conv bias
    N(0, 0.2^2) where ``cfg.conv_bias``."""
    d = cfg.d_model
    d_in, h, _, n = _dims(cfg)
    bc = cfg.ssm_groups * n
    conv_ch = d_in + 2 * bc
    kw = {"dtype": _F32, "device": device}
    p = {
        # order: [z (d_in), xBC (d_in + 2 groups n), dt (h)]
        "in_proj": init_linear(generator, d, 2 * d_in + 2 * bc + h, dtype,
                               device=device),
        "conv_w": init_normal(generator, (cfg.conv_width, conv_ch), 0.2,
                              dtype, device),
        "a_log": torch.zeros((h,), **kw),
        "d_skip": torch.ones((h,), **kw),
        "dt_bias": torch.full((h,), -2.0, **kw),
        "norm": torch.ones((d_in,), dtype=dtype, device=device),
        "out_proj": init_linear(generator, d_in, d, dtype, device=device),
    }
    if cfg.conv_bias:
        p["conv_b"] = init_normal(generator, (conv_ch,), 0.2, _F32, device)
    if cfg.dt_init:
        lo, hi, floor = cfg.dt_init
        u = torch.rand((h,), generator=generator, dtype=_F32,
                       device=generator.device)
        dt = torch.exp(u * (math.log(hi) - math.log(lo))
                       + math.log(lo)).clamp(min=floor)
        p["dt_bias"] = (dt + torch.log(-torch.expm1(-dt))).to(device)
        p["a_log"] = torch.log(torch.arange(1, h + 1, **kw))
    return p


def _split_proj(zxbcdt, cfg, tp=None):
    d_in, _, _, n = _dims(cfg, tp)
    bc = cfg.ssm_groups * n
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:2 * d_in + 2 * bc]
    dt = zxbcdt[..., 2 * d_in + 2 * bc:]
    return z, xbc, dt


def _bc(cfg, xbc, d_in: int, n: int):
    """B and C of the convolved channels: (..., N) for one group, else
    (..., groups, N)."""
    bc = cfg.ssm_groups * n
    b, c = xbc[..., d_in:d_in + bc], xbc[..., d_in + bc:]
    if cfg.ssm_groups > 1:
        b, c = (t.unflatten(-1, (cfg.ssm_groups, n)) for t in (b, c))
    return b, c


def _gated_norm(cfg, y, z, w, tp):
    """RMSNorm of ``y`` gated by SiLU(z), over each B/C group's channels
    (all of them with one group)."""
    v = y * F.silu(z.to(_F32)).to(y.dtype)
    g = cfg.ssm_groups
    if g == 1:
        return tensor.rms_norm(v, w, cfg.norm_eps, tp)
    return rms_norm(v.unflatten(-1, (g, -1)), w.view(g, -1),
                    cfg.norm_eps).flatten(-2)


def ssd_chunked(x, dt, a, b_mat, c_mat, chunk: int = 128):
    """Chunked SSD scan.

    x: (B, S, H, P); dt: (B, S, H) (post-softplus); a: (H,) negative;
    b_mat/c_mat: (B, S, N) (single group, broadcast over heads), or
    (B, S, G, N), each group's heads scanned on their own: head h reads
    group h // (H / G).
    Returns y (B, S, H, P) f32 and final state (B, H, P, N).

    The JAX package's four-operand einsum "bln,bsn,blsh,bshp->blhp" is
    contracted C.B first, then the decay, then x.dt, so nothing of size
    (B, c, c, H, P) is formed.
    """
    if b_mat.dim() == 4:
        g = b_mat.shape[2]
        hg = x.shape[2] // g
        parts = [ssd_chunked(x[:, :, k * hg:(k + 1) * hg],
                             dt[..., k * hg:(k + 1) * hg],
                             a[k * hg:(k + 1) * hg], b_mat[:, :, k],
                             c_mat[:, :, k], chunk) for k in range(g)]
        return (torch.cat([y for y, _ in parts], dim=2),
                torch.cat([st for _, st in parts], dim=1))
    bsz, s, h, p_dim = x.shape
    n = b_mat.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"SSD chunk {chunk}")
    nc = s // chunk
    xc, dtc, bc, cc = (t.to(_F32).reshape(bsz, nc, chunk, *t.shape[2:])
                       for t in (x, dt, b_mat, c_mat))
    da = dtc * a.to(_F32)[None, None, None, :]             # (B, nc, c, H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    state = torch.zeros((bsz, h, p_dim, n), dtype=_F32, device=x.device)
    ys = []
    for i in range(nc):
        x_k, dt_k, da_k, b_k, c_k = (xc[:, i], dtc[:, i], da[:, i], bc[:, i],
                                     cc[:, i])
        cs = torch.cumsum(da_k, dim=1)                      # (B, c, H)
        # intra-chunk causal decay L[i,j] = exp(cs_i - cs_j), j <= i
        li = cs[:, :, None, :] - cs[:, None, :, :]          # (B, c, c, H)
        decay = torch.where(tri[None, :, :, None], torch.exp(li), 0.0)
        xdt = x_k * dt_k[..., None]                         # discrete input
        cb = torch.einsum("bln,bsn->bls", c_k, b_k)
        y_diag = torch.einsum("blsh,bshp->blhp", cb[..., None] * decay, xdt)
        # contribution of the incoming state
        g = torch.exp(cs)                                   # decay from chunk start
        y_off = torch.einsum("bln,bhpn->blhp", c_k, state) * g[..., None]
        # state update
        tail = torch.exp(cs[:, -1:, :] - cs)                # decay to chunk end
        state = (state * torch.exp(cs[:, -1, :])[..., None, None]
                 + torch.einsum("bshp,bsn->bhpn", xdt * tail[..., None], b_k))
        ys.append(y_diag + y_off)
    y = torch.stack(ys, dim=1).reshape(bsz, s, h, p_dim)
    return y, state


def mamba_core(p: dict, cfg, x: torch.Tensor, chunk: Optional[int] = None):
    """Full-sequence Mamba2 block. x (B, S, d) -> (out (B,S,d), cache).
    The scan's chunk is ``cfg.ssm_chunk`` unless ``chunk`` is given.
    Under tensor parallelism (heads that divide the "model" axis) the rank
    runs its heads: ``in_proj`` column-parallel per segment (its z, x and
    dt, the whole B and C), the conv (K5 with ``conv_impl="fused"``) on
    its x channels and B and C, the gated norm's mean square all-reduced,
    ``out_proj`` row-parallel; the cache holds the rank's channels."""
    with obs.span("mamba2.mixer"):
        tp = _tp(cfg)
        d_in, h, p_dim, n = _dims(cfg, tp)
        w_in, conv_w, a_log, d_skip, dt_bias = _local(p, cfg, tp)
        zxbcdt = linear(tensor.copy_to(x, tp), {"w": w_in})
        z, xbc_raw, dt = _split_proj(zxbcdt, cfg, tp)
        xbc_raw = constrain(xbc_raw, "batch", "seq", "conv_ch")
        with obs.span("mamba2.conv1d"):
            # xbc_raw is a column slice of zxbcdt: K5 reads it through its
            # strides
            xbc = conv1d(cfg, xbc_raw, conv_w.to(xbc_raw.dtype)).to(_F32)
            if "conv_b" in p:
                xbc = xbc + p["conv_b"]
            xbc = F.silu(xbc).to(x.dtype)
        xs = xbc[..., :d_in].reshape(*x.shape[:2], h, p_dim)
        b_mat, c_mat = _bc(cfg, xbc, d_in, n)
        dt = F.softplus(dt.to(_F32) + dt_bias)
        a = -torch.exp(a_log)
        with obs.span("mamba2.ssd"):
            y, state = ssd_chunked(xs.to(_F32), dt, a, b_mat.to(_F32),
                                   c_mat.to(_F32),
                                   chunk=chunk or cfg.ssm_chunk)
        y = y + xs.to(_F32) * d_skip[None, None, :, None]
        y = y.reshape(*x.shape[:2], d_in).to(x.dtype)
        y = _gated_norm(cfg, y, z, p["norm"], tp)
        # a copy, so the cache does not hold zxbcdt alive
        cache = {"state": state,
                 "conv": xbc_raw[:, x.shape[1] - (cfg.conv_width - 1):,
                                 :].clone(
                     memory_format=torch.contiguous_format)}
        return tensor.reduce_from(linear(y, p["out_proj"]), tp), cache


def mamba_forward(p: dict, cfg, x: torch.Tensor,
                  chunk: Optional[int] = None) -> torch.Tensor:
    return mamba_core(p, cfg, x, chunk)[0]


def init_mamba_cache(cfg, batch: int, dtype, device="cuda") -> dict:
    """Zero state and conv history (the rank's heads and channels under
    tensor parallelism)."""
    d_in, h, p_dim, n = _dims(cfg, _tp(cfg))
    conv_ch = d_in + 2 * cfg.ssm_groups * n
    return {
        "state": torch.zeros((batch, h, p_dim, n), dtype=_F32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_ch), dtype=dtype,
                            device=device),
    }


def mamba_decode(p: dict, cfg, x: torch.Tensor, cache: dict
                 ) -> Tuple[torch.Tensor, dict]:
    """One-token recurrent step. x (B, 1, d).  Returns new cache tensors;
    the given cache is not written."""
    tp = _tp(cfg)
    d_in, h, p_dim, n = _dims(cfg, tp)
    w_in, conv_w, a_log, d_skip, dt_bias = _local(p, cfg, tp)
    zxbcdt = linear(x, {"w": w_in})
    z, xbc, dt = _split_proj(zxbcdt[:, 0], cfg, tp)
    # depthwise conv over (k_w-1 history, current)
    hist = torch.cat([cache["conv"], xbc[:, None, :].to(cache["conv"].dtype)],
                     dim=1)
    conv_out = torch.einsum("bkc,kc->bc", hist.to(_F32), conv_w.to(_F32))
    if "conv_b" in p:
        conv_out = conv_out + p["conv_b"]
    xbc_c = F.silu(conv_out)
    xs = xbc_c[..., :d_in].reshape(-1, h, p_dim)
    b_vec, c_vec = _bc(cfg, xbc_c, d_in, n)
    update, read = "bh,bhp,bn->bhpn", "bhpn,bn->bhp"
    if cfg.ssm_groups > 1:            # head h reads group h // (H / G)
        b_vec, c_vec = (t.repeat_interleave(h // cfg.ssm_groups, dim=1)
                        for t in (b_vec, c_vec))
        update, read = "bh,bhp,bhn->bhpn", "bhpn,bhn->bhp"
    dt = F.softplus(dt.to(_F32) + dt_bias)                       # (B, H)
    a = -torch.exp(a_log)
    da = torch.exp(dt * a[None, :])                              # (B, H)
    state = (cache["state"] * da[..., None, None]
             + torch.einsum(update, dt, xs, b_vec))
    y = torch.einsum(read, state, c_vec)
    y = y + xs * d_skip[None, :, None]
    y = y.reshape(-1, 1, d_in).to(x.dtype)
    y = _gated_norm(cfg, y, z[:, None, :], p["norm"], tp)
    new_cache = {"state": state, "conv": hist[:, 1:, :]}
    return tensor.reduce_from(linear(y, p["out_proj"]), tp), new_cache
