"""xLSTM blocks (Beck et al., 2024) for the ssm family (counterpart of
``repro.models.xlstm``): mLSTM (matrix memory, parallelizable) and sLSTM
(scalar memory, sequential scan).

mLSTM prefill uses the stabilized parallel (quadratic) form, chunked over
queries; decode is the O(1) matrix-memory update.  sLSTM is an
exponential-gated recurrent scan with head-wise block-diagonal
recurrence; the JAX package's ``lax.scan`` over the sequence is a Python
loop here.  Both blocks open with a causal depthwise conv1d, the MEC
conv1d hot spot, through ``models.mamba2.conv1d``: with ``cfg.conv_impl
== "fused"`` it is the hand-written kernel K5 on CUDA tensors (reading
the strided ``x_in`` view of the up projection without a copy) and its
plain version on CPU tensors, otherwise the compact-L form.  Decode
convolves its k_w-step f32 history with a plain einsum, as the JAX
package does; K5 runs in prefill only.

Parameters keep the JAX package's tree and leaf names, so
``convert.params_from_jax`` maps leaf for leaf.  The decode functions
write the new state and conv history into the caller's cache buffers in
place (the JAX package returns updated copies), each new value computed
in full before its buffer is written.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import init_linear, init_normal, linear
from repro_torch.models.mamba2 import conv1d
from repro_torch.parallel import tensor

_F32 = torch.float32
_NEG = -1e30


def _tp(cfg):
    """The tensor-parallel axis where it splits the blocks' heads."""
    return tensor.if_divides(tensor.context(), cfg.n_heads)


def _dims(cfg, tp=None):
    """(d_in, heads, head dim), or the rank's channels and heads under
    ``tp``."""
    n = 1 if tp is None else tp.size
    d_in = 2 * cfg.d_model
    h = cfg.n_heads
    return d_in // n, h // n, d_in // h


def _gather(t: torch.Tensor, tp) -> torch.Tensor:
    """The ranks' channels of ``t`` (..., C_loc) all-gathered, the input of
    a projection by heads (its cotangent reduce-scattered back)."""
    return t if tp is None else tensor.gather_seq(t, tp, dim=t.dim() - 1)


def _history(x_in: torch.Tensor, k_w: int) -> torch.Tensor:
    """The last k_w - 1 steps of ``x_in`` (B, S, C) as a contiguous f32
    tensor of their own (not a view that keeps the projection alive)."""
    s = x_in.shape[1]
    return x_in[:, s - (k_w - 1):, :].to(_F32).clone(
        memory_format=torch.contiguous_format)


def _conv_step(hist: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One causal conv1d step over a (B, k_w, C) f32 history."""
    return torch.einsum("bkc,kc->bc", hist, w.to(_F32))


def _write(cache: dict, new: dict) -> dict:
    for name, val in new.items():
        cache[name].copy_(val)
    return cache


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(generator: torch.Generator, cfg, dtype, device="cuda") -> dict:
    d = cfg.d_model
    d_in, h, _ = _dims(cfg)
    return {
        "up": init_linear(generator, d, 2 * d_in, dtype, device=device),
        "conv_w": init_normal(generator, (cfg.conv_width, d_in), 0.2, dtype,
                              device),
        "wq": init_linear(generator, d_in, d_in, dtype, device=device),
        "wk": init_linear(generator, d_in, d_in, dtype, device=device),
        "wv": init_linear(generator, d_in, d_in, dtype, device=device),
        "wif": init_linear(generator, d_in, 2 * h, dtype, bias=True,
                           device=device),
        "norm": torch.ones((d_in,), dtype=dtype, device=device),
        "down": init_linear(generator, d_in, d, dtype, device=device),
    }


def _wif(p, cfg, tp) -> dict:
    """``wif`` (replicated): the rank's heads' columns of its i and f
    halves."""
    if tp is None:
        return p["wif"]
    h, hl = cfg.n_heads, cfg.n_heads // tp.size
    lo = tp.rank * hl
    return {k: torch.cat([tensor.rep_part(v, tp).narrow(-1, lo, hl),
                          tensor.rep_part(v, tp).narrow(-1, h + lo, hl)], -1)
            for k, v in p["wif"].items()}


def _mlstm_gates(p, xc, cfg, tp=None):
    _, h, _ = _dims(cfg, tp)
    g = linear(xc, _wif(p, cfg, tp)).to(_F32)         # (B, S, 2H)
    log_i = g[..., :h]
    log_f = F.logsigmoid(g[..., h:] + 3.0)            # bias toward remember
    return log_i, log_f


def mlstm_parallel(q, k, v, log_i, log_f, q_chunk: int = 256):
    """Stabilized parallel mLSTM.

    q,k,v: (B, S, H, P); log_i/log_f: (B, S, H).
    D[i,j] = F_i - F_j + I_j (j <= i), F = cumsum(log_f).
    h_t = (sum_j exp(D[t,j] - m_t) q_t.k_j v_j) / max(|den|, exp(-m_t)),
    m_t = max(max_j D[t,j], -P * 10).  The JAX package's map over query
    chunks is a loop; the last chunk is padded as there.
    """
    b, s, h, p = q.shape
    q_chunk = min(q_chunk, s)
    pad = (-s) % q_chunk
    f_cum = torch.cumsum(log_f, dim=1)                      # (B, S, H)
    kt = k.to(_F32) * p ** -0.5
    vt = v.to(_F32)
    bias_k = (log_i - f_cum).transpose(1, 2)                # (B, H, S): I_j - F_j
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        f_cum = F.pad(f_cum, (0, 0, 0, pad))
    kpos = torch.arange(s, device=q.device)
    outs = []
    for iq in range((s + pad) // q_chunk):
        rows = slice(iq * q_chunk, (iq + 1) * q_chunk)
        q_i = q[:, rows].to(_F32)                           # (B, c, H, P)
        f_i = f_cum[:, rows].transpose(1, 2)                # (B, H, c)
        scores = torch.einsum("bthp,bshp->bhts", q_i, kt)   # (B, H, c, S)
        dmat = f_i[:, :, :, None] + bias_k[:, :, None, :]
        qpos = iq * q_chunk + torch.arange(q_chunk, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        dmat = torch.where(mask[None, None], dmat, _NEG)
        m = torch.clamp(dmat.amax(dim=-1), min=-p * 10.0)   # (B, H, c)
        w = torch.exp(dmat - m[..., None]) * scores
        den = torch.maximum(w.sum(dim=-1).abs(), torch.exp(-m))
        outs.append(torch.einsum("bhts,bshp->bthp", w, vt)
                    / den.transpose(1, 2)[..., None])
    return torch.cat(outs, dim=1)[:, :s]


def _mlstm_inputs(p, cfg, x, tp=None):
    """The block's projections: x_in (a strided view of ``up``), z, and the
    conv's q, k, v and gates.  Under ``tp`` the rank's x_in and z channels
    (``up`` per segment), the conv (K5 with ``conv_impl="fused"``) on its
    x_in channels, the conv output and x_in all-gathered before the
    projections by heads, and its heads' q, k, v and gates."""
    d_in, h, pd = _dims(cfg, tp)
    b, s, _ = x.shape
    up = linear(tensor.copy_to(x, tp), p["up"])
    x_in, z = up[..., :d_in], up[..., d_in:]
    # x_in's time stride is 2 d_in: K5 reads it through its strides
    xc = conv1d(cfg, x_in, p["conv_w"].to(x_in.dtype))
    xc = _gather(F.silu(xc.to(_F32)).to(x.dtype), tp)
    q = linear(xc, p["wq"]).reshape(b, s, h, pd)
    k = linear(xc, p["wk"]).reshape(b, s, h, pd)
    v = linear(_gather(x_in, tp), p["wv"]).reshape(b, s, h, pd)
    log_i, log_f = _mlstm_gates(p, xc, cfg, tp)
    return x_in, z, q, k, v, log_i, log_f


def _mlstm_out(p, cfg, out, z, x, tp=None):
    """The norm (over all channels: the rank's mean square all-reduced),
    the z gate and the row-parallel ``down``."""
    b, s = x.shape[:2]
    out = out.reshape(b, s, -1).to(x.dtype)
    out = tensor.rms_norm(out, p["norm"], cfg.norm_eps, tp)
    out = out * F.silu(z.to(_F32)).to(x.dtype)
    return tensor.reduce_from(linear(out, p["down"]), tp)


def mlstm_forward(p: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    tp = _tp(cfg)
    _, z, q, k, v, log_i, log_f = _mlstm_inputs(p, cfg, x, tp)
    out = mlstm_parallel(q, k, v, log_i, log_f, q_chunk=cfg.q_chunk)
    return _mlstm_out(p, cfg, out, z, x, tp)


def mlstm_prefill(p: dict, cfg, x: torch.Tensor):
    """Forward over a full sequence AND build the decode cache.

    The recurrent state after S tokens has the closed form
      m = max(F_S, max_j (F_S - F_j + I_j))
      C = sum_j exp(F_S - F_j + I_j - m) k_j v_j^T,   n likewise.
    """
    tp = _tp(cfg)
    _, _, pd = _dims(cfg)
    x_in, z, q, k, v, log_i, log_f = _mlstm_inputs(p, cfg, x, tp)
    out = mlstm_parallel(q, k, v, log_i, log_f, q_chunk=cfg.q_chunk)
    f_cum = torch.cumsum(log_f, dim=1)                      # (B, S, H)
    f_s = f_cum[:, -1, :]                                   # (B, H)
    bias = f_s[:, None, :] - f_cum + log_i                  # (B, S, H)
    m = torch.maximum(f_s, bias.amax(dim=1))                # (B, H)
    w = torch.exp(bias - m[:, None, :])                     # (B, S, H)
    kf = k.to(_F32) * pd ** -0.5
    cache = {"c": torch.einsum("bsh,bshp,bsho->bhpo", w, kf, v.to(_F32)),
             "n": torch.einsum("bsh,bshp->bhp", w, kf),
             "m": m,
             "conv": _history(x_in, cfg.conv_width)}
    return _mlstm_out(p, cfg, out, z, x, tp), cache


def init_mlstm_cache(cfg, batch: int, device="cuda") -> dict:
    """Zero mLSTM state (the rank's heads and channels under tensor
    parallelism)."""
    d_in, h, pd = _dims(cfg, _tp(cfg))
    kw = {"dtype": _F32, "device": device}
    return {
        "c": torch.zeros((batch, h, pd, pd), **kw),         # matrix memory
        "n": torch.zeros((batch, h, pd), **kw),
        "m": torch.zeros((batch, h), **kw),
        "conv": torch.zeros((batch, cfg.conv_width - 1, d_in), **kw),
    }


def mlstm_decode(p: dict, cfg, x: torch.Tensor, cache: dict
                 ) -> Tuple[torch.Tensor, dict]:
    """One-token step. x (B, 1, d).  Writes the new c, n, m and conv
    history into ``cache``'s buffers and returns (out (B, 1, d), cache)."""
    tp = _tp(cfg)
    d_in, h, pd = _dims(cfg, tp)
    b = x.shape[0]
    up = linear(x[:, 0], p["up"])
    x_in, z = up[..., :d_in], up[..., d_in:]
    hist = torch.cat([cache["conv"], x_in[:, None, :].to(_F32)], dim=1)
    xc = _gather(F.silu(_conv_step(hist, p["conv_w"])).to(x.dtype), tp)
    q = linear(xc, p["wq"]).reshape(b, h, pd).to(_F32)
    k = linear(xc, p["wk"]).reshape(b, h, pd).to(_F32) * pd ** -0.5
    v = linear(_gather(x_in, tp), p["wv"]).reshape(b, h, pd).to(_F32)
    g = linear(xc, _wif(p, cfg, tp)).to(_F32)
    log_i = g[..., :h]
    log_f = F.logsigmoid(g[..., h:] + 3.0)
    m_old = cache["m"]
    m_new = torch.maximum(log_f + m_old, log_i)
    fw = torch.exp(log_f + m_old - m_new)[..., None]
    iw = torch.exp(log_i - m_new)[..., None]
    c_new = (cache["c"] * fw[..., None]
             + iw[..., None] * (k[..., :, None] * v[..., None, :]))
    n_new = cache["n"] * fw + iw * k
    num = torch.einsum("bhp,bhpo->bho", q, c_new)
    den = torch.maximum(torch.einsum("bhp,bhp->bh", q, n_new).abs(),
                        torch.exp(-m_new))[..., None]
    out = (num / den).reshape(b, 1, d_in).to(x.dtype)
    out = tensor.rms_norm(out, p["norm"], cfg.norm_eps, tp)
    out = out * F.silu(z.to(_F32)).to(x.dtype)[:, None, :]
    _write(cache, {"c": c_new, "n": n_new, "m": m_new, "conv": hist[:, 1:]})
    return tensor.reduce_from(linear(out, p["down"]), tp), cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(generator: torch.Generator, cfg, dtype, device="cuda") -> dict:
    d = cfg.d_model
    d_in, h, pd = _dims(cfg)
    return {
        "up": init_linear(generator, d, d_in, dtype, device=device),
        "conv_w": init_normal(generator, (cfg.conv_width, d_in), 0.2, dtype,
                              device),
        "w_gates": init_linear(generator, d_in, 4 * d_in, dtype, bias=True,
                               device=device),
        # head-wise block-diagonal recurrence: h (H, P) -> gates (H, 4P)
        "r_gates": init_normal(generator, (h, 4 * pd, pd), pd ** -0.5, dtype,
                               device),
        "norm": torch.ones((d_in,), dtype=dtype, device=device),
        "down": init_linear(generator, d_in, d, dtype, device=device),
    }


def _slstm_cell(r32, xg, state):
    """One sLSTM step. xg: (B, 4*d_in) pre-activations from the input path;
    r32 the recurrence ``r_gates`` in f32 (its heads: the rank's under
    tensor parallelism); gates z, i, f, o in that order over the last axis
    of (B, H, 4P)."""
    h, pd = r32.shape[0], r32.shape[-1]
    c, n, m, h_prev = state
    rec = torch.einsum("bhp,hqp->bhq", h_prev, r32)
    g = xg.reshape(-1, h, 4 * pd).to(_F32) + rec
    zi, ii, fi, oi = torch.split(g, pd, dim=-1)          # (B, H, P) each
    z = torch.tanh(zi)
    o = torch.sigmoid(oi)
    log_i = ii
    log_f = F.logsigmoid(fi + 3.0)
    m_new = torch.maximum(log_f + m, log_i)
    c_new = torch.exp(log_f + m - m_new) * c + torch.exp(log_i - m_new) * z
    n_new = torch.exp(log_f + m - m_new) * n + torch.exp(log_i - m_new)
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, m_new, h_new), h_new


def _w_gates(p, tp) -> dict:
    """``w_gates`` (its columns split by heads) with the rank's chunk of
    its replicated bias."""
    if tp is None:
        return p["w_gates"]
    return {"w": p["w_gates"]["w"],
            "b": tensor.rep_slice(p["w_gates"]["b"], tp)}


def slstm_core(p: dict, cfg, x: torch.Tensor):
    """Full-sequence sLSTM block. x (B, S, d) -> (out (B, S, d), cache).
    Under tensor parallelism the rank's ``up`` channels and conv, the conv
    output all-gathered, its heads' gates and scan, the norm's mean square
    all-reduced and a row-parallel ``down``."""
    tp = _tp(cfg)
    d_in, h, pd = _dims(cfg, tp)
    b, s, _ = x.shape
    x_in = linear(tensor.copy_to(x, tp), p["up"])
    xc = conv1d(cfg, x_in, p["conv_w"].to(x_in.dtype))
    xc = _gather(F.silu(xc.to(_F32)).to(x.dtype), tp)
    xg = linear(xc, _w_gates(p, tp))                     # (B, S, 4*d_in)
    r32 = p["r_gates"].to(_F32)
    state = tuple(torch.zeros((b, h, pd), dtype=_F32, device=x.device)
                  for _ in range(4))
    hs = []
    for t in range(s):
        state, h_t = _slstm_cell(r32, xg[:, t], state)
        hs.append(h_t)
    out = torch.stack(hs, dim=1).reshape(b, s, d_in).to(x.dtype)
    out = tensor.rms_norm(out, p["norm"], cfg.norm_eps, tp)
    cache = {"c": state[0], "n": state[1], "m": state[2], "h": state[3],
             "conv": _history(x_in, cfg.conv_width)}
    return tensor.reduce_from(linear(out, p["down"]), tp), cache


def slstm_forward(p: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    return slstm_core(p, cfg, x)[0]


def init_slstm_cache(cfg, batch: int, device="cuda") -> dict:
    """Zero sLSTM state (the rank's heads and channels under tensor
    parallelism)."""
    d_in, h, pd = _dims(cfg, _tp(cfg))
    kw = {"dtype": _F32, "device": device}
    return {
        "c": torch.zeros((batch, h, pd), **kw),
        "n": torch.zeros((batch, h, pd), **kw),
        "m": torch.zeros((batch, h, pd), **kw),
        "h": torch.zeros((batch, h, pd), **kw),
        "conv": torch.zeros((batch, cfg.conv_width - 1, d_in), **kw),
    }


def slstm_decode(p: dict, cfg, x: torch.Tensor, cache: dict
                 ) -> Tuple[torch.Tensor, dict]:
    """One-token step. x (B, 1, d).  Writes the new c, n, m, h and conv
    history into ``cache``'s buffers and returns (out (B, 1, d), cache)."""
    tp = _tp(cfg)
    d_in, _, _ = _dims(cfg, tp)
    b = x.shape[0]
    x_in = linear(x[:, 0], p["up"])
    hist = torch.cat([cache["conv"], x_in[:, None, :].to(_F32)], dim=1)
    xc = _gather(F.silu(_conv_step(hist, p["conv_w"])).to(x.dtype), tp)
    xg = linear(xc, _w_gates(p, tp))
    state = (cache["c"], cache["n"], cache["m"], cache["h"])
    (c, n, m, h_new), _ = _slstm_cell(p["r_gates"].to(_F32), xg, state)
    out = h_new.reshape(b, 1, d_in).to(x.dtype)
    out = tensor.rms_norm(out, p["norm"], cfg.norm_eps, tp)
    _write(cache, {"c": c, "n": n, "m": m, "h": h_new, "conv": hist[:, 1:]})
    return tensor.reduce_from(linear(out, p["down"]), tp), cache
