"""Model primitives (counterpart of ``repro.models.layers``): norms,
linear, the conv layer, RoPE, SwiGLU and GQA attention.

Attention comes in three forms, as in the JAX package:
* ``chunked_attention`` — streaming (flash-style) online-softmax attention
  for prefill: O(S^2) FLOPs, O(S * chunk) memory.
* ``chunked_attention_tri`` — the same, causal, visiting only the chunk
  pairs below the diagonal (``cfg.attn_skip_masked``).
* ``decode_attention``  — one new query against a KV cache, float or int8
  (``quantize_kv``: per token and head scales, ``cfg.kv_cache_int8``).

The order of casts is the JAX package's, so bf16 results agree: norms
normalise in f32 and cast before the weight; ``linear`` accumulates in f32
and casts once; activations run in f32 and are cast; attention scores and
the probability-weighted sum accumulate in f32.  ``linear`` runs the GEMM
in the input dtype, which accumulates in f32 on the CPU and, under
:func:`f32_accumulation`, in cuBLAS.  The JAX package's sharding
annotations are kept (``parallel.axes.constrain``): on a rank's local
tensor they are checks, not layouts.

Parameters are drawn from an explicit ``torch.Generator`` with the JAX
package's distributions and scales; the streams differ from
``jax.random``'s, so parity tests carry JAX parameters across with
``convert.params_from_jax``.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.conv_api import conv2d
from repro_torch.parallel import tensor
from repro_torch.parallel.axes import constrain

_NEG = -1e30


@contextlib.contextmanager
def f32_accumulation():
    """Run cuBLAS products with f32 accumulation throughout: no TF32 for
    f32 operands and no reduced-precision split-K reductions for bf16/f16
    (the JAX package's ``preferred_element_type=float32``); restore the
    previous settings after."""
    m = torch.backends.cuda.matmul
    names = ("allow_tf32", "allow_bf16_reduced_precision_reduction",
             "allow_fp16_reduced_precision_reduction")
    prev = [getattr(m, n) for n in names]
    for n in names:
        setattr(m, n, False)
    try:
        yield
    finally:
        for n, v in zip(names, prev):
            setattr(m, n, v)


def init_normal(generator: torch.Generator, shape, scale: float, dtype,
                device) -> torch.Tensor:
    """N(0, scale^2) drawn in f32 on the generator's device, then cast and
    moved, as ``jax.random.normal(..., float32) * scale`` then astype."""
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * scale).to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# basics
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    y = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def init_linear(generator: torch.Generator, d_in: int, d_out: int, dtype,
                bias: bool = False, scale: Optional[float] = None,
                device="cuda") -> dict:
    scale = scale if scale is not None else d_in ** -0.5
    p = {"w": init_normal(generator, (d_in, d_out), scale, dtype, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def init_conv2d(generator: torch.Generator, k_h: int, k_w: int, c_in: int,
                c_out: int, dtype: torch.dtype = torch.float32,
                bias: bool = True, device="cuda") -> dict:
    """HWIO weights ~ N(0, 1/(k_h*k_w*c_in)) drawn from ``generator`` on
    the generator's device, then moved to ``device``; zero bias."""
    p = {"w": init_normal(generator, (k_h, k_w, c_in, c_out),
                          (k_h * k_w * c_in) ** -0.5, dtype, device)}
    if bias:
        p["b"] = torch.zeros((c_out,), dtype=dtype, device=device)
    return p


def conv2d_layer(p: dict, x: torch.Tensor, *, stride=1, padding="SAME",
                 algorithm: str = "auto", partition=None,
                 plan=None) -> torch.Tensor:
    """One conv block through the front-end (``core.conv_api.conv2d``):
    the weights follow the activations' dtype, then the bias is added.
    partition goes to ``conv2d`` (None: rules-aware).  plan (a resolved
    ``repro_torch.plan.ConvPlan``) wins over algorithm: resolve it once
    with :func:`plan_conv2d_layer` instead of per step."""
    y = conv2d(x, p["w"].to(x.dtype), stride=stride, padding=padding,
               algorithm=algorithm, partition=partition, plan=plan)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def plan_conv2d_layer(p: dict, x_shape: Tuple[int, ...], *, stride=1,
                      padding="SAME", dtype=torch.float32,
                      mode: str = "cached", backend: Optional[str] = None):
    """Resolve the layer's ConvPlan once, at construction: x_shape and
    dtype describe the activations the layer will see (the weights follow
    their dtype, as :func:`conv2d_layer` casts them), backend the device
    type they will live on (default: the weights').  Pass the frozen plan
    to every ``conv2d_layer(..., plan=)`` step, so a training or serving
    loop never re-derives, or re-measures, the decision per call."""
    from repro_torch.core.conv_api import conv2d_spec
    from repro_torch.plan import plan_conv2d
    spec = conv2d_spec(torch.empty(tuple(x_shape), device="meta"), p["w"],
                       stride=stride, padding=padding)
    return plan_conv2d(spec, dtype=dtype, mode=mode,
                       backend=backend or p["w"].device.type)


def swiglu(x: torch.Tensor, p: dict, tp=None, sp: bool = False
           ) -> torch.Tensor:
    """The SwiGLU MLP; under ``tp`` (a ``parallel.tensor.TP`` whose axis
    splits the hidden width) column-parallel gate/up and a row-parallel
    down, all-reduced, or with ``sp`` all-gathered in over the sequence
    and reduce-scattered out."""
    x = tensor.enter(x, tp, sp)
    g = linear(x, p["gate"])
    u = linear(x, p["up"])
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    h = constrain(h, "batch", "seq", "ffn")
    return tensor.leave(linear(h, p["down"]), tp, sp)


def init_swiglu(generator: torch.Generator, d: int, f: int, dtype,
                device="cuda") -> dict:
    return {"gate": init_linear(generator, d, f, dtype, device=device),
            "up": init_linear(generator, d, f, dtype, device=device),
            "down": init_linear(generator, f, d, dtype, device=device)}


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float):
    """positions (S,) -> cos/sin (S, dim//2) in f32."""
    exps = -torch.arange(0, dim, 2, dtype=torch.float32,
                         device=positions.device) / dim
    # torch.full, not torch.tensor: no host-to-device copy, so a CUDA
    # graph can capture it
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32,
                                 device=positions.device), exps)
    ang = positions.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (..., S, H, D); cos/sin (S, D//2).  Split-half (llama) convention."""
    d2 = x.shape[-1] // 2
    c = cos[..., :, None, :].to(torch.float32)
    s = sin[..., :, None, :].to(torch.float32)
    x1f, x2f = x[..., :d2].to(torch.float32), x[..., d2:].to(torch.float32)
    return torch.cat([x1f * c - x2f * s, x2f * c + x1f * s],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# streaming GQA attention (prefill)
# ---------------------------------------------------------------------------

def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(t, (0, 0, 0, 0, 0, pad)) if pad else t


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, q_chunk: int = 512,
                      kv_chunk: int = 1024,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Online-softmax attention.

    q: (B, Sq, H, D); k, v: (B, Skv, KV, D) with H % KV == 0.
    Returns (B, Sq, H, D) in q.dtype.  Assumes Sq == Skv when causal.
    ``scale`` multiplies the scores (None: D ** -0.5).
    The JAX package's scan over kv chunks and map over q chunks are loops.
    """
    b, sq, h, d = q.shape
    _, skv, kv, _ = k.shape
    g = h // kv
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    pq, pk = (-sq) % q_chunk, (-skv) % kv_chunk
    q, k, v = _pad_seq(q, pq), _pad_seq(k, pk), _pad_seq(v, pk)
    nq, nk = (sq + pq) // q_chunk, (skv + pk) // kv_chunk
    scale = d ** -0.5 if scale is None else scale
    f32 = torch.float32

    qc = q.reshape(b, nq, q_chunk, kv, g, d).permute(1, 0, 3, 4, 2, 5)
    kc = k.reshape(b, nk, kv_chunk, kv, d).permute(1, 0, 3, 2, 4)
    vc = v.reshape(b, nk, kv_chunk, kv, d).permute(1, 0, 3, 2, 4)
    # qc: (nq, B, KV, G, Tq, D); kc/vc: (nk, B, KV, Tk, D)
    dev = q.device
    outs = []
    for iq in range(nq):
        q_i = qc[iq].to(f32)
        qpos = iq * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((b, kv, g, q_chunk), _NEG, dtype=f32, device=dev)
        l = torch.zeros((b, kv, g, q_chunk), dtype=f32, device=dev)
        acc = torch.zeros((b, kv, g, q_chunk, d), dtype=f32, device=dev)
        for ik in range(nk):
            k_j, v_j = kc[ik], vc[ik]
            s = torch.einsum("bkgtd,bkcd->bkgtc", q_i, k_j.to(f32)) * scale
            kpos = ik * kv_chunk + torch.arange(kv_chunk, device=dev)
            mask = kpos[None, :] < skv                       # kv padding
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            s = torch.where(mask[None, None, None], s, _NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgtc,bkcd->bkgtd", p.to(v_j.dtype).to(f32), v_j.to(f32))
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(outs)
    # (nq, B, KV, G, Tq, D) -> (B, S, H, D)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(b, sq + pq, h, d)
    return out[:, :sq].to(q.dtype)


def chunked_attention_tri(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_chunk: int = 512, kv_chunk: int = 512,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Causal attention that only visits lower-triangle chunk pairs.

    :func:`chunked_attention` computes every (q-chunk, kv-chunk) pair and
    masks; here the loop runs over the static list of pairs that are not
    fully masked, carrying full-sequence (m, l, acc) accumulators and
    updating one q-chunk's rows per step, as the JAX package's scan does.
    A fully masked chunk adds exactly 0 to the online softmax (its scores
    are -1e30, so p = 0 and the correction is exp(0) = 1), so with the same
    chunks the result equals :func:`chunked_attention`'s to the bit.
    """
    b, s, h, d = q.shape
    _, skv, kv, _ = k.shape
    g = h // kv
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, skv)
    pq, pk = (-s) % q_chunk, (-skv) % kv_chunk
    q, k, v = _pad_seq(q, pq), _pad_seq(k, pk), _pad_seq(v, pk)
    sqp, skp = s + pq, skv + pk
    nq, nk = sqp // q_chunk, skp // kv_chunk
    scale = d ** -0.5 if scale is None else scale
    f32 = torch.float32
    qc = q.reshape(b, nq, q_chunk, kv, g, d).permute(1, 0, 3, 4, 2, 5)
    kc = k.reshape(b, nk, kv_chunk, kv, d).permute(1, 0, 3, 2, 4)
    vc = v.reshape(b, nk, kv_chunk, kv, d).permute(1, 0, 3, 2, 4)
    pairs = [(i, j) for i in range(nq) for j in range(nk)
             if j * kv_chunk <= (i + 1) * q_chunk - 1]
    dev = q.device
    m = torch.full((b, kv, g, sqp), _NEG, dtype=f32, device=dev)
    l = torch.zeros((b, kv, g, sqp), dtype=f32, device=dev)
    acc = torch.zeros((b, kv, g, sqp, d), dtype=f32, device=dev)
    for iq, jk in pairs:
        q_i, k_j, v_j = qc[iq].to(f32), kc[jk], vc[jk]
        sc = torch.einsum("bkgtd,bkcd->bkgtc", q_i, k_j.to(f32)) * scale
        qpos = iq * q_chunk + torch.arange(q_chunk, device=dev)
        kpos = jk * kv_chunk + torch.arange(kv_chunk, device=dev)
        mask = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < skv)
        sc = torch.where(mask[None, None, None], sc, _NEG)
        rows = slice(iq * q_chunk, (iq + 1) * q_chunk)
        m_rows, l_rows, a_rows = m[..., rows], l[..., rows], acc[..., rows, :]
        m_new = torch.maximum(m_rows, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m_rows - m_new)
        l[..., rows] = l_rows * corr + p.sum(dim=-1)
        acc[..., rows, :] = a_rows * corr[..., None] + torch.einsum(
            "bkgtc,bkcd->bkgtd", p.to(v_j.dtype).to(f32), v_j.to(f32))
        m[..., rows] = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sqp, h, d)
    return out[:, :s].to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len,
                     k_scale=None, v_scale=None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, 1, H, D); caches: (B, Smax, KV, D); entries < cache_len (an
    int, a 0-d tensor, or a (B, 1) tensor of per-row lengths) valid.  With
    k_scale/v_scale (B, Smax, KV, 1) the caches are int8 and dequantized on
    the fly: the scores are scaled by k_scale, the probabilities by
    v_scale, both in f32.  ``scale`` multiplies the scores (None:
    D ** -0.5)."""
    b, _, h, d = q.shape
    _, smax, kv, _ = k_cache.shape
    g = h // kv
    f32 = torch.float32
    qg = q.reshape(b, 1, kv, g, d).to(f32)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache.to(f32)) * (
        d ** -0.5 if scale is None else scale)
    if k_scale is not None:
        s = s * k_scale[:, :, :, 0].transpose(1, 2)[:, :, None, None, :]
    valid = torch.arange(smax, device=q.device)[None, :] < cache_len
    s = torch.where(valid[:, None, None, None, :], s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale[:, :, :, 0].transpose(1, 2)[:, :, None, None, :]
    else:
        p = p.to(v_cache.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(f32), v_cache.to(f32))
    return out.reshape(b, 1, h, d).to(q.dtype)


def quantize_kv(x: torch.Tensor):
    """x (B, S, KV, D) -> int8 values + (B, S, KV, 1) bf16 scales: the
    absolute maximum over D / 127 (+1e-12), values rounded half to even
    and clipped to [-127, 127]."""
    x32 = x.to(torch.float32)
    scale = x32.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


# The KV cache's format is decided here: ``kv_planes`` builds it and
# ``kv_entries`` says what each of its planes stores; every cache builder
# and every writer of a token's k/v goes through them.

def kv_planes(shape, dtype, int8: bool, device) -> dict:
    """Zero k/v planes of ``shape`` (..., S, KV, D): in ``dtype``, or int8
    with bf16 scale planes k_s/v_s (..., S, KV, 1) when ``int8``."""
    if not int8:
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    scales = tuple(shape[:-1]) + (1,)
    return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_s": torch.zeros(scales, dtype=torch.bfloat16, device=device),
            "v_s": torch.zeros(scales, dtype=torch.bfloat16, device=device)}


def kv_entries(cache: dict, k: torch.Tensor, v: torch.Tensor):
    """The (plane, value) pairs that store k/v (..., S, KV, D) into the
    planes of ``cache``: cast to the planes' dtype, or quantized with their
    scales when the cache is int8 (it has ``k_s``)."""
    if "k_s" in cache:
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        return (("k", kq), ("v", vq), ("k_s", ks), ("v_s", vs))
    return (("k", k.to(cache["k"].dtype)), ("v", v.to(cache["v"].dtype)))


# ---------------------------------------------------------------------------
# GQA attention block (projections + rope + qk-norm + cache handling)
# ---------------------------------------------------------------------------

def init_attention(generator: torch.Generator, cfg, dtype,
                   device="cuda", d_in: Optional[int] = None) -> dict:
    """q/k/v from ``d_in`` (default d_model) channels, out to d_model."""
    d, hd = cfg.d_model, cfg.head_dim
    d_in = d if d_in is None else d_in
    p = {
        "wq": init_linear(generator, d_in, cfg.n_heads * hd, dtype,
                          cfg.use_bias, device=device),
        "wk": init_linear(generator, d_in, cfg.n_kv_heads * hd, dtype,
                          cfg.use_bias, device=device),
        "wv": init_linear(generator, d_in, cfg.n_kv_heads * hd, dtype,
                          cfg.use_bias, device=device),
        "wo": init_linear(generator, cfg.n_heads * hd, d, dtype,
                          scale=(cfg.n_heads * hd) ** -0.5
                          / (2 * cfg.n_layers) ** 0.5, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def attention_local(p: dict, cfg, tp) -> dict:
    """The attention weights this rank computes with under ``tp`` (from
    ``parallel.tensor.attn_tp``; None: ``p`` itself): its q heads' and
    out-projection's own slices, the kv heads its q heads read (its own
    slice where kv heads split, else columns of the replicated leaves,
    ``tensor.kv_slots``), the replicated biases' and qk-norms' parts
    (``tensor.rep_part``).  The out-projection's bias is left out: it is
    added once, after the reduction."""
    if tp is None:
        return p
    hd = cfg.head_dim
    out = dict(p, wo={"w": p["wo"]["w"]})
    if "b" in p["wq"]:
        out["wq"] = {"w": p["wq"]["w"], "b": tensor.rep_slice(p["wq"]["b"],
                                                              tp)}
    if tensor.kv_splits(cfg, tp.size):
        for name in ("wk", "wv"):
            if "b" in p[name]:
                out[name] = {"w": p[name]["w"],
                             "b": tensor.rep_slice(p[name]["b"], tp)}
    else:
        slots = tensor.kv_slots(cfg, tp.size, tp.rank)
        if slots == list(range(slots[0], slots[0] + len(slots))):
            def take(t):
                return t.narrow(-1, slots[0] * hd, len(slots) * hd)
        else:
            cols = torch.tensor([s * hd + j for s in slots
                                 for j in range(hd)],
                                device=p["wk"]["w"].device)

            def take(t):
                return t.index_select(-1, cols)
        for name in ("wk", "wv"):
            out[name] = {k: take(tensor.rep_part(v, tp))
                         for k, v in p[name].items()}
    for name in ("q_norm", "k_norm"):
        if name in p:
            out[name] = tensor.rep_part(p[name], tp)
    return out


def _out_bias(y: torch.Tensor, p: dict, tp, sp: bool) -> torch.Tensor:
    """The out-projection's bias, added once after the reduction (on the
    rank's rows under SP, so its gradient is summed)."""
    if tp is None or "b" not in p["wo"]:
        return y
    b = tensor.rep_part(p["wo"]["b"], tp) if sp else p["wo"]["b"]
    return y + b.to(y.dtype)


def attention_qkv(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                  use_rope: bool = True):
    """Project + (qk-norm) + RoPE.  x (B, S, D_model) -> q (B,S,H,Dh),
    k/v (B,S,KV,Dh); the head counts are the weights' (a rank's under
    tensor parallelism)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = linear(x, p["wq"]).reshape(b, s, -1, hd)
    k = linear(x, p["wk"]).reshape(b, s, -1, hd)
    v = linear(x, p["wv"]).reshape(b, s, -1, hd)
    q = constrain(q, "batch", "seq", "heads", None)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if use_rope:
        cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def attention_block(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                    causal: bool = True, use_rope: bool = True,
                    kv_override: Optional[Tuple] = None, sp: bool = False):
    """Full attention (prefill path).  Returns (out, (k, v)).  Under
    tensor parallelism (heads that divide the "model" axis) the rank runs
    its q heads and the kv heads they read, ``x`` copied in and the
    out-projection all-reduced, or with ``sp`` reduce-scattered over the
    sequence; k/v are the rank's."""
    tp = tensor.attn_tp(cfg)
    bias_p = p
    p = attention_local(p, cfg, tp)
    x = tensor.copy_to(x, tp)
    q, k, v = attention_qkv(p, cfg, x, positions, use_rope)
    if kv_override is not None:            # cross-attention
        k, v = kv_override
    scale = cfg.attn_scale or None
    if causal and cfg.attn_skip_masked:
        out = chunked_attention_tri(q, k, v, q_chunk=cfg.q_chunk,
                                    kv_chunk=cfg.kv_chunk, scale=scale)
    else:
        out = chunked_attention(q, k, v, causal=causal, q_chunk=cfg.q_chunk,
                                kv_chunk=cfg.kv_chunk, scale=scale)
    b, s = x.shape[:2]
    out = linear(out.reshape(b, s, -1), p["wo"])
    return _out_bias(tensor.leave(out, tp, sp), bias_p, tp, sp), (k, v)


def attention_decode(p: dict, cfg, x: torch.Tensor, cache: dict,
                     use_rope: bool = True):
    """One-token decode. x (B, 1, D). cache = {k: (B,Smax,KV,Dh), v: ...,
    len: 0-d int tensor} (+ k_s/v_s (B,Smax,KV,1) bf16 scale planes when
    the cache is int8).  The new k/v (quantized when int8, with their
    scales) are written into the cache's buffers in place, at position
    ``len`` (the JAX package returns updated copies); the returned cache
    holds the same buffers and ``len + 1``."""
    ln = cache["len"]
    pos = ln.reshape(1)                    # the position of the new token
    tp = tensor.attn_tp(cfg)
    bias_p = p
    p = attention_local(p, cfg, tp)
    q, k, v = attention_qkv(p, cfg, x, pos, use_rope)
    idx = pos.to(torch.long)
    new = dict(cache, len=ln + 1)
    for name, val in kv_entries(cache, k, v):
        cache[name].index_copy_(1, idx, val)
    out = decode_attention(q, cache["k"], cache["v"], ln + 1,
                           k_scale=cache.get("k_s"), v_scale=cache.get("v_s"),
                           scale=cfg.attn_scale or None)
    out = linear(out.reshape(x.shape[0], 1, -1), p["wo"])
    return _out_bias(tensor.reduce_from(out, tp), bias_p, tp, False), new


def cross_attention_decode(p: dict, cfg, x: torch.Tensor,
                           ck: torch.Tensor, cv: torch.Tensor) -> torch.Tensor:
    """One query token (B, 1, D) against static cross k/v (B, T, KV, Dh)
    (the rank's kv heads under tensor parallelism)."""
    tp = tensor.attn_tp(cfg)
    bias_p = p
    p = attention_local(p, cfg, tp)
    b = x.shape[0]
    q = linear(x, p["wq"]).reshape(b, 1, -1, cfg.head_dim)
    out = decode_attention(q, ck, cv, ck.shape[1])
    out = linear(out.reshape(b, 1, -1), p["wo"])
    return _out_bias(tensor.reduce_from(out, tp), bias_p, tp, False)


def init_kv_cache(cfg, batch: int, max_len: int, dtype,
                  device="cuda") -> dict:
    """Zero k/v (B, max_len, KV, Dh) in ``dtype``, or int8 with bf16 scale
    planes k_s/v_s (B, max_len, KV, 1) when ``cfg.kv_cache_int8``; KV is
    the rank's under tensor parallelism."""
    shape = (batch, max_len, tensor.local_kv_heads(cfg, tensor.context()),
             cfg.head_dim)
    return {**kv_planes(shape, dtype, cfg.kv_cache_int8, device),
            "len": torch.zeros((), dtype=torch.int32, device=device)}
