"""Model primitives (counterpart of ``repro.models.layers``): norms,
linear, the conv layer, RoPE, SwiGLU and GQA attention.

Attention comes in two forms, as in the JAX package:
* ``chunked_attention`` — streaming (flash-style) online-softmax attention
  for prefill: O(S^2) FLOPs, O(S * chunk) memory.
* ``decode_attention``  — one new query against a KV cache.

The order of casts is the JAX package's, so bf16 results agree: norms
normalise in f32 and cast before the weight; ``linear`` accumulates in f32
and casts once; activations run in f32 and are cast; attention scores and
the probability-weighted sum accumulate in f32.  ``linear`` runs the GEMM
in the input dtype, which accumulates in f32 on the CPU and, under
:func:`f32_accumulation`, in cuBLAS.  The JAX package's sharding
annotations (``parallel.axes.constrain``) have no counterpart here: they
wait for distributed execution (ROADMAP Queue 1 item 11).

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

_NEG = -1e30
#: what the unported LM options raise with
QUEUE_1_ITEM_10 = "ROADMAP Queue 1 item 10"


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
                 algorithm: str = "auto", plan=None) -> torch.Tensor:
    """One conv block through the front-end (``core.conv_api.conv2d``):
    the weights follow the activations' dtype, then the bias is added.
    plan (a resolved ``repro_torch.plan.ConvPlan``) wins over algorithm:
    resolve it once with :func:`plan_conv2d_layer` instead of per step."""
    y = conv2d(x, p["w"].to(x.dtype), stride=stride, padding=padding,
               algorithm=algorithm, plan=plan)
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


def swiglu(x: torch.Tensor, p: dict) -> torch.Tensor:
    g = linear(x, p["gate"])
    u = linear(x, p["up"])
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    return linear(h, p["down"])


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
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
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
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention.

    q: (B, Sq, H, D); k, v: (B, Skv, KV, D) with H % KV == 0.
    Returns (B, Sq, H, D) in q.dtype.  Assumes Sq == Skv when causal.
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
    scale = d ** -0.5
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


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len,
                     k_scale=None, v_scale=None) -> torch.Tensor:
    """q: (B, 1, H, D); caches: (B, Smax, KV, D); entries < cache_len (an
    int or a 0-d tensor) valid.  Float caches only: the int8 cache's scale
    planes raise."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            f"int8 KV cache (k_scale/v_scale): {QUEUE_1_ITEM_10}")
    b, _, h, d = q.shape
    _, smax, kv, _ = k_cache.shape
    g = h // kv
    f32 = torch.float32
    qg = q.reshape(b, 1, kv, g, d).to(f32)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache.to(f32)) * d ** -0.5
    valid = torch.arange(smax, device=q.device)[None, :] < cache_len
    s = torch.where(valid[:, None, None, None, :], s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True)
    p = p.to(v_cache.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(f32), v_cache.to(f32))
    return out.reshape(b, 1, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block (projections + rope + qk-norm + cache handling)
# ---------------------------------------------------------------------------

def init_attention(generator: torch.Generator, cfg, dtype,
                   device="cuda") -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    p = {
        "wq": init_linear(generator, d, cfg.n_heads * hd, dtype, cfg.use_bias,
                          device=device),
        "wk": init_linear(generator, d, cfg.n_kv_heads * hd, dtype,
                          cfg.use_bias, device=device),
        "wv": init_linear(generator, d, cfg.n_kv_heads * hd, dtype,
                          cfg.use_bias, device=device),
        "wo": init_linear(generator, cfg.n_heads * hd, d, dtype,
                          scale=(cfg.n_heads * hd) ** -0.5
                          / (2 * cfg.n_layers) ** 0.5, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def attention_qkv(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                  use_rope: bool = True):
    """Project + (qk-norm) + RoPE.  x (B, S, D_model) -> q (B,S,H,Dh),
    k/v (B,S,KV,Dh)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = linear(x, p["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = linear(x, p["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = linear(x, p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
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
                    kv_override: Optional[Tuple] = None):
    """Full attention (prefill path).  Returns (out, (k, v))."""
    q, k, v = attention_qkv(p, cfg, x, positions, use_rope)
    if kv_override is not None:            # cross-attention
        k, v = kv_override
    if causal and cfg.attn_skip_masked:
        raise NotImplementedError(
            f"attn_skip_masked (chunked_attention_tri): {QUEUE_1_ITEM_10}")
    out = chunked_attention(q, k, v, causal=causal, q_chunk=cfg.q_chunk,
                            kv_chunk=cfg.kv_chunk)
    b, s = x.shape[:2]
    out = out.reshape(b, s, cfg.n_heads * cfg.head_dim)
    return linear(out, p["wo"]), (k, v)


def attention_decode(p: dict, cfg, x: torch.Tensor, cache: dict,
                     use_rope: bool = True):
    """One-token decode. x (B, 1, D). cache = {k: (B,Smax,KV,Dh), v: ...,
    len: 0-d int tensor}.  The new k/v are written into the cache's
    buffers in place, at position ``len`` (the JAX package returns updated
    copies); the returned cache holds the same buffers and ``len + 1``."""
    if "k_s" in cache:
        raise NotImplementedError(f"int8 KV cache: {QUEUE_1_ITEM_10}")
    ln = cache["len"]
    pos = ln.reshape(1)                    # the position of the new token
    q, k, v = attention_qkv(p, cfg, x, pos, use_rope)
    k_cache, v_cache = cache["k"], cache["v"]
    idx = pos.to(torch.long)
    k_cache.index_copy_(1, idx, k.to(k_cache.dtype))
    v_cache.index_copy_(1, idx, v.to(v_cache.dtype))
    out = decode_attention(q, k_cache, v_cache, ln + 1)
    b = x.shape[0]
    out = out.reshape(b, 1, cfg.n_heads * cfg.head_dim)
    return linear(out, p["wo"]), {"k": k_cache, "v": v_cache, "len": ln + 1}


def init_kv_cache(cfg, batch: int, max_len: int, dtype,
                  device="cuda") -> dict:
    if cfg.kv_cache_int8:
        raise NotImplementedError(f"int8 KV cache: {QUEUE_1_ITEM_10}")
    hd = cfg.head_dim
    shape = (batch, max_len, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.zeros((), dtype=torch.int32, device=device)}
