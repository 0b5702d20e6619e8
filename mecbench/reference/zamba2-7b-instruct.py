"""Plain PyTorch reference of Zamba2-7B-Instruct's forward pass (Zyphra,
arXiv:2411.15242; huggingface.co/Zyphra/Zamba2-7B-Instruct config.json),
computed in float32 with TF32 off, with no cache, no batching tricks and
no kernels.  Imports nothing of the port.

It follows transformers' ``models/zamba2/modeling_zamba2.py`` (4.57.6):
the embeddings kept beside the hidden state; each Mamba2 layer adds
``mamba(rmsnorm(h + t))`` to ``h``, where ``t`` is zero, or, in a hybrid
layer, the layer's own linear over a shared block's output (the blocks
used in turn); the shared block takes ``concat(h, embeddings)``, RMSNorm,
multi-head attention with RoPE over the whole head and scale
(head_dim / 2) ** -0.5, RMSNorm, a gelu-gated MLP whose gate-up
projection has the hybrid layer's LoRA added, and no residual; the Mamba2
mixer's in-projection split [z, xBC, dt], the depthwise causal conv with
bias and SiLU, B and C in groups (head h reads group h // (heads /
groups)), dt = softplus(dt + dt_bias), A = -exp(A_log), the D skip, the
gated RMSNorm over each group of channels (eps 1e-5, as transformers
fixes it), the out-projection; the final RMSNorm and the head (the
embedding, transposed, where ``lm_head`` is absent: tied).

Departures from transformers' code, the same mathematics:
* the scan in its quadratic form over the whole sequence, group by
  group: y_t = sum_{s <= t} (C_t . B_s) exp(sum_{r=s+1..t} dt_r A) dt_s
  x_s + D x_t, where transformers' torch path splits the same sums into
  chunks of ``chunk_size``; the decay's sums are cumulative sums of the
  masked dt A, as transformers' ``segment_sum``;
* dt is not clamped: ``time_step_limit`` is null, as the published
  kernels (mamba_ssm) run it; transformers' torch path clamps dt below
  at ``time_step_min``;
* the conv written out as k shifted products and the bias, in place of
  ``nn.Conv1d`` with padding;
* attention one sequence at a time with a causal mask of -inf.

Weights come by name (see :data:`LAYER_WEIGHTS`), in the (in, out)
orientation, in any dtype and on any device: each is cast to float32 (or
first rounded to ``precision``) where it is used, one layer at a time, so
the reference fits beside the program's own bf16 weights on the card.

The control (``LOWER``): the same forward with every weight matrix and
vector rounded to float8 e4m3, a per-tensor scale mapping its largest
magnitude to the format's largest finite value, for bfloat16 traffic.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch
import torch.nn.functional as F

F32 = torch.float32
#: the traffic's dtype -> the precision just below it
LOWER = {"bfloat16": "float8_e4m3fn"}

#: the names of the weights, by part ({n}: Mamba2 layer, {b}: shared
#: block, {k}: hybrid layer, in the order of ``hybrid_layer_ids``)
LAYER_WEIGHTS = {
    "model": ("embed", "final_norm"),      # and "lm_head" unless tied
    "mamba": ("layers.{n}.norm", "layers.{n}.in_proj", "layers.{n}.conv_w",
              "layers.{n}.conv_b", "layers.{n}.dt_bias", "layers.{n}.a_log",
              "layers.{n}.d", "layers.{n}.gated_norm", "layers.{n}.out_proj"),
    "block": ("blocks.{b}.norm1", "blocks.{b}.q", "blocks.{b}.k",
              "blocks.{b}.v", "blocks.{b}.o", "blocks.{b}.norm2",
              "blocks.{b}.gate_up", "blocks.{b}.down"),
    "hybrid": ("hybrid.{k}.lora_a", "hybrid.{k}.lora_b", "hybrid.{k}.linear"),
}


def round_to(t: torch.Tensor, precision: Optional[str]) -> torch.Tensor:
    """``t`` in float32, after rounding to ``precision`` (None: as is)
    with a per-tensor scale that maps its largest magnitude to the
    format's largest finite value."""
    t = t.detach().to(F32)
    if precision is None:
        return t
    fmt = getattr(torch, precision)
    scale = t.abs().max().clamp(min=1e-30) / torch.finfo(fmt).max
    return (t / scale).to(fmt).to(F32) * scale


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv of x (B, S, C) with w (k, C): out_t = b +
    sum_j w_j x_{t - k + 1 + j}, zeros before the sequence."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return b + sum(w[j] * xp[:, j:j + s] for j in range(k))


def _scan(x, dt, a, b, c):
    """One sequence: x (S, H, P), dt (S, H), a (H,), b and c (S, G, N) ->
    y (S, H, P), without the D skip."""
    s, h, _ = x.shape
    groups = b.shape[1]
    hg = h // groups
    keep = torch.tril(torch.ones(s, s, dtype=torch.bool, device=x.device),
                      diagonal=-1)
    causal = torch.tril(torch.ones(s, s, dtype=torch.bool, device=x.device))
    ys = []
    for g in range(groups):
        heads = slice(g * hg, (g + 1) * hg)
        da = (dt[:, heads] * a[heads]).T                  # (hg, S)
        # seg[h, t, s] = sum_{r = s+1..t} dt_r A_h (transformers' segment_sum)
        seg = da[:, :, None].expand(hg, s, s).masked_fill(~keep, 0.0)
        seg = torch.cumsum(seg, dim=1).masked_fill(~causal, float("-inf"))
        weights = torch.exp(seg) * (c[:, g] @ b[:, g].T)  # (hg, t, s)
        del seg
        xdt = x[:, heads] * dt[:, heads, None]            # (S, hg, P)
        ys.append(torch.einsum("hts,shp->thp", weights, xdt))
        del weights
    return torch.cat(ys, dim=1)


def _attention(q, k, v, scale: float):
    """One sequence: q, k, v (S, heads, D) -> (S, heads, D), causal."""
    s = q.shape[0]
    scores = torch.einsum("thd,shd->hts", q, k) * scale
    mask = torch.tril(torch.ones(s, s, dtype=torch.bool, device=q.device))
    p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("hts,shd->thd", p, v)


def _rope(x, theta: float):
    """x (S, heads, D), RoPE over all D at positions 0..S-1: x cos +
    rotate_half(x) sin (transformers' ``apply_rotary_pos_emb``)."""
    s, _, d = x.shape
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=F32,
                                       device=x.device) / d)
    ang = torch.arange(s, dtype=F32, device=x.device)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)[:, None, :]
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * torch.cos(ang) + rot * torch.sin(ang)


def _mamba(w, cfg: Mapping, x: torch.Tensor) -> torch.Tensor:
    """The mixer over x (B, S, d) already normed."""
    bsz, s, d = x.shape
    d_in = cfg["mamba_expand"] * d
    heads, p_dim = cfg["n_mamba_heads"], cfg["mamba_headdim"]
    g, n = cfg["mamba_ngroups"], cfg["mamba_d_state"]
    proj = x @ w("in_proj")
    z, xbc, dt = proj.split([d_in, d_in + 2 * g * n, heads], dim=-1)
    xbc = F.silu(_conv(xbc, w("conv_w"), w("conv_b")))
    xs, b, c = xbc.split([d_in, g * n, g * n], dim=-1)
    dt = F.softplus(dt + w("dt_bias"))
    a = -torch.exp(w("a_log"))
    xs = xs.reshape(bsz, s, heads, p_dim)
    y = torch.stack([_scan(xs[i], dt[i], a, b[i].reshape(s, g, n),
                           c[i].reshape(s, g, n)) for i in range(bsz)])
    y = (y + xs * w("d")[:, None]).reshape(bsz, s, d_in)
    gated = (y * F.silu(z)).reshape(bsz, s, g, d_in // g)
    gated = gated * torch.rsqrt(gated.pow(2).mean(-1, keepdim=True) + 1e-5)
    return (gated.reshape(bsz, s, d_in) * w("gated_norm")) @ w("out_proj")


def _shared(w, wk, cfg: Mapping, h: torch.Tensor, emb: torch.Tensor):
    """What a hybrid layer adds to its Mamba2 input: shared block ``w``
    over concat(h, emb), then the layer's linear; ``wk``: the layer's
    LoRA and linear."""
    bsz, s, _ = h.shape
    eps = cfg["rms_norm_eps"]
    heads, hd = cfg["num_attention_heads"], cfg["attention_head_dim"]
    x = _rms(torch.cat([h, emb], dim=-1), w("norm1"), eps)
    q, k, v = ((x @ w(name)).reshape(bsz, s, heads, hd)
               for name in ("q", "k", "v"))
    att = torch.stack([
        _attention(_rope(q[i], cfg["rope_theta"]),
                   _rope(k[i], cfg["rope_theta"]), v[i],
                   (hd / 2) ** -0.5) for i in range(bsz)])
    a = att.reshape(bsz, s, heads * hd) @ w("o")
    a = _rms(a, w("norm2"), eps)
    gu = a @ w("gate_up") + (a @ wk("lora_a")) @ wk("lora_b")
    gate, up = gu.chunk(2, dim=-1)
    return ((F.gelu(gate) * up) @ w("down")) @ wk("linear")


def logits(weights: Mapping[str, torch.Tensor], cfg: Mapping,
           tokens: torch.Tensor, positions: Optional[Sequence[int]] = None,
           precision: Optional[str] = None) -> torch.Tensor:
    """The logits (B, len(positions), V) in float32 of ``tokens`` (B, S)
    at ``positions`` (default: all), on the tokens' device; ``cfg`` the
    Zamba2 config's keys; ``precision`` rounds every weight first (the
    control)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _logits(weights, cfg, tokens, positions, precision)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _getter(weights, fmt: str, precision, device):
    def w(name):
        return round_to(weights[fmt + name], precision).to(device)
    return w


def _logits(weights, cfg, tokens, positions, precision):
    dev = tokens.device
    eps = cfg["rms_norm_eps"]
    ids = list(cfg["hybrid_layer_ids"])
    model = _getter(weights, "", precision, dev)
    embed = model("embed")
    h = embed[tokens]
    emb = h
    for n in range(cfg["num_hidden_layers"]):
        x = h
        if n in ids:
            k = ids.index(n)
            b = k % cfg["num_mem_blocks"]
            x = h + _shared(_getter(weights, f"blocks.{b}.", precision, dev),
                            _getter(weights, f"hybrid.{k}.", precision, dev),
                            cfg, h, emb)
        w = _getter(weights, f"layers.{n}.", precision, dev)
        h = h + _mamba(w, cfg, _rms(x, w("norm"), eps))
    if positions is not None:
        h = h[:, list(positions)]
    h = _rms(h, model("final_norm"), eps)
    head = model("lm_head") if "lm_head" in weights else embed.T
    return h @ head


def scaled_error(y: torch.Tensor, ref: torch.Tensor) -> float:
    """max |y - ref| / max |ref|."""
    if tuple(y.shape) != tuple(ref.shape):
        raise ValueError(f"shape {tuple(y.shape)} against {tuple(ref.shape)}")
    d = (y.detach().to(F32) - ref.to(F32)).abs().max().item()
    scale = ref.abs().max().item()
    return d / (scale if scale > 0 else 1.0)
