"""Continuous batching for LM serving, dense and vlm families (counterpart
of ``repro.serving.scheduler``).

A fixed pool of B slots shares one layer-stacked KV cache with *per-slot*
lengths; requests stream in, prefill writes a finished prompt's KV into a
free slot, and every decode step advances all live slots at once: the
vLLM-style scheduler loop, with contiguous per-slot regions rather than
paged blocks, as in the JAX package.

Components:
* ``batched_decode_step`` — one token for every slot, per-slot lengths
  (a scatter into the caches at each slot's length and per-slot causal
  masks), the pool written in place.
* ``insert_prefill``     — write a (1, S, ...) prefill cache into slot b
  of the pool, in place.
* ``ContinuousBatcher``  — the Python-side queue/slot manager (admission,
  completion by EOS or max_new_tokens, slot recycling).  Its decode step
  is a :class:`~repro_torch.serving.step_graph.DecodeProgram` over the
  pool and its (B, 1) token buffer: one CUDA-graph replay a tick on the
  card, an eager step on the CPU.  Prefill runs eagerly: its shape
  changes with every prompt.

Where the port differs from the JAX package:
* A dead slot (``lens < 0``) computes, writes row 0 of its own region and
  keeps ``lens`` at -1; the JAX package's ``lens + 1`` advances dead
  slots too, so after enough idle ticks they would index past
  ``max_len`` (JAX drops such a scatter; an index past the end on the card
  is a fault).  Live slots are unaffected either way.
* With ``cfg.kv_cache_int8`` the pool is int8 with bf16 scale planes
  (``models.layers.quantize_kv``): ``insert_prefill`` quantizes the
  prefill's k/v into it and each step quantizes the new token's.  The
  JAX package's pool ignores the flag.
* A request that would write past ``max_len`` is refused at ``submit``.
* Each tick reads its tokens from the device once, not once per request.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import torch

from repro_torch.models import serve
from repro_torch.models.layers import (apply_rope, attention_qkv,
                                       decode_attention, kv_entries,
                                       kv_planes, linear, rms_norm,
                                       rope_cos_sin, swiglu)
from repro_torch.models.lm import LM, torch_dtype, tree_at
from repro_torch.serving.step_graph import DecodeProgram

__all__ = ["batched_decode_step", "insert_prefill", "init_pool", "Request",
           "ContinuousBatcher"]


# ---------------------------------------------------------------------------
# per-slot-length decode (dense/vlm)
# ---------------------------------------------------------------------------

def _attn_decode_multi(p, cfg, x, layer_cache: Dict, lens: torch.Tensor):
    """x (B,1,d); layer_cache {k, v (, k_s, v_s)}: (B,Smax,KV,hd) views of
    the pool, written in place at each slot's length; lens (B,) per-slot
    lengths, clamped at 0."""
    b = x.shape[0]
    hd = cfg.head_dim
    q, k, v = attention_qkv(p, cfg, x, None, use_rope=False)
    # RoPE at each slot's own position: cos/sin (B, 1, hd/2)
    cos, sin = rope_cos_sin(lens, hd, cfg.rope_theta)
    q = apply_rope(q, cos[:, None], sin[:, None])
    k = apply_rope(k, cos[:, None], sin[:, None])
    rows = torch.arange(b, device=x.device)
    idx = lens.to(torch.long)
    for name, val in kv_entries(layer_cache, k, v):
        layer_cache[name][rows, idx] = val[:, 0]
    out = decode_attention(q, layer_cache["k"], layer_cache["v"],
                           (lens + 1)[:, None],
                           k_scale=layer_cache.get("k_s"),
                           v_scale=layer_cache.get("v_s"))
    out = out.reshape(b, 1, cfg.n_heads * hd)
    return linear(out, p["wo"])


def batched_decode_step(model: LM, params, cache: Dict, tokens: torch.Tensor):
    """tokens (B,1); cache {k,v: (L,B,Smax,KV,hd) (+ k_s, v_s), lens: (B,)}.

    Returns (logits (B,V) f32, cache with ``lens`` advanced for every live
    slot); the pool's buffers are written in place.  Dead slots (lens < 0)
    still compute, write row 0 of their region and stay at -1: callers
    mask them out.
    """
    cfg = model.cfg
    lens = torch.clamp(cache["lens"], min=0)
    h = model.embed(params, tokens)
    planes = ("k", "v", "k_s", "v_s") if "k_s" in cache else ("k", "v")
    for i in range(cfg.n_layers):
        p = tree_at(params["blocks"], (i,))
        xn = rms_norm(h, p["norm1"], cfg.norm_eps)
        h = h + _attn_decode_multi(p["attn"], cfg, xn,
                                   {n: cache[n][i] for n in planes}, lens)
        h = h + swiglu(rms_norm(h, p["norm2"], cfg.norm_eps), p["mlp"])
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = serve._logits_last(model, params, h)
    live = cache["lens"] >= 0
    return logits, dict(cache, lens=torch.where(live, cache["lens"] + 1,
                                                cache["lens"]))


def insert_prefill(cache: Dict, slot: int, pre_cache: Dict) -> Dict:
    """Write a batch-1 prefill cache (from ``serve.prefill``) into a slot of
    the pool, in place (quantized when the pool is int8); returns the
    pool."""
    s = pre_cache["k"].shape[2]
    for name, val in kv_entries(cache, pre_cache["k"][:, 0, :s],
                                pre_cache["v"][:, 0, :s]):   # (L, s, KV, hd)
        cache[name][:, slot, :s] = val
    cache["lens"][slot] = pre_cache["len"]
    return cache


def init_pool(model: LM, n_slots: int, max_len: int, device="cuda") -> Dict:
    """Zero k/v (L, n_slots, max_len, KV, hd) in the model's dtype (int8
    with bf16 scale planes when ``cfg.kv_cache_int8``) and lens -1."""
    cfg = model.cfg
    shape = (cfg.n_layers, n_slots, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {**kv_planes(shape, torch_dtype(cfg), cfg.kv_cache_int8, device),
            "lens": torch.full((n_slots,), -1, dtype=torch.int32,
                               device=device)}


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    rid: int
    prompt: torch.Tensor             # (S,) token ids
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # Extra prefill-batch entries beyond "tokens", already batch-1 shaped,
    # e.g. {"vision": (1, prefix_len, d_model)} tokens a warm conv-service
    # frontend produced.  Decode is untouched: prefix state lives in the
    # KV cache after prefill.
    extras: Optional[Dict[str, torch.Tensor]] = None
    out: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1


class ContinuousBatcher:
    """Admission, decode ticks and slot recycling over a pool of
    ``n_slots`` slots of ``max_len`` positions, on the device the
    parameters live on; the decode program is a CUDA graph on the card
    and eager on the CPU."""

    @torch.inference_mode()
    def __init__(self, model: LM, params, n_slots: int = 4,
                 max_len: int = 256):
        if model.cfg.family not in ("dense", "vlm"):
            raise ValueError("the continuous batcher serves the dense and "
                             f"vlm families, not {model.cfg.family!r}")
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        device = params["emb"].device
        self.cache = init_pool(model, n_slots, max_len, device=device)
        self.queue: deque = deque()
        self.live: Dict[int, Request] = {}
        self.done: List[Request] = []
        self._next_tok = torch.zeros((n_slots, 1), dtype=torch.long,
                                     device=device)
        self._decode = DecodeProgram(
            lambda c, t: batched_decode_step(model, params, c, t),
            self.cache, self._next_tok, counter="lens")

    def submit(self, req: Request) -> None:
        prefix = (req.extras["vision"].shape[1]
                  if req.extras and "vision" in req.extras else 0)
        need = prefix + req.prompt.shape[0] + req.max_new_tokens - 1
        if need > self.max_len:
            raise ValueError(f"request {req.rid} needs {need} positions, the "
                             f"pool has {self.max_len}")
        self.queue.append(req)

    def _finished(self, req: Request, tok: int) -> bool:
        return (len(req.out) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id))

    def _prefill(self, req: Request, slot: int) -> torch.Tensor:
        """Prefill ``req``'s prompt (and extras) into ``slot`` of the pool;
        returns its last position's (V,) f32 logits."""
        batch = {"tokens": req.prompt[None], **(req.extras or {})}
        logits, pre = serve.prefill(self.model, self.params, batch,
                                    self.max_len)
        insert_prefill(self.cache, slot, pre)
        return logits[0]

    def _admit(self) -> None:
        taken = {r.slot for r in self.live.values()}
        free = [s for s in range(self.n_slots) if s not in taken]
        while free and self.queue:
            req = self.queue.popleft()
            slot = free.pop(0)
            tok = int(torch.argmax(self._prefill(req, slot)))
            req.slot = slot
            req.out.append(tok)
            # The prefill-produced token obeys the same completion rules as
            # decode tokens (EOS can legitimately be the first token).
            if self._finished(req, tok):
                self.cache["lens"][slot] = -1
                self.done.append(req)
                free.insert(0, slot)
                continue
            self._next_tok[slot, 0] = tok
            self.live[req.rid] = req

    @torch.inference_mode()
    def step(self) -> None:
        """One scheduler tick: admit waiting requests, decode all live."""
        self._admit()
        if not self.live:
            return
        logits = self._decode()
        toks = torch.argmax(logits, dim=-1)
        self._next_tok[:, 0] = toks
        host = toks.tolist()                 # the tick's one device read
        finished = []
        for rid, req in self.live.items():
            tok = host[req.slot]
            req.out.append(tok)
            if self._finished(req, tok):
                finished.append(rid)
        for rid in finished:
            req = self.live.pop(rid)
            self.cache["lens"][req.slot] = -1
            self.done.append(req)

    def run_until_done(self, max_ticks: int = 1000) -> List[Request]:
        ticks = 0
        while (self.queue or self.live) and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.done
