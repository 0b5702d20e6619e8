#!/usr/bin/env python3
"""Where the int8 batcher and a request served alone part (fault F8).

    PYTHONPATH=src python tools/int8_flip_probe.py [--layers 2] [--device cpu]

qwen3-4b at its widths (8 KV heads of 128) and ``--layers`` layers, f32,
seeded random weights; 8 seeded requests (prompts of 32-512 tokens)
through an 8-slot ``ContinuousBatcher`` of 1024 positions, then each
request alone (its prefill, quantized for the int8 pool, then decode fed
the batcher's own tokens).  For the int8 pool it prints, over the first
``--ticks`` ticks, every quantized entry in which the two differ: the f32
values behind it, their scales, the quotients and the int8 values; then
the largest relative difference of the f32 k/v at the first layer of the
first tick, and, for the float and the int8 pool, the largest scale-
normalised logits error of the batcher against the requests alone.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs.archs import ARCHS
from repro_torch.models import layers, lm, serve
from repro_torch.serving import ContinuousBatcher, Request

SLOTS, MAX_LEN = 8, 1024


def requests(cfg, n: int, seed: int, new: int):
    host = torch.Generator().manual_seed(seed)
    lens = torch.randint(32, 513, (n,), generator=host).tolist()
    return [Request(rid=i, prompt=torch.randint(0, cfg.vocab, (lens[i],),
                                                generator=host),
                    max_new_tokens=new) for i in range(n)]


def quantized(cache, device):
    planes = layers.kv_planes(cache["k"].shape, None, True, device)
    for name, val in layers.kv_entries(planes, cache["k"], cache["v"]):
        planes[name].copy_(val)
    return dict(planes, len=cache["len"])


def run(cfg, params, ticks: int, device, record):
    """(the batcher's quantize_kv calls of each tick, each request's solo
    calls, the largest logits error against alone)."""
    model = lm.LM(cfg)
    reqs = [Request(rid=r.rid, prompt=r.prompt.to(device),
                    max_new_tokens=ticks + 2)
            for r in requests(cfg, SLOTS, 5, ticks + 2)]
    batcher = ContinuousBatcher(model, params, n_slots=SLOTS, max_len=MAX_LEN)
    rows, decode = {}, batcher._decode

    def recorded():
        logits = decode()
        for r in batcher.live.values():
            rows.setdefault(r.rid, []).append(logits[r.slot].clone())
        return logits

    batcher._decode = recorded
    for r in reqs:
        batcher.submit(r)
    del record[:]
    for _ in range(ticks):
        batcher.step()
    batched = list(record[2 * SLOTS:]) if cfg.kv_cache_int8 else []
    solo, worst = {}, 0.0
    for r in batcher.live.values():
        _, cache = serve.prefill(model, params, {"tokens": r.prompt[None]},
                                 MAX_LEN)
        if cfg.kv_cache_int8:
            cache = quantized(cache, device)
        del record[:]
        for t in range(ticks):
            logits, cache = serve.decode_step(
                model, params, cache, torch.tensor([[r.out[t]]], device=device))
            want = logits[0]
            err = (rows[r.rid][t] - want).abs().max() / want.abs().max()
            worst = max(worst, float(err))
        solo[r.slot] = list(record)
    return batched, solo, worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--ticks", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    record = []
    real = layers.quantize_kv

    def recorded(x):
        q, s = real(x)
        record.append((x.float(), q, s))
        return q, s

    layers.quantize_kv = recorded
    per_tick = 2 * args.layers
    out = {"layers": args.layers, "ticks": args.ticks, "device": args.device}
    with torch.inference_mode():
        for int8 in (False, True):
            cfg = ARCHS["qwen3-4b"].with_(dtype="float32", n_layers=args.layers,
                                          kv_cache_int8=int8)
            params = lm.LM(cfg).init(torch.Generator().manual_seed(0),
                                     device=args.device)
            batched, solo, worst = run(cfg, params, args.ticks, args.device,
                                       record)
            out["int8" if int8 else "float"] = {"logits_vs_alone": worst}
    flips, first_rel = [], 0.0
    for t in range(args.ticks):
        for j in range(per_tick):
            xb, qb, _ = batched[t * per_tick + j]
            for slot, rec in solo.items():
                xs, qs, _ = rec[t * per_tick + j]
                a, b = xb[slot], xs[0]
                if (t, j // 2) == (0, 0):
                    rel = float((a - b).abs().max() / b.abs().max())
                    first_rel = max(first_rel, rel)
                for idx in (qb[slot] != qs[0]).nonzero().tolist():
                    head = tuple(idx[:-1])
                    sa = float(a[head].abs().max() / 127.0 + 1e-12)
                    sb = float(b[head].abs().max() / 127.0 + 1e-12)
                    va, vb = float(a[tuple(idx)]), float(b[tuple(idx)])
                    flips.append({"tick": t, "layer": j // 2, "plane": "kv"[j % 2],
                                  "slot": slot, "entry": idx,
                                  "f32": [va, vb], "scale": [sa, sb],
                                  "quotient": [va / sa, vb / sb],
                                  "int8": [int(qb[slot][tuple(idx)]),
                                           int(qs[0][tuple(idx)])]})
    for f in flips:
        print(json.dumps(f))
    entries = sum(x[1][s].numel() for x in batched for s in solo)
    out.update(flips=len(flips), entries=entries,
               first_layer_f32_rel_diff=first_rel)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
