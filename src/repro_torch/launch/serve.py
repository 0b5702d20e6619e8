"""Serving launcher (counterpart of ``repro.launch.serve``): batched
prefill + decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
        --smoke --batch 4 --prompt-len 32 --gen 16 --device cpu

Runs on the card unless ``--device cpu``.  This slice serves the hybrid
family (zamba2); the other families raise ``NotImplementedError`` naming
ROADMAP Queue 1 item 10, as do ``--warm-plans`` (the conv services) and
any ``--mesh`` but ``host`` (item 11).  ``ModelConfig.conv_impl`` has no
flag: a caller that wants the fused conv1d kernel (K5) passes
``cfg.with_(conv_impl="fused")`` to :func:`serve`.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.archs import ARCHS, smoke_config
from repro_torch.models import serve as serve_lib
from repro_torch.models.layers import QUEUE_1_ITEM_10, f32_accumulation
from repro_torch.models.lm import LM


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def init_params(cfg, seed: int, device) -> dict:
    """The model's parameters, drawn from a generator on ``device`` seeded
    with ``seed``."""
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return LM(cfg).init(generator, device=device)


def make_prompt(cfg, batch: int, prompt_len: int, seed: int,
                device) -> torch.Tensor:
    """(batch, prompt_len) token ids, uniform over the vocabulary, from a
    generator on ``device`` seeded with ``seed + 1``."""
    generator = torch.Generator(device=device)
    generator.manual_seed(seed + 1)
    return torch.randint(0, cfg.vocab, (batch, prompt_len),
                         generator=generator, device=device)


def sample(logits: torch.Tensor, temperature: float,
           generator: torch.Generator) -> torch.Tensor:
    """(B, V) logits -> (B, 1) tokens: argmax at temperature <= 0, else a
    draw from softmax(logits / temperature)."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)[:, None]
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)


@torch.inference_mode()
def serve(cfg, *, batch: int, prompt_len: int, gen: int,
          temperature: float = 0.0, device="cuda", seed: int = 0) -> dict:
    """Serve ``batch`` random prompts of ``prompt_len`` tokens with seeded
    random weights: one batched prefill, then ``gen - 1`` decode steps, one
    token each (the prefill's logits give the first).

    Returns ``tokens`` (batch, gen), ``prefill_logits`` (batch, vocab) f32
    (the last prompt token's), ``logits`` (the last step's), and host-clock
    ``prefill_s`` and ``decode_s`` (the device synchronised before each
    clock read) with ``decode_tokens_per_s`` = batch * (gen - 1) /
    decode_s.  Products accumulate in f32 (:func:`f32_accumulation`).
    """
    if gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    device = torch.device(device)
    model = LM(cfg)
    max_len = prompt_len + gen
    with f32_accumulation():
        params = init_params(cfg, seed, device)
        tokens = make_prompt(cfg, batch, prompt_len, seed, device)
        generator = torch.Generator(device=device)
        generator.manual_seed(seed + 2)

        _sync(device)
        t0 = time.perf_counter()
        logits, cache = serve_lib.prefill(model, params, {"tokens": tokens},
                                          max_len)
        _sync(device)
        prefill_s = time.perf_counter() - t0
        prefill_logits = logits
        tok = sample(logits, temperature, generator)
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            logits, cache = serve_lib.decode_step(model, params, cache, tok)
            tok = sample(logits, temperature, generator)
            out.append(tok)
        _sync(device)
        decode_s = time.perf_counter() - t0
    return {"tokens": torch.cat(out, dim=1), "prefill_logits": prefill_logits,
            "logits": logits, "prefill_s": prefill_s, "decode_s": decode_s,
            "decode_tokens_per_s": (batch * (gen - 1) / decode_s
                                    if gen > 1 else 0.0)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--mesh", choices=["host", "production", "multipod"],
                    default="host")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--warm-plans", action="store_true",
                    help="not ported: the conv services "
                         f"({QUEUE_1_ITEM_10})")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    args = ap.parse_args(argv)

    if args.mesh != "host":
        raise NotImplementedError(f"--mesh {args.mesh}: distributed "
                                  "execution, ROADMAP Queue 1 item 11")
    if args.warm_plans:
        raise NotImplementedError("--warm-plans: serving/conv_service, "
                                  f"{QUEUE_1_ITEM_10}")
    cfg = smoke_config(args.arch) if args.smoke else ARCHS[args.arch]
    res = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, temperature=args.temperature,
                device=args.device)
    gen = res["tokens"]
    print(f"[serve] prefill {args.batch}x{args.prompt_len} in "
          f"{res['prefill_s'] * 1e3:.0f}ms; decode {args.gen - 1} steps @ "
          f"{res['decode_tokens_per_s']:.1f} tok/s on {args.device}")
    print("[serve] sample tokens:", gen[0, :10].tolist())
    return gen


if __name__ == "__main__":
    main()
