"""Serving launcher (counterpart of ``repro.launch.serve``): batched
prefill + decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
        --smoke --batch 4 --prompt-len 32 --gen 16 --device cpu

    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \\
        --warm-plans [--shape-classes 4x3000x1] [--device cpu --smoke]

Runs on the card unless ``--device cpu``.  The hybrid (zamba2) and audio
(whisper) families are served; the others raise ``NotImplementedError``
naming ROADMAP Queue 1 item 10, and any ``--mesh`` but ``host`` item 11.
``--warm-plans`` resolves ConvPlans for the ``--shape-classes`` buckets at
startup (``repro_torch.serving.conv_service``), prints the per-class
plan table, and routes the audio family's mel through the warmed whisper
frontend (two ConvServices; their class executors are CUDA graphs over
K1 on the card), ``fit_prefix`` to ``encoder_len``, then the encoder.
The audio default class is ``(batch, 2 * encoder_len, 1)``.  Without
``--warm-plans`` the encoder reads stub frame embeddings.  Where the JAX
package feeds zeros (a zero mel, zero frames), the port feeds seeded
N(0, 1) draws, so the encoder sees data.  ``ModelConfig.conv_impl`` has
no flag: a caller that wants the fused conv1d kernel (K5) passes
``cfg.with_(conv_impl="fused")`` to :func:`serve`.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.archs import ARCHS, smoke_config
from repro_torch.models import serve as serve_lib
from repro_torch.models.layers import f32_accumulation
from repro_torch.models.lm import LM, require_ported

#: the whisper frontend's mel bins
N_MELS = 80


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


def _seeded(seed: int, device) -> torch.Generator:
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return generator


def default_shape_classes(cfg, batch: int):
    """``--warm-plans`` without ``--shape-classes``: the audio family's
    full-length mel (the stride-2 conv halves T), else two image
    buckets."""
    if cfg.family == "audio":
        return [(batch, 2 * cfg.encoder_len, 1)]
    return [(batch, 16, 16), (batch, 32, 32)]


def warm_frontend(cfg, classes, seed: int, device):
    """(frontend, services) for the family's conv encoder, warmed over
    ``classes``, its kernels drawn from a generator seeded with ``seed +
    3``; (None, []) when the family has no conv frontend.  The vlm
    family's LM is not ported (ROADMAP Queue 1 item 10), so nothing
    reaches its patch embed here."""
    from repro_torch.serving.conv_service import whisper_frontend_service
    require_ported(cfg, "the conv frontend")
    if cfg.family == "audio":
        # classes are (batch, T, 1) time buckets
        return whisper_frontend_service(_seeded(seed + 3, device), N_MELS,
                                        cfg.d_model, classes, device=device)
    return None, []


@torch.inference_mode()
def serve(cfg, *, batch: int, prompt_len: int, gen: int,
          temperature: float = 0.0, device="cuda", seed: int = 0,
          warm_plans: bool = False, shape_classes=None) -> dict:
    """Serve ``batch`` random prompts of ``prompt_len`` tokens with seeded
    random weights: one batched prefill, then ``gen - 1`` decode steps, one
    token each (the prefill's logits give the first).  The audio family
    first encodes a mel of the first class's length (seeded N(0, 1))
    through the warmed conv frontend when ``warm_plans``, else stub frame
    embeddings (batch, encoder_len, d_model).

    Returns ``tokens`` (batch, gen), ``prefill_logits`` (batch, vocab) f32
    (the last prompt token's), ``logits`` (the last step's), and host-clock
    ``prefill_s`` and ``decode_s`` (the device synchronised before each
    clock read) with ``decode_tokens_per_s`` = batch * (gen - 1) /
    decode_s; with ``warm_plans`` also ``warmup`` (each service's
    WarmupReport), ``warm_s`` and ``frontend_s`` (mel to frames, after
    warmup), else ``warmup`` empty and both None.  Products accumulate in
    f32 (:func:`f32_accumulation`).
    """
    if gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    require_ported(cfg, "serve")
    device = torch.device(device)
    model = LM(cfg)
    max_len = prompt_len + gen
    frontend, services, warm_s, frontend_s = None, [], None, None
    with f32_accumulation():
        if warm_plans:
            classes = shape_classes or default_shape_classes(cfg, batch)
            t0 = time.perf_counter()
            frontend, services = warm_frontend(cfg, classes, seed, device)
            _sync(device)
            warm_s = time.perf_counter() - t0
        params = init_params(cfg, seed, device)
        tokens = make_prompt(cfg, batch, prompt_len, seed, device)
        inputs = {"tokens": tokens}
        if cfg.family == "audio":
            if frontend is not None:
                from repro_torch.serving.conv_service import fit_prefix
                cls = services[0].classes[0]
                mel = torch.randn((batch, cls.h, N_MELS),
                                  generator=_seeded(seed + 4, device),
                                  device=device)
                _sync(device)
                t0 = time.perf_counter()
                inputs["frames"] = fit_prefix(frontend(mel), cfg.encoder_len)
                _sync(device)
                frontend_s = time.perf_counter() - t0
            else:
                inputs["frames"] = torch.randn(
                    (batch, cfg.encoder_len, cfg.d_model),
                    generator=_seeded(seed + 4, device), device=device)
        generator = _seeded(seed + 2, device)

        _sync(device)
        t0 = time.perf_counter()
        logits, cache = serve_lib.prefill(model, params, inputs, max_len)
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
                                    if gen > 1 else 0.0),
            "warmup": [svc.warmup for svc in services], "warm_s": warm_s,
            "frontend_s": frontend_s}


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
                    help="resolve ConvPlans for --shape-classes at "
                         "startup and serve the conv frontend through "
                         "them")
    ap.add_argument("--shape-classes", default=None,
                    help="comma-separated NxHxW padded classes for "
                         "--warm-plans (audio: NxTx1 time buckets)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    args = ap.parse_args(argv)

    if args.mesh != "host":
        raise NotImplementedError(f"--mesh {args.mesh}: distributed "
                                  "execution, ROADMAP Queue 1 item 11")
    cfg = smoke_config(args.arch) if args.smoke else ARCHS[args.arch]
    classes = None
    if args.shape_classes:
        from repro_torch.serving.conv_service import parse_shape_classes
        classes = parse_shape_classes(args.shape_classes)
    res = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, temperature=args.temperature,
                device=args.device, warm_plans=args.warm_plans,
                shape_classes=classes)
    if args.warm_plans:
        for report in res["warmup"]:
            print(report.render())
        if res["warmup"]:
            print(f"[serve] warmed {len(res['warmup'])} conv service(s) in "
                  f"{res['warm_s']:.2f}s; frontend {res['frontend_s']:.4f}s")
        else:
            print(f"[serve] --warm-plans: family {cfg.family!r} has no "
                  "conv frontend; nothing to warm")
    gen = res["tokens"]
    print(f"[serve] prefill {args.batch}x{args.prompt_len} in "
          f"{res['prefill_s'] * 1e3:.0f}ms; decode {args.gen - 1} steps @ "
          f"{res['decode_tokens_per_s']:.1f} tok/s on {args.device}")
    print("[serve] sample tokens:", gen[0, :10].tolist())
    return gen


if __name__ == "__main__":
    main()
