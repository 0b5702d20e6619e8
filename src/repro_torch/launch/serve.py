"""Serving launcher (counterpart of ``repro.launch.serve``): batched
prefill + decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
        --smoke --batch 4 --prompt-len 32 --gen 16 --device cpu

    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \\
        --warm-plans [--shape-classes 4x3000x1] [--device cpu --smoke]

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llava-next-34b \
        --warm-plans [--shape-classes 2x336x336] [--device cpu --smoke]

    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \
        [--smoke --device cpu]

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3-moe-30b-a3b [--smoke --device cpu]

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch zamba2-7b-instruct [--smoke --device cpu]

Runs on the card unless ``--device cpu``.  Every family is served: dense,
vlm (llava), moe (``models.moe``), hybrid (zamba2), ssm (xLSTM) and audio
(whisper).  ``--mesh host`` serves from one process;
``production``/``multipod`` build the (16, 16) / (2, 16, 16) mesh, which
raises "need N devices" on a smaller world, and on a world that large
serves tensor parallel over "model" through :func:`serve`'s ``rules``
(the path ranks on a smaller ``("data", "model")`` host mesh take):
each rank draws its slices of the parameters, the layers all-reduce over
"model", greedy sampling is an argmax over the vocab shards
(``parallel.tensor.argmax_vocab``), and decode runs eagerly (a gloo
collective staged through the host cannot be captured).  Prefill runs
eagerly;
each decode step is a :class:`~repro_torch.serving.step_graph.
DecodeProgram`: one CUDA-graph replay on the card (the counterpart of the
JAX package's jitted step), an eager step on the CPU; sampling stays
outside it.  ``--warm-plans`` resolves ConvPlans for the
``--shape-classes`` buckets at startup
(``repro_torch.serving.conv_service``), prints the per-class plan table,
and routes the family's conv frontend through the warmed services (their
class executors are CUDA graphs over K1 on the card): the audio family's
mel through the whisper frontend, ``fit_prefix`` to ``encoder_len``, then
the encoder; the vlm family's image through the patch embed (3 -> d_model,
patch 4) to ``prefix_len`` vision tokens.  The default classes are
``(batch, 2 * encoder_len, 1)`` (audio) and ``(batch, 16, 16), (batch,
32, 32)`` (vlm).  Without ``--warm-plans`` the encoder reads stub frame
embeddings and the vlm prefill stub vision tokens (batch, prefix_len,
d_model).  Where the JAX package feeds zeros (a zero mel or image, zero
frames or vision tokens), the port feeds seeded N(0, 1) draws, so the
model sees data.  ``ModelConfig.conv_impl`` has no flag, as in the JAX
package: a caller that wants the fused conv1d kernel (K5, in every Mamba2
and xLSTM block's prefill) passes ``cfg.with_(conv_impl="fused")`` to
:func:`serve`.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.archs import ARCHS, PUBLISHED, smoke_config
from repro_torch.models import moe
from repro_torch.models import serve as serve_lib
from repro_torch.models.layers import f32_accumulation
from repro_torch.models.lm import LM
from repro_torch.parallel import tensor
from repro_torch.parallel.axes import use_rules
from repro_torch.serving.step_graph import DecodeProgram

#: the whisper frontend's mel bins
N_MELS = 80
#: the vlm patch embed: image channels and patch size
IMAGE_CHANNELS, PATCH = 3, 4


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def init_params(cfg, seed: int, device, mesh=None) -> dict:
    """The model's parameters, drawn from a generator on ``device`` seeded
    with ``seed`` (the rank's slices over ``mesh``'s "model" axis)."""
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return LM(cfg).init(generator, device=device, mesh=mesh)


def make_prompt(cfg, batch: int, prompt_len: int, seed: int,
                device) -> torch.Tensor:
    """(batch, prompt_len) token ids, uniform over the vocabulary, from a
    generator on ``device`` seeded with ``seed + 1``."""
    generator = torch.Generator(device=device)
    generator.manual_seed(seed + 1)
    return torch.randint(0, cfg.vocab, (batch, prompt_len),
                         generator=generator, device=device)


def sample(logits: torch.Tensor, temperature: float,
           generator: torch.Generator, tp=None) -> torch.Tensor:
    """(B, V) logits -> (B, 1) tokens: argmax at temperature <= 0, else a
    draw from softmax(logits / temperature).  Under ``tp`` the logits are
    the rank's vocab shard: the argmax runs over the shards, a draw over
    the gathered logits."""
    if temperature <= 0:
        return tensor.argmax_vocab(logits, tp)[:, None]
    logits = tensor.gather_vocab(logits, tp)
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
    3``; (None, []) when the family has no conv frontend."""
    from repro_torch.serving.conv_service import (patch_embed_service,
                                                  whisper_frontend_service)
    if cfg.family == "vlm":
        # classes are (batch, H, W) image buckets
        frontend, svc = patch_embed_service(
            _seeded(seed + 3, device), IMAGE_CHANNELS, cfg.d_model, PATCH,
            classes, cfg.prefix_len, device=device)
        return frontend, [svc]
    if cfg.family == "audio":
        # classes are (batch, T, 1) time buckets
        return whisper_frontend_service(_seeded(seed + 3, device), N_MELS,
                                        cfg.d_model, classes, device=device)
    return None, []


def _frontend_inputs(cfg, frontend, services, batch: int, seed: int,
                     device) -> dict:
    """The prefill's conv-frontend entries: the audio family's frames (a
    mel of the first class's length through the warmed frontend, cropped
    or padded to encoder_len), the vlm family's vision tokens (an image of
    the first class's size through the warmed patch embed), each drawn
    N(0, 1) from a generator seeded with ``seed + 4``; without a frontend
    the stubs, drawn the same way."""
    generator = _seeded(seed + 4, device)
    if cfg.family == "audio":
        if frontend is None:
            return {"frames": torch.randn(
                (batch, cfg.encoder_len, cfg.d_model), generator=generator,
                device=device)}
        from repro_torch.serving.conv_service import fit_prefix
        cls = services[0].classes[0]
        mel = torch.randn((batch, cls.h, N_MELS), generator=generator,
                          device=device)
        return {"frames": fit_prefix(frontend(mel), cfg.encoder_len)}
    if cfg.family == "vlm":
        if frontend is None:
            return {"vision": torch.randn(
                (batch, cfg.prefix_len, cfg.d_model), generator=generator,
                device=device)}
        cls = services[0].classes[0]
        image = torch.randn((batch, cls.h, cls.w, IMAGE_CHANNELS),
                            generator=generator, device=device)
        return {"vision": frontend(image)}
    return {}


def serve(cfg, *, batch: int, prompt_len: int, gen: int,
          temperature: float = 0.0, device="cuda", seed: int = 0,
          warm_plans: bool = False, shape_classes=None, rules=None) -> dict:
    """:func:`_serve` under ``rules`` (``parallel.axes.ShardingRules`` over
    a DeviceMesh of this rank's world; every rank calls it): tensor
    parallel over "model" where the mesh has that axis.  Without rules,
    one process."""
    kw = dict(batch=batch, prompt_len=prompt_len, gen=gen,
              temperature=temperature, device=device, seed=seed,
              warm_plans=warm_plans, shape_classes=shape_classes)
    if rules is None:
        return _serve(cfg, mesh=None, **kw)
    with use_rules(rules):
        return _serve(cfg, mesh=rules.mesh, **kw)


@torch.inference_mode()
def _serve(cfg, *, batch: int, prompt_len: int, gen: int,
           temperature: float, device, seed: int, warm_plans: bool,
           shape_classes, mesh) -> dict:
    """Serve ``batch`` random prompts of ``prompt_len`` tokens with seeded
    random weights: one batched prefill, then ``gen - 1`` decode steps, one
    token each (the prefill's logits give the first), through a
    :class:`DecodeProgram` over the prefill's cache (a captured CUDA graph
    on the card, eager on the CPU).  The audio family first
    encodes a mel of the first class's length (seeded N(0, 1)) through the
    warmed conv frontend when ``warm_plans``, else stub frame embeddings
    (batch, encoder_len, d_model); the vlm family an image of the first
    class's size through the warmed patch embed, else stub vision tokens
    (batch, prefix_len, d_model), ahead of the prompt.

    Returns ``tokens`` (batch, gen), ``prefill_logits`` (batch, vocab) f32
    (the last prompt token's), ``logits`` (the last step's), and host-clock
    ``prefill_s`` and ``decode_s`` (the device synchronised before each
    clock read) with ``decode_tokens_per_s`` = batch * (gen - 1) /
    decode_s, and ``decode_graph`` whether decode replayed a CUDA graph.
    ``decode_s`` includes building the program (on the card its eager
    warm-up step and the capture), as the JAX package's decode time
    includes the first step's compile; ``capture_s`` is that part.  With
    ``warm_plans`` also ``warmup`` (each service's WarmupReport),
    ``warm_s``, ``frontend_s`` (mel or image to the prefix, after
    warmup) and ``frontend_replays`` (the services' class-executor
    replays), else ``warmup`` empty, both None and no replays.  ``drops``
    counts the moe family's dropped (token, expert) assignments
    (``models.moe.count_drops``; the rank's own under expert parallelism):
    ``prefill`` (an int) and ``decode`` (a list, one int a step); zeros
    for the other families.  Products accumulate in f32
    (:func:`f32_accumulation`).  Under tensor parallelism (``mesh`` with
    a "model" axis) the logits returned are whole (gathered) and decode
    is eager.
    """
    if gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    device = torch.device(device)
    model = LM(cfg)
    max_len = prompt_len + gen + (cfg.prefix_len if cfg.family == "vlm"
                                  else 0)
    frontend, services, warm_s, frontend_s = None, [], None, None
    with f32_accumulation():
        if warm_plans:
            classes = shape_classes or default_shape_classes(cfg, batch)
            t0 = time.perf_counter()
            frontend, services = warm_frontend(cfg, classes, seed, device)
            _sync(device)
            warm_s = time.perf_counter() - t0
        params = init_params(cfg, seed, device, mesh)
        vocab_tp = model.vocab_tp()
        eager = tensor.context() is not None
        tokens = make_prompt(cfg, batch, prompt_len, seed, device)
        _sync(device)
        t0 = time.perf_counter()
        inputs = {"tokens": tokens, **_frontend_inputs(
            cfg, frontend, services, batch, seed, device)}
        _sync(device)
        if frontend is not None:
            frontend_s = time.perf_counter() - t0
        generator = _seeded(seed + 2, device)

        _sync(device)
        with moe.count_drops(device) as dropped:
            t0 = time.perf_counter()
            logits, cache = serve_lib.prefill(model, params, inputs, max_len)
            _sync(device)
            prefill_s = time.perf_counter() - t0
            prefill_drops = dropped.clone()
            prefill_logits = tensor.gather_vocab(logits, vocab_tp)
            tok = sample(logits, temperature, generator, vocab_tp)
            out = [tok]
            t0 = time.perf_counter()
            # a gloo collective staged through the host cannot be captured
            step = DecodeProgram(
                lambda c, t: serve_lib.decode_step(model, params, c, t), cache,
                torch.zeros_like(tok), **({"graph": False} if eager else {}))
            _sync(device)
            capture_s = time.perf_counter() - t0
            # the program's build ran a step: count from here (device
            # copies a step, read after the loop)
            dropped.zero_()
            totals = []
            for _ in range(gen - 1):
                step.tokens.copy_(tok)
                logits = step()
                totals.append(dropped.clone())
                tok = sample(logits, temperature, generator, vocab_tp)
                out.append(tok)
            _sync(device)
            decode_s = time.perf_counter() - t0
        totals = [int(v) for v in totals]
        drops = {"prefill": int(prefill_drops),
                 "decode": [b - a for a, b in zip([0] + totals, totals)]}
    return {"tokens": torch.cat(out, dim=1), "prefill_logits": prefill_logits,
            "logits": tensor.gather_vocab(logits, vocab_tp).clone(),
            "prefill_s": prefill_s,
            "decode_s": decode_s,
            "decode_tokens_per_s": (batch * (gen - 1) / decode_s
                                    if gen > 1 else 0.0),
            "decode_graph": step.graph is not None, "capture_s": capture_s,
            "warmup": [svc.warmup for svc in services], "warm_s": warm_s,
            "frontend_s": frontend_s, "drops": drops,
            "frontend_replays": sum(sum(svc.replays.values())
                                    for svc in services)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    choices=sorted(ARCHS) + sorted(PUBLISHED))
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
                         "--warm-plans (vlm: image buckets; audio: NxTx1 "
                         "time buckets)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    args = ap.parse_args(argv)

    rules = None
    if args.mesh != "host":
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.parallel.axes import default_rules
        rules = default_rules(make_production_mesh(
            multi_pod=args.mesh == "multipod"))
    cfg = (smoke_config(args.arch) if args.smoke
           else {**ARCHS, **PUBLISHED}[args.arch])
    classes = None
    if args.shape_classes:
        from repro_torch.serving.conv_service import parse_shape_classes
        classes = parse_shape_classes(args.shape_classes)
    res = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, temperature=args.temperature,
                device=args.device, warm_plans=args.warm_plans,
                shape_classes=classes, rules=rules)
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
