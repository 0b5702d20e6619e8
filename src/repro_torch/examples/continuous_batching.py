"""Continuous-batching serving demo (counterpart of
``examples/continuous_batching.py``): 6 requests of varying prompt lengths
stream through a 3-slot pool (vLLM-style admission and slot recycling),
yi-6b at its smoke size with seeded random weights.

    PYTHONPATH=src python -m repro_torch.examples.continuous_batching [--device cpu]

Runs on the card unless ``--device cpu``; on the card each decode tick is
one CUDA-graph replay.
"""
import argparse
import time

import torch

from repro_torch.configs.archs import smoke_config
from repro_torch.launch.serve import init_params
from repro_torch.models.lm import LM
from repro_torch.serving.scheduler import ContinuousBatcher, Request

ARCH, N_SLOTS, MAX_LEN, N_REQUESTS, NEW_TOKENS = "yi-6b", 3, 96, 6, 8


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    args = ap.parse_args(argv)
    cfg = smoke_config(ARCH)
    model = LM(cfg)
    params = init_params(cfg, 0, args.device)
    batcher = ContinuousBatcher(model, params, n_slots=N_SLOTS,
                                max_len=MAX_LEN)
    for i in range(N_REQUESTS):
        g = torch.Generator(device=args.device).manual_seed(i)
        prompt = torch.randint(0, cfg.vocab, (4 + 5 * i,), generator=g,
                               device=args.device)
        batcher.submit(Request(rid=i, prompt=prompt,
                               max_new_tokens=NEW_TOKENS))
    t0 = time.perf_counter()
    done = batcher.run_until_done()
    dt = time.perf_counter() - t0
    total = sum(len(r.out) for r in done)
    print(f"[cb] {len(done)} requests, {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s incl. prefills) on {args.device}")
    for r in sorted(done, key=lambda r: r.rid):
        print(f"[cb] req {r.rid} (prompt {len(r.prompt)}): {r.out}")
    return done


if __name__ == "__main__":
    main()
