"""Training launcher (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --smoke --steps 50 --ckpt-dir /tmp/ckpt --device cpu

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
        --steps 20 --ckpt-dir ckpt --ckpt-every 10

Runs on the card unless ``--device cpu``.  The step loop runs under a
watchdog; with ``--ckpt-dir`` it saves an atomic checkpoint (parameters,
optimizer state, data state) every ``--ckpt-every`` steps and at the end,
and a restarted run resumes from the newest one with the same data.  The
parameters are drawn from a generator on the device seeded with 0, the
data from ``data.pipeline.SyntheticLMData`` (seed 0).  Each step is
``training.steps.make_train_step``'s in-place step, the counterpart of the
JAX launcher's jitted step with donated parameters and state.  ``--mesh
host`` (the default) is one device; ``production``/``multipod`` and
``--compress-grads`` raise ``NotImplementedError`` naming ROADMAP Queue 1
item 11.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs.archs import ARCHS, smoke_config
from repro_torch.data.pipeline import DataState, SyntheticLMData
from repro_torch.models.layers import f32_accumulation
from repro_torch.models.lm import LM
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training import steps
from repro_torch.training.watchdog import StepWatchdog


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", choices=["host", "production", "multipod"],
                    default="host")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 error-feedback DP gradient all-reduce "
                         "(ROADMAP Queue 1 item 11)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(args: argparse.Namespace, cfg=None) -> dict:
    """The step loop.  ``cfg`` overrides the ``--arch``/``--smoke`` config.
    Returns ``losses`` and ``step_s`` (host clock, the device synchronised
    by reading the loss) of the steps this run took, ``start`` (the step it
    resumed from, 0 when fresh), ``median_step_s`` and ``stragglers``."""
    if args.mesh != "host":
        raise NotImplementedError(f"--mesh {args.mesh}: distributed "
                                  "execution, ROADMAP Queue 1 item 11")
    if args.compress_grads:
        raise NotImplementedError("--compress-grads: distributed execution, "
                                  "ROADMAP Queue 1 item 11")
    if cfg is None:
        cfg = smoke_config(args.arch) if args.smoke else ARCHS[args.arch]
    device = torch.device(args.device)
    model = LM(cfg)
    data = SyntheticLMData(cfg, args.global_batch, args.seq_len,
                           device=device)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(2, args.steps // 20))
    generator = torch.Generator(device=device)
    generator.manual_seed(0)
    params = model.init(generator, device=device)
    opt_state = steps.init_opt_state(params)
    step_fn = steps.make_train_step(model, opt_cfg)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        start = mgr.latest_step()
        restored = mgr.restore(start, {"params": params, "opt": opt_state,
                                       "data": data.state.to_dict()})
        params, opt_state = restored["params"], restored["opt"]
        data.state = DataState.from_dict(restored["data"])
        print(f"[train] resumed from step {start}")

    dog = StepWatchdog(hard_timeout_s=None)
    losses, step_s = [], []
    with f32_accumulation():
        for step in range(start, args.steps):
            dog.start_step()
            batch = data.next_batch()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            _sync(device)
            dt = dog.end_step()
            losses.append(loss)
            step_s.append(dt)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"[train] step {step} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.2f} "
                      f"{dt * 1e3:.0f}ms")
            if mgr is not None and (step + 1) % args.ckpt_every == 0:
                mgr.save_async(step + 1, {"params": params, "opt": opt_state,
                                          "data": data.state.to_dict()})
        if mgr is not None:
            mgr.wait()
            mgr.save(args.steps, {"params": params, "opt": opt_state,
                                  "data": data.state.to_dict()})
    print(f"[train] done: {args.steps} steps, median step "
          f"{dog.median * 1e3:.0f}ms, stragglers {dog.straggler_events}")
    return {"losses": losses, "step_s": step_s, "start": start,
            "median_step_s": dog.median, "stragglers": dog.straggler_events,
            "params": params}


def main(argv=None) -> float:
    """Train; returns the last step's loss (the JAX launcher's return)."""
    return train(parse_args(argv))["losses"][-1]


if __name__ == "__main__":
    main()
