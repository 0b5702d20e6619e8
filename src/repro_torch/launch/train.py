"""Training launcher (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --smoke --steps 50 --ckpt-dir /tmp/ckpt --device cpu

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
        --steps 20 --ckpt-dir ckpt --ckpt-every 10

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \\
        -m repro_torch.launch.train --arch yi-6b --smoke --mesh host \\
        --device cpu --backend gloo [--compress-grads]

Runs on the card unless ``--device cpu``.  The step loop runs under a
watchdog; with ``--ckpt-dir`` it saves an atomic checkpoint (parameters,
optimizer state, data state) every ``--ckpt-every`` steps and at the end,
and a restarted run resumes from the newest one with the same data.  The
parameters are drawn from a generator on the device seeded with 0, the
data from ``data.pipeline.SyntheticLMData`` (seed 0).  Each step is
``training.steps.make_train_step``'s in-place step, the counterpart of the
JAX launcher's jitted step with donated parameters and state.

``--mesh host`` (the default) is data parallel over the world that
``torchrun`` starts (one process: one device, as before): each rank draws
the same parameters, takes its rows of the global batch
(``SyntheticLMData(host_id=rank, num_hosts=world)``) and the step reduces
the gradients over the ranks; ``--compress-grads`` is the int8
error-feedback step.  ``--backend`` is ``nccl`` (one card a rank; the
default on the card) or ``gloo`` (the CPU, or ranks that share one
card); NCCL with more ranks than cards raises.  Rank 0 alone logs and
writes checkpoints; every rank restores.  ``--mesh production|multipod``
build the (16, 16) / (2, 16, 16) mesh, which raises "need N devices" on a
smaller world; on a world that large the same loop runs tensor parallel
over "model" (``parallel.tensor``): each rank draws its slices of the
parameters, its data coordinate's rows of the batch, and checkpoints
hold the whole arrays.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs.archs import ARCHS, smoke_config
from repro_torch.data.pipeline import DataState, SyntheticLMData
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.layers import f32_accumulation
from repro_torch.models.lm import LM
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel import tensor
from repro_torch.parallel.axes import default_rules
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
                    help="int8 error-feedback DP gradient all-reduce")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    ap.add_argument("--conv-impl", choices=("lowered", "fused"),
                    default=None,
                    help="the blocks' conv1d dataflow (default: the "
                         "config's; 'fused' is the kernel K5 on the card)")
    ap.add_argument("--backend", choices=mesh_mod.BACKENDS, default=None,
                    help="process-group backend under torchrun (default: "
                         "nccl on cuda, gloo on the CPU)")
    return ap.parse_args(argv)


def _setup(args):
    """(device, rules, rank, world) for ``--mesh`` under the world the
    environment describes."""
    device = mesh_mod.init_world(
        args.backend or mesh_mod.default_backend(args.device), args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if args.mesh != "host":
        mesh = mesh_mod.make_production_mesh(multi_pod=args.mesh == "multipod")
    elif world > 1:
        mesh = mesh_mod.make_host_mesh()
    else:
        return device, None, rank, world
    return device, default_rules(mesh), rank, world


def _data_coords(rules, rank: int, world: int):
    """(this rank's index among the data-parallel ranks, their count): the
    batch rows it takes."""
    if rules is None:
        return rank, world
    sizes = mesh_mod.axis_sizes(rules.mesh)
    names = [a for a in rules.dp_axes]
    idx, count = 0, 1
    for a in names:
        idx = idx * sizes[a] + rules.mesh.get_local_rank(a)
        count *= sizes[a]
    return idx, count


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(args: argparse.Namespace, cfg=None) -> dict:
    """The step loop.  ``cfg`` overrides the ``--arch``/``--smoke`` config.
    Returns ``losses`` and ``step_s`` (host clock, the device synchronised
    by reading the loss) of the steps this run took, ``start`` (the step it
    resumed from, 0 when fresh)."""
    device, rules, rank, world = _setup(args)
    if cfg is None:
        cfg = smoke_config(args.arch) if args.smoke else ARCHS[args.arch]
    if args.conv_impl is not None:
        cfg = cfg.with_(conv_impl=args.conv_impl)
    model = LM(cfg)
    host_id, num_hosts = _data_coords(rules, rank, world)
    data = SyntheticLMData(cfg, args.global_batch, args.seq_len,
                           host_id=host_id, num_hosts=num_hosts,
                           device=device)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(2, args.steps // 20))
    generator = torch.Generator(device=device)
    generator.manual_seed(0)
    params = model.init(generator, device=device,
                        mesh=None if rules is None else rules.mesh)
    opt_state = steps.init_opt_state(params, compressed=args.compress_grads)
    shardings = None
    if rules is not None and tensor.tp_size(rules.mesh) > 1:
        sh = tensor.shardings(params, rules.mesh, cfg)
        opt_sh = {"m": sh, "v": sh}
        if args.compress_grads:
            opt_sh["ef"] = sh
        shardings = {"params": sh, "opt": opt_sh}
    if args.compress_grads:
        step_fn = steps.make_compressed_train_step(model, opt_cfg, rules)
    else:
        step_fn = steps.make_train_step(model, opt_cfg, rules)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        start = mgr.latest_step()
        restored = mgr.restore(start, {"params": params, "opt": opt_state,
                                       "data": data.state.to_dict()},
                               shardings=shardings)
        params, opt_state = restored["params"], restored["opt"]
        data.state = DataState.from_dict(restored["data"])
        if rank == 0:
            print(f"[train] resumed from step {start}")

    from repro_torch.kernels.mec_conv1d import mec_conv1d
    from repro_torch.parallel import comm
    staged0 = comm.stage_to_host.bytes + comm.stage_to_device.bytes
    k5_0 = mec_conv1d.launches
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
            if rank == 0 and (step % args.log_every == 0
                              or step == args.steps - 1):
                print(f"[train] step {step} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.2f} "
                      f"{dt * 1e3:.0f}ms")
            # with shardings every rank gathers; the manager's rank 0
            # writes
            saves = mgr is not None and (rank == 0 or shardings is not None)
            if saves and (step + 1) % args.ckpt_every == 0:
                mgr.save_async(step + 1, {"params": params, "opt": opt_state,
                                          "data": data.state.to_dict()},
                               shardings=shardings)
        if mgr is not None and (rank == 0 or shardings is not None):
            mgr.wait()
            mgr.save(args.steps, {"params": params, "opt": opt_state,
                                  "data": data.state.to_dict()},
                     shardings=shardings)
    n_steps = max(len(losses), 1)
    summary = {"rank": rank, "world": world,
               "backend": dist.get_backend() if dist.is_initialized()
               else None,
               "losses": losses, "step_s": step_s,
               "staged_bytes_per_step": (comm.stage_to_host.bytes
                                         + comm.stage_to_device.bytes
                                         - staged0) / n_steps,
               "k5_launches_per_step": (mec_conv1d.launches - k5_0)
               / n_steps}
    if rank == 0:
        print(f"[train] done: {args.steps} steps on {world} rank(s), "
              f"median step {dog.median * 1e3:.0f}ms, stragglers "
              f"{dog.straggler_events}")
    if world > 1:
        print(f"[train] summary {json.dumps(summary)}", flush=True)
    return dict(summary, start=start, params=params)


def main(argv=None) -> float:
    """Train; returns the last step's loss (the JAX launcher's return)."""
    return train(parse_args(argv))["losses"][-1]


if __name__ == "__main__":
    main()
