"""End-to-end trainer (counterpart of ``examples/train_cnn.py``): train a
CNN classifier whose every convolution runs through ``conv2d`` (MEC by
default, differentiable through the MEC VJP), on synthetic structured
images, with AdamW.

    PYTHONPATH=src python -m repro_torch.examples.train_cnn --algorithm mec_fused2
    PYTHONPATH=src python -m repro_torch.examples.train_cnn --device cpu

The task: classify which quadrant of the image carries a bright blob,
learnable only through spatial convolution, so a falling loss shows that
gradients flow through the MEC path.  The model is three 3x3 stride-2
SAME convs and a linear head.  Runs on the card unless ``--device cpu``;
on CPU tensors the MEC kernels run their plain versions.
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (conv2d_layer, init_conv2d,
                                       plan_conv2d_layer)
from repro_torch.optim import adamw


def conv_layer(p, x, stride=1, algorithm="mec", plan=None):
    return torch.relu(conv2d_layer(p, x, stride=stride, padding="SAME",
                                   algorithm=algorithm, plan=plan))


def init_model(generator: torch.Generator, width: int, device="cuda") -> dict:
    """Parameters drawn from ``generator`` on its device, then moved to
    ``device``."""
    head = torch.randn((2 * width, 4), generator=generator,
                       device=generator.device) * 0.05
    return {
        "c1": init_conv2d(generator, 3, 3, 1, width, device=device),
        "c2": init_conv2d(generator, 3, 3, width, width, device=device),
        "c3": init_conv2d(generator, 3, 3, width, 2 * width, device=device),
        "head": {"w": head.to(device), "b": torch.zeros((4,), device=device)},
    }


def forward(p, imgs, algorithm="mec", plans=None):
    plans = plans or {}
    x = conv_layer(p["c1"], imgs, 2, algorithm, plans.get("c1"))
    x = conv_layer(p["c2"], x, 2, algorithm, plans.get("c2"))
    x = conv_layer(p["c3"], x, 2, algorithm, plans.get("c3"))
    x = x.mean(dim=(1, 2))
    return x @ p["head"]["w"] + p["head"]["b"]


def resolve_plans(params, batch, size=32, mode="cached"):
    """algorithm="auto": the ConvPlan of each conv layer is resolved once
    here, on the parameters' device, and every training step replays it;
    the plan cache keeps the decisions across runs."""
    plans = {}
    for name in ("c1", "c2", "c3"):
        c_in = params[name]["w"].shape[2]
        plans[name] = plan_conv2d_layer(params[name],
                                        (batch, size, size, c_in),
                                        stride=2, padding="SAME", mode=mode)
        size //= 2
    return plans


def make_batch(generator: torch.Generator, batch: int, size: int = 32):
    """(images (batch, size, size, 1), labels (batch,)), drawn on the
    generator's device."""
    device = generator.device
    labels = torch.randint(0, 4, (batch,), generator=generator, device=device)
    noise = 0.3 * torch.randn((batch, size, size, 1), generator=generator,
                              device=device)
    cy = (labels // 2) * (size // 2) + size // 4
    cx = (labels % 2) * (size // 2) + size // 4
    yy, xx = torch.meshgrid(torch.arange(size, device=device),
                            torch.arange(size, device=device), indexing="ij")
    blob = torch.exp(-(((yy[None] - cy[:, None, None]) ** 2
                        + (xx[None] - cx[:, None, None]) ** 2) / 18.0))
    return noise + blob[..., None], labels


def loss_and_grads(params, imgs, labels, algorithm="mec", plans=None):
    """(loss, logits, grads): mean cross-entropy of ``forward`` and its
    gradient for every parameter, by autograd."""
    live = adamw.tree_map(lambda p: p.detach().requires_grad_(), params)
    logits = forward(live, imgs, algorithm, plans)
    loss = -F.log_softmax(logits, dim=-1)[
        torch.arange(labels.shape[0], device=labels.device), labels].mean()
    loss.backward()
    return loss.detach(), logits.detach(), adamw.tree_map(lambda p: p.grad, live)


def train_step(params, opt, imgs, labels, opt_cfg, algorithm="mec",
               plans=None):
    """One step: (new params, new optimizer state, loss, accuracy)."""
    loss, logits, grads = loss_and_grads(params, imgs, labels, algorithm,
                                         plans)
    acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
    params, opt, _ = adamw.update(opt_cfg, grads, opt, params)
    return params, opt, loss, acc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--width", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--algorithm", default="mec",
                    help="conv2d algorithm (mec, direct, im2col, mec_fused2, ..., auto)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    params = init_model(torch.Generator(device=device).manual_seed(0),
                        args.width, device)
    n_params = sum(x.numel() for x in adamw.tree_leaves(params))
    print(f"[train_cnn] {n_params/1e3:.1f}k params, every conv via "
          f"conv2d(algorithm={args.algorithm!r})")
    plans = None
    if args.algorithm == "auto":
        plans = resolve_plans(params, args.batch)
        for name, pl in plans.items():
            print(f"[train_cnn] {name} plan[{pl.mode}]: {pl.algorithm} "
                  f"(solution={pl.solution}, w_blk={pl.w_blk})")
    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                warmup_steps=10, weight_decay=0.01)
    opt = adamw.init(params)

    data = torch.Generator(device=device).manual_seed(1)
    t0 = time.time()
    for i in range(args.steps):
        imgs, labels = make_batch(data, args.batch)
        params, opt, loss, acc = train_step(params, opt, imgs, labels,
                                            opt_cfg, args.algorithm, plans)
        if i % 25 == 0 or i == args.steps - 1:
            print(f"[train_cnn] step {i:4d} loss {float(loss):.4f} "
                  f"acc {float(acc):.2f}")
    print(f"[train_cnn] done in {time.time()-t0:.0f}s; final acc "
          f"{float(acc):.2f} (random = 0.25)")
    assert float(acc) > 0.8, "MEC conv training failed to learn"
    return float(acc)


if __name__ == "__main__":
    main()
