"""AdamW with global-norm clipping and a warmup-cosine schedule
(counterpart of ``repro.optim.adamw``), as plain functions on nested
dicts of tensors.

Not ``torch.optim.AdamW``: the JAX package clips by the global norm of
all gradients, decays only tensors with ndim >= 2, and keeps f32 moments
whatever the parameter dtype, so this is a line-for-line port.  ``update``
is pure: it returns new parameters and a new state.  ``update_`` is the
same arithmetic in place (the counterpart of the JAX launcher's donated
buffers): it writes the parameters, the moments and the step counter,
leaf by leaf in slices of at most :data:`SLICE` elements, so its f32
temporaries stay a slice's, and the two give the same bits.  The global
norm sums each leaf's squares by slices in order, in both.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch


#: elements of one slice of a leaf in ``global_norm`` and ``update_``
SLICE = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts and lists of the same
    structure (a tuple is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in ``jax.tree.leaves`` order (sorted dict keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = step / max(1.0, cfg.warmup_steps)
    t = (step - cfg.warmup_steps) / max(1.0, cfg.total_steps - cfg.warmup_steps)
    t = t.clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params) -> Dict[str, Any]:
    """f32 zero moments on each parameter's device, step 0."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    return {"m": zeros, "v": tree_map(torch.clone, zeros),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _slices(x: torch.Tensor):
    """The flat slices of at most :data:`SLICE` elements of ``x``."""
    return x.reshape(-1).split(SLICE)


def sum_squares(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x``'s squares in f32 (0-d), slice by slice."""
    total = None
    for part in _slices(x):
        s = torch.sum(torch.square(part.to(torch.float32)))
        total = s if total is None else total + s
    return total


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(sum_squares(x) for x in tree_leaves(tree)))


def _scalars(cfg: AdamWConfig, grads, opt_state, gnorm=None):
    """(step, grad norm, clip scale, lr, bias corrections) of one step;
    ``gnorm`` (the whole model's, from a rank's slices under tensor
    parallelism) replaces :func:`global_norm` of ``grads``."""
    step = opt_state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    step_f = step.to(torch.float32)
    return step, gnorm, scale, lr, 1 - cfg.b1 ** step_f, 1 - cfg.b2 ** step_f


def _new_leaf(cfg: AdamWConfig, g, m, v, p, scale, lr, b1c, b2c, decay):
    g = g.to(torch.float32) * scale
    m2 = cfg.b1 * m + (1 - cfg.b1) * g
    v2 = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
    mhat, vhat = m2 / b1c, v2 / b2c
    delta = mhat / (torch.sqrt(vhat) + cfg.eps)
    if decay:  # decay matrices only
        delta = delta + cfg.weight_decay * p.to(torch.float32)
    return (p.to(torch.float32) - lr * delta).to(p.dtype), m2, v2


def update(cfg: AdamWConfig, grads, opt_state, params
           ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: (new params, new state, {"grad_norm", "lr"})."""
    step, gnorm, scale, lr, b1c, b2c = _scalars(cfg, grads, opt_state)

    def upd(g, m, v, p):
        return _new_leaf(cfg, g, m, v, p, scale, lr, b1c, b2c, p.dim() >= 2)

    out = tree_map(upd, grads, opt_state["m"], opt_state["v"], params)
    new_params, new_m, new_v = (tree_map(lambda o: o[i], out) for i in range(3))
    return new_params, {"m": new_m, "v": new_v, "step": step}, \
        {"grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def update_(cfg: AdamWConfig, grads, opt_state, params, gnorm=None
            ) -> Dict[str, torch.Tensor]:
    """:func:`update` in place: ``params``' leaves, ``opt_state``'s moments
    and its step counter are written; returns {"grad_norm", "lr"}.  Every
    leaf must be contiguous.  ``gnorm``: the clip's norm, when the caller
    has it (tensor parallelism)."""
    step, gnorm, scale, lr, b1c, b2c = _scalars(cfg, grads, opt_state, gnorm)

    def upd(g, m, v, p):
        if not all(t.is_contiguous() for t in (m, v, p)):
            raise ValueError("update_ writes contiguous leaves only")
        for parts in zip(*map(_slices, (g, m, v, p))):
            new = _new_leaf(cfg, *parts, scale, lr, b1c, b2c, p.dim() >= 2)
            for dst, val in zip(parts[1:], (new[1], new[2], new[0])):
                dst.copy_(val)

    tree_map(upd, grads, opt_state["m"], opt_state["v"], params)
    opt_state["step"].copy_(step)
    return {"grad_norm": gnorm, "lr": lr}
