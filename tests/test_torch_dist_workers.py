"""Rank bodies for the port's distributed tests (``test_torch_parallel_conv``,
``test_torch_distribution``, ``test_torch_pipeline``): module-level
functions, so ``repro_torch.launch.mesh.spawn`` can send them to fresh
processes.  No test lives here, and nothing here imports jax: the ranks
compute the port's answers and the tests hold them against the JAX
package in their own process.

The wire is counted by wrapping the ``torch.distributed`` calls inside the
rank (:class:`WireCounter`), not by any counter of the program.
"""
import types

import numpy as np
import torch
import torch.distributed as dist


class WireCounter:
    """Bytes this rank hands to ``torch.distributed``: sent point to point
    (``p2p``), all-reduced (``reduce``) and all-gathered (``gather``)."""

    def __init__(self):
        self.p2p = self.reduce = self.gather = 0
        self._saved = {}

    def __enter__(self):
        batch, reduce, gather = (dist.batch_isend_irecv, dist.all_reduce,
                                 dist.all_gather)
        self._saved = {"batch_isend_irecv": batch, "all_reduce": reduce,
                       "all_gather": gather}

        def counted_batch(ops):
            self.p2p += sum(op.tensor.nbytes for op in ops
                            if op.op.__name__ == "isend")
            return batch(ops)

        def counted_reduce(t, *a, **k):
            self.reduce += t.nbytes
            return reduce(t, *a, **k)

        def counted_gather(out, t, *a, **k):
            self.gather += t.nbytes
            return gather(out, t, *a, **k)

        dist.batch_isend_irecv = counted_batch
        dist.all_reduce = counted_reduce
        dist.all_gather = counted_gather
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(dist, name, fn)

    def take(self):
        out = {"p2p": self.p2p, "reduce": self.reduce, "gather": self.gather}
        self.p2p = self.reduce = self.gather = 0
        return out


def _mesh(shape, axes):
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(shape=shape, axes=axes)


def host_meshes():
    """make_host_mesh over the world: its default, a named 2-D shape, a
    shape smaller than the world, and the errors it raises."""
    from repro_torch.launch.mesh import axis_sizes, make_host_mesh
    errors = []
    for kw in ({"shape": (2, 2), "axes": ("only_one",)}, {"shape": (8,)}):
        try:
            make_host_mesh(**kw)
        except ValueError as e:
            errors.append("axis names" if "axis names" in str(e)
                          else str(e).split(" for ")[0])
    sub = make_host_mesh(shape=(2,))
    coord = sub.get_coordinate()
    return {"default": axis_sizes(make_host_mesh()),
            "named": axis_sizes(make_host_mesh(shape=(2, 2))),
            "sub": None if coord is None else list(coord[:1]),
            "errors": errors}


def raise_on_rank(rank):
    """Raise on ``rank``; the others wait in a collective."""
    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    dist.barrier()


def conv_cases(cases, device="cpu"):
    """Each case: ``x``, ``k``, ``g`` (output cotangent) numpy arrays and
    conv kwargs (``stride``, ``padding``, ``algorithm``, ``partition``,
    ``axis``) on a mesh ``mesh_shape``/``mesh_axes``, run ``via``
    ``sharded_conv2d``, a partitioned plan or ``conv2d`` under the
    mesh's default rules.  Returns, per case,
    the output, the input and kernel gradients, this rank's wire bytes
    forward and backward and its kernel launches (None on a rank outside
    the case's mesh)."""
    from repro_torch.core.conv_api import conv2d, conv2d_spec
    from repro_torch.kernels import mec_conv
    from repro_torch.parallel.axes import default_rules, use_rules
    from repro_torch.parallel.conv import sharded_conv2d
    from repro_torch.plan import plan_conv2d
    meshes = {}
    out = []
    for case in cases:
        key = (tuple(case["mesh_shape"]), tuple(case["mesh_axes"]))
        if key not in meshes:
            meshes[key] = _mesh(*key)
        mesh = meshes[key]
        if mesh.get_coordinate() is None:
            out.append(None)
            continue
        x = torch.tensor(case["x"], device=device, requires_grad=True)
        k = torch.tensor(case["k"], device=device, requires_grad=True)
        geometry = dict(stride=case["stride"],
                        padding=case.get("padding", "VALID"))
        rules = default_rules(mesh)
        launched = mec_conv.launch_counts()
        with WireCounter() as wire:
            via = case.get("via", "sharded")
            if via == "sharded":
                y = sharded_conv2d(x, k, algorithm=case["algorithm"],
                                   partition=case["partition"],
                                   axis=case.get("axis"), mesh=mesh,
                                   **geometry)
            elif via == "plan":      # a partitioned plan, resolved once
                with use_rules(rules):
                    plan = plan_conv2d(
                        conv2d_spec(x, k, **geometry), backend=device,
                        partition=case["partition"],
                        partition_axis=case.get("axis"))
                    y = conv2d(x, k, plan=plan, **geometry)
            else:                    # rules-aware conv2d, as models call it
                with use_rules(rules):
                    y = conv2d(x, k, algorithm=case["algorithm"],
                               **geometry)
            fwd = wire.take()
            (y * torch.tensor(case["g"], device=device)).sum().backward()
            bwd = wire.take()
        launched = {name: n - launched[name]
                    for name, n in mec_conv.launch_counts().items()}
        out.append({"fwd": fwd, "bwd": bwd, "launches": launched,
                    "y": y.detach().cpu().numpy(),
                    "dx": x.grad.cpu().numpy(), "dk": k.grad.cpu().numpy()})
    return out


def dp_grads(arch, global_batch, seq_len):
    """One data-parallel gradient of the smoke config ``arch`` (f32) over
    the world: (loss, grads as numpy) on rank 0."""
    from repro_torch.configs.archs import smoke_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import tree_map
    from repro_torch.parallel.axes import default_rules
    from repro_torch.training.steps import make_grad_fn
    cfg = smoke_config(arch)
    model = LM(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, device="cpu")
    rules = default_rules(make_host_mesh())
    data = SyntheticLMData(cfg, global_batch, seq_len, host_id=dist.get_rank(),
                           num_hosts=dist.get_world_size(), device="cpu")
    loss, _, grads = make_grad_fn(model, rules)(params, data.next_batch())
    if dist.get_rank():
        return None
    return float(loss), tree_map(lambda g: g.numpy(), grads)


def _numpy_flat(tree, prefix=()):
    """{path: numpy copy} of a nested dict/list tree of tensors."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {"/".join(prefix): tree.detach().cpu().numpy().copy()}
    out = {}
    for k, v in items:
        out.update(_numpy_flat(v, prefix + (str(k),)))
    return out


def compressed_cases(grads_np, ef_np, arch, n_steps, global_batch, seq_len,
                     lr):
    """The int8 reduction over the world, on this rank's row of the seeded
    ``grads_np``/``ef_np`` ({name: (world, ...)}), then ``n_steps``
    compressed steps of the smoke ``arch`` (f32) from seed 0, recording
    the gradient tree each step hands ``compressed_psum``.  Returns, on
    every rank: ``reduced``, ``ef`` and ``steps`` (each step's gradients,
    parameters and ef), and ``params0`` and the optimizer settings on
    rank 0."""
    from repro_torch.configs.archs import smoke_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import compression
    from repro_torch.parallel.axes import default_rules
    from repro_torch.training import steps as tsteps
    rank = dist.get_rank()
    g = {k: torch.tensor(v[rank]) for k, v in grads_np.items()}
    e = {k: torch.tensor(v[rank]) for k, v in ef_np.items()}
    reduced, new_ef = compression.compressed_psum(g, e)
    out = {"reduced": _numpy_flat(reduced), "ef": _numpy_flat(new_ef),
           "steps": []}
    cfg = smoke_config(arch)
    model = LM(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    opt_cfg = AdamWConfig(lr=lr, total_steps=n_steps, warmup_steps=1)
    step = tsteps.make_compressed_train_step(
        model, opt_cfg, default_rules(make_host_mesh()))
    opt = tsteps.init_opt_state(params, compressed=True)
    data = SyntheticLMData(cfg, global_batch, seq_len, host_id=rank,
                           num_hosts=dist.get_world_size(), device="cpu")
    if rank == 0:
        out["params0"] = _numpy_flat(params)
        out["opt_cfg"] = {"lr": lr, "total_steps": n_steps,
                          "warmup_steps": 1}
    real, seen = compression.compressed_psum, []

    def recorded(grads, ef, group=None):
        seen.append(_numpy_flat(grads))
        return real(grads, ef, group)

    compression.compressed_psum = recorded
    try:
        for _ in range(n_steps):
            params, opt, _ = step(params, opt, data.next_batch())
            out["steps"].append({"grads": seen[-1],
                                 "params": _numpy_flat(params),
                                 "ef": _numpy_flat(opt["ef"])})
    finally:
        compression.compressed_psum = real
    return out


class ConvModel:
    """A model whose forward is a conv (no LM reaches ``conv2d``): the
    hidden state is the conv of ``batch["x"]``, one token a pixel."""

    cfg = types.SimpleNamespace(name="conv", n_experts=0)

    def forward(self, params, batch):
        from repro_torch.core.conv_api import conv2d
        y = conv2d(batch["x"], params["k"], algorithm="mec")
        return y.reshape(y.shape[0], -1, y.shape[-1]), y.new_zeros(())

    def head_weights(self, params):
        return params["head"]


def dp_conv_grads(params_np, batch_np):
    """``make_grad_fn(ConvModel(), rules)`` over the world, each rank on
    its rows of ``batch_np``, with ``parallel.conv.sharded_conv2d``
    counted; and whether the moe family's data-parallel gradient raises.
    Returns (loss, grads, sharded calls, the moe error) on rank 0."""
    from repro_torch.configs.archs import smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM
    from repro_torch.parallel import conv as pconv
    from repro_torch.parallel.axes import default_rules
    from repro_torch.training.steps import make_grad_fn
    rules = default_rules(make_host_mesh())
    rank, world = dist.get_rank(), dist.get_world_size()
    rows = len(batch_np["labels"]) // world
    batch = {k: torch.tensor(v[rank * rows:(rank + 1) * rows])
             for k, v in batch_np.items()}
    params = {k: torch.tensor(v) for k, v in params_np.items()}
    real, calls = pconv.sharded_conv2d, []

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    pconv.sharded_conv2d = counted
    try:
        loss, _, grads = make_grad_fn(ConvModel(), rules)(params, batch)
    finally:
        pconv.sharded_conv2d = real
    try:
        make_grad_fn(LM(smoke_config("qwen3-moe-30b-a3b")), rules)
        moe_error = None
    except NotImplementedError as e:
        moe_error = str(e)
    if rank:
        return None
    return float(loss), _numpy_flat(grads), len(calls), moe_error


def train_losses(arch, steps, global_batch, seq_len, lr, compressed):
    """``steps`` data-parallel steps of the smoke ``arch`` over the world
    (the JAX package's compressed-training test): the losses on rank 0."""
    from repro_torch.configs.archs import smoke_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.axes import default_rules
    from repro_torch.training import steps as tsteps
    cfg = smoke_config(arch)
    model = LM(cfg)
    rules = default_rules(make_host_mesh())
    opt_cfg = AdamWConfig(lr=lr, total_steps=steps, warmup_steps=2)
    out = {}
    for mode in ((True, False) if compressed is None else (compressed,)):
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        opt = tsteps.init_opt_state(params, compressed=mode)
        fn = (tsteps.make_compressed_train_step if mode
              else tsteps.make_train_step)(model, opt_cfg, rules)
        data = SyntheticLMData(cfg, global_batch, seq_len,
                               host_id=dist.get_rank(),
                               num_hosts=dist.get_world_size(), device="cpu")
        losses = []
        for _ in range(steps):
            params, opt, m = fn(params, opt, data.next_batch())
            losses.append(float(m["loss"]))
        out["compressed" if mode else "plain"] = losses
    return out


def pipeline_cases(params_np, x_np, n_micro, remats):
    """GPipe over a 1-D "pipe" mesh of the world, once for each ``remat``
    setting: ``{remat: output and gradients of sum(out**2)}`` on every
    rank."""
    from repro_torch.parallel.pipeline import pipeline_apply
    mesh = _mesh((dist.get_world_size(),), ("pipe",))

    def block(p, h):
        return torch.tanh(h @ p["w"] + p["b"]) + h

    out = {}
    for remat in remats:
        params = {k: torch.tensor(v, requires_grad=True)
                  for k, v in params_np.items()}
        x = torch.tensor(x_np, requires_grad=True)
        y = pipeline_apply(block, params, x, mesh, "pipe", n_micro,
                           remat=remat)
        (y ** 2).sum().backward()
        out[remat] = {"out": y.detach().numpy(), "dx": x.grad.numpy(),
                      **{f"d{k}": p.grad.numpy()
                         for k, p in params.items()}}
    return out


def dist_suite(device="cpu"):
    """The bench ``dist`` suite over the world, its smoke cells run (the
    Table-2 cells, at the paper's widths, analytic); rank 0's report."""
    from repro_torch.bench import harness
    doc = harness.run_suite("dist", iters=1, device=device,
                            time_only="smoke*")
    return doc if dist.get_rank() == 0 else None
