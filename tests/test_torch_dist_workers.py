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

    def recorded(grads, ef, group=None, model_group=None):
        seen.append(_numpy_flat(grads))
        return real(grads, ef, group, model_group)

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

    def vocab_tp(self):
        """The head is whole on every rank (no "model" axis)."""
        return None


def dp_conv_grads(params_np, batch_np):
    """``make_grad_fn(ConvModel(), rules)`` over the world, each rank on
    its rows of ``batch_np``, with ``parallel.conv.sharded_conv2d``
    counted.  Returns (loss, grads, sharded calls) on rank 0."""
    from repro_torch.launch.mesh import make_host_mesh
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
    if rank:
        return None
    return float(loss), _numpy_flat(grads), len(calls)


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


# ------------------------------------------------ tensor and expert parallel

def _tp_rules(shape):
    from repro_torch.parallel.axes import default_rules
    return default_rules(_mesh(shape, ("data", "model")))


def tp_family_grads(arch, params_np, batch_np, over):
    """The smoke ``arch`` (with ``over``) on a (1, world) mesh from the JAX
    package's numpy parameters: rank 0 returns the loss, the final hidden,
    every leaf's gradient gathered whole, and the clip's global norm."""
    from repro_torch.configs.archs import smoke_config
    from repro_torch.convert import params_from_jax
    from repro_torch.models.lm import LM
    from repro_torch.parallel import tensor
    from repro_torch.parallel.axes import use_rules
    from repro_torch.training import steps
    cfg = smoke_config(arch).with_(**over)
    rules = _tp_rules((1, dist.get_world_size()))
    model = LM(cfg)
    params = params_from_jax(params_np, "cpu", mesh=rules.mesh, cfg=cfg)
    batch = {k: torch.tensor(v) for k, v in batch_np.items()}
    with use_rules(rules):
        h, _ = model.forward(params, batch)
    loss, _, grads = steps.make_grad_fn(model, rules)(params, batch)
    gnorm = steps._grad_norm(model, rules, grads)
    whole = tensor.gather_params(grads, rules.mesh, cfg)
    if dist.get_rank():
        return None
    return (float(loss), h.detach().numpy(), _numpy_flat(whole),
            float(gnorm))


def tp_round_trip(arch, over):
    """The smoke ``arch``'s one-rank init, each rank's ``shard_params`` of
    it, ``LM.init(mesh=)`` (drawn rank-local) and ``gather_params`` back:
    whether the rank-local init equals the slice and the gathered tree
    the whole one, to the bit; rank 0 also returns its local shapes."""
    from repro_torch.configs.archs import smoke_config
    from repro_torch.models.lm import LM
    from repro_torch.parallel import tensor
    cfg = smoke_config(arch).with_(**over)
    mesh = _tp_rules((1, dist.get_world_size())).mesh
    model = LM(cfg)
    whole = model.init(torch.Generator().manual_seed(0), device="cpu")
    local = model.init(torch.Generator().manual_seed(0), device="cpu",
                       mesh=mesh)
    sliced = tensor.shard_params(whole, mesh, cfg, tensor.model_rank(mesh))
    back = tensor.gather_params(local, mesh, cfg)
    a, b, c = _numpy_flat(local), _numpy_flat(sliced), _numpy_flat(whole)
    d = _numpy_flat(back)
    return {"init_is_slice": all(np.array_equal(a[k], b[k]) for k in a),
            "gather_is_whole": all(np.array_equal(c[k], d[k]) for k in c),
            "local_shapes": {k: v.shape for k, v in a.items()}}


def tp_train_losses(arch, over, shape, n_steps, compressed, batches_np,
                    lr, params_np=None):
    """``n_steps`` train steps of the smoke ``arch`` (with ``over``) on a
    ``shape`` ("data", "model") mesh, each data rank on its contiguous
    block of rows of the given global batches, from ``params_np`` (the
    JAX package's, numpy) or the port's seed-0 init: the losses and grad
    norms (every rank)."""
    from repro_torch.configs.archs import smoke_config
    from repro_torch.convert import params_from_jax
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training import steps
    cfg = smoke_config(arch).with_(**over)
    rules = _tp_rules(shape)
    model = LM(cfg)
    if params_np is None:
        params = model.init(torch.Generator().manual_seed(0), device="cpu",
                            mesh=rules.mesh)
    else:
        params = params_from_jax(params_np, "cpu", mesh=rules.mesh, cfg=cfg)
    opt_cfg = AdamWConfig(lr=lr, total_steps=n_steps, warmup_steps=2)
    fn = (steps.make_compressed_train_step if compressed
          else steps.make_train_step)(model, opt_cfg, rules)
    opt = steps.init_opt_state(params, compressed=compressed)
    d, n_data = rules.mesh.get_local_rank("data"), shape[0]
    out = []
    for b in batches_np[:n_steps]:
        rows = len(b["tokens"]) // n_data
        batch = {k: torch.tensor(v[d * rows:(d + 1) * rows])
                 for k, v in b.items()}
        params, opt, m = fn(params, opt, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def tp_params_from(arch, params_np, over):
    """The rank's slices of the JAX package's numpy parameters
    (``params_from_jax(mesh=)``) and the rank's ``shard_params`` of the
    whole tree: whether they are equal."""
    from repro_torch.configs.archs import smoke_config
    from repro_torch.convert import params_from_jax
    from repro_torch.parallel import tensor
    cfg = smoke_config(arch).with_(**over)
    mesh = _tp_rules((1, dist.get_world_size())).mesh
    local = params_from_jax(params_np, "cpu", mesh=mesh, cfg=cfg)
    whole = params_from_jax(params_np, "cpu")
    sliced = tensor.shard_params(whole, mesh, cfg, tensor.model_rank(mesh))
    a, b = _numpy_flat(local), _numpy_flat(sliced)
    return all(np.array_equal(a[k], b[k]) for k in a)


def ep_forward(p_np, x_np, g_np, cfg_over, shape):
    """``models.moe.moe_ffn`` under ("data", "model") ``shape`` rules with
    ``moe_impl="ep"``: each data rank takes its contiguous block of the
    batch (the JAX package's batch sharding), the model ranks the same
    rows.  Returns, every rank: its y rows, aux, the gradient of
    sum(y * g) + aux with respect to x's rows and the router (whole) and
    its experts, and the all-to-all bytes it sent."""
    from repro_torch.configs.archs import smoke_config
    from repro_torch.models import moe
    from repro_torch.parallel import comm
    from repro_torch.parallel.axes import use_rules
    from repro_torch.training.steps import _local_batch
    cfg = smoke_config("qwen3-moe-30b-a3b").with_(moe_impl="ep",
                                                   **cfg_over)
    rules = _local_batch(_tp_rules(shape))
    mesh = rules.mesh
    d, n_data = mesh.get_local_rank("data"), shape[0]
    m, n_model = mesh.get_local_rank("model"), shape[1]
    rows = x_np.shape[0] // n_data
    e_loc = cfg.n_experts // n_model
    p = {"router": torch.tensor(p_np["router"])}
    for k in ("wg", "wu", "wd"):
        p[k] = torch.tensor(p_np[k][m * e_loc:(m + 1) * e_loc])
    for t in p.values():
        t.requires_grad_(True)
    x = torch.tensor(x_np[d * rows:(d + 1) * rows]).requires_grad_(True)
    g = torch.tensor(g_np[d * rows:(d + 1) * rows])
    sent = comm.all_to_all.bytes
    with use_rules(rules), torch.enable_grad():
        y, aux = moe.moe_ffn(p, cfg, x)
        # the data ranks' mean of aux is the JAX package's
        ((y * g).sum() + aux / n_data).backward()
    return {"y": y.detach().numpy(), "aux": float(aux),
            "dx": x.grad.numpy(), "drouter": p["router"].grad.numpy(),
            "dexperts": {k: p[k].grad.numpy() for k in ("wg", "wu", "wd")},
            "a2a_bytes": comm.all_to_all.bytes - sent}


def int8_a2a(x_np, g_np):
    """``int8_all_to_all`` over the world's "model" axis on each rank's row
    of the seeded ``x_np`` (world, ...), split 0 / concat 1, and its VJP at
    the rank's row of ``g_np``."""
    from repro_torch.models import moe
    from repro_torch.parallel import tensor
    from repro_torch.parallel.axes import use_rules
    rules = _tp_rules((1, dist.get_world_size()))
    r = dist.get_rank()
    with use_rules(rules):
        tp = tensor.context()
        x = torch.tensor(x_np[r]).requires_grad_(True)
        y = moe.int8_all_to_all(x, tp, 0, 1)
        (y * torch.tensor(g_np[r])).sum().backward()
    return y.detach().numpy(), x.grad.numpy()


def moe_dp_grads(batch_np, over):
    """The moe smoke config's data-parallel gradient on the world's 1-D
    "data" mesh, each rank on its contiguous block of rows: rank 0 returns
    the loss, the gradient and the world's summed drop count."""
    from repro_torch.configs.archs import smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.models.lm import LM
    from repro_torch.parallel import comm
    from repro_torch.parallel.axes import default_rules
    from repro_torch.training.steps import make_grad_fn
    cfg = smoke_config("qwen3-moe-30b-a3b").with_(**over)
    model = LM(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    rules = default_rules(make_host_mesh())
    r, n = dist.get_rank(), dist.get_world_size()
    rows = len(batch_np["tokens"]) // n
    batch = {k: torch.tensor(v[r * rows:(r + 1) * rows])
             for k, v in batch_np.items()}
    with moe.count_drops("cpu") as drops:
        loss, _, grads = make_grad_fn(model, rules)(params, batch)
    total = comm.all_reduce_sum(drops.reshape(1))[0]
    if r:
        return None
    return float(loss), _numpy_flat(grads), int(total)


def tp_save_restore(arch, ckpt_dir, shape, mode, batch_np):
    """``mode`` "save": two steps of the smoke ``arch`` on ``shape``, then
    a checkpoint with the shardings.  "restore": restore it onto
    ``shape``, gather the leaves whole and take one more step.  Rank 0
    returns the whole parameters and the step's loss."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.configs.archs import smoke_config
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import tensor
    from repro_torch.training import steps
    cfg = smoke_config(arch)
    rules = _tp_rules(shape)
    mesh = rules.mesh
    model = LM(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu",
                        mesh=mesh)
    opt = steps.init_opt_state(params)
    fn = steps.make_train_step(model, AdamWConfig(lr=1e-3, total_steps=8,
                                                  warmup_steps=1), rules)
    sh = tensor.shardings(params, mesh, cfg)
    shard = {"params": sh, "opt": {"m": sh, "v": sh}}
    mgr = CheckpointManager(ckpt_dir)
    d, n_data = mesh.get_local_rank("data"), shape[0]

    def step(b):
        rows = len(b["tokens"]) // n_data
        return fn(params, opt, {k: torch.tensor(v[d * rows:(d + 1) * rows])
                                for k, v in b.items()})
    if mode == "save":
        for b in batch_np[:2]:
            params, opt, _ = step(b)
        mgr.save(2, {"params": params, "opt": opt}, shardings=shard)
        loss = None
    else:
        got = mgr.restore(2, {"params": params, "opt": opt}, shardings=shard)
        params, opt = got["params"], got["opt"]
    whole = _numpy_flat(tensor.gather_params(params, mesh, cfg))
    if mode != "save":
        params, opt, m = step(batch_np[2])
        loss = float(m["loss"])
    return (whole, loss) if dist.get_rank() == 0 else None


def tp_serve(arch, over, device="cpu", warm_plans=False):
    """``launch.serve.serve`` of the smoke ``arch`` (with ``over``) on a
    (1, world) mesh: the tokens, the prefill's and the last step's logits
    (whole) and the K5 launches of the rank."""
    from repro_torch.configs.archs import smoke_config
    from repro_torch.kernels import mec_conv1d as C
    from repro_torch.launch.serve import serve
    cfg = smoke_config(arch).with_(**over)
    rules = _tp_rules((1, dist.get_world_size()))
    C.mec_conv1d.launches = 0
    r = serve(cfg, batch=2, prompt_len=16, gen=5, device=device,
              warm_plans=warm_plans, rules=rules)
    return {"tokens": r["tokens"].cpu().numpy(),
            "prefill_logits": r["prefill_logits"].cpu().numpy(),
            "logits": r["logits"].cpu().numpy(),
            "decode_graph": r["decode_graph"],
            "k5_launches": C.mec_conv1d.launches}


def tp_backward_in_another_thread(arch):
    """The smoke ``arch`` with remat on (1, world): the loss under the
    rules, its backward run from another thread (as the autograd engine
    runs a CUDA backward on its device thread, which does not see this
    thread's rules); the gradient's global norm, rank 0."""
    import threading
    from repro_torch.configs.archs import smoke_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.parallel import tensor
    from repro_torch.parallel.axes import use_rules
    from repro_torch.training import steps
    cfg = smoke_config(arch).with_(remat=True)
    rules = _tp_rules((1, dist.get_world_size()))
    model = LM(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu",
                        mesh=rules.mesh)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    batch = SyntheticLMData(cfg, 2, 32, device="cpu").next_batch()
    with use_rules(rules), torch.enable_grad():
        loss, _ = steps.make_loss_fn(model)(params, batch)
    errors = []

    def backward():
        try:
            loss.backward()
        except Exception as e:  # reported to the test
            errors.append(repr(e))

    worker = threading.Thread(target=backward)
    worker.start()
    worker.join(timeout=120)
    grads = _nest({k: v.grad for k, v in _flat_tensors(params).items()})
    placements = tensor.local_placement(grads, rules.mesh, cfg, local=True)
    with use_rules(rules):
        norm = float(tensor.global_norm(grads, placements, tensor.context()))
    return {"errors": errors, "loss": float(loss), "norm": norm}


def _flat_tensors(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_tensors(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {} if tree is None else {prefix: tree}


def _nest(flat):
    out = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def zero1_train(arch, params_np, batches_np, n_steps, lr, shape=(2, 2)):
    """``n_steps`` ZeRO-1 steps (``steps.make_zero1_train_step``) and as
    many plain steps of the smoke ``arch`` on a ``shape`` ("data",
    "model") mesh from the JAX package's parameters and batches, each data
    rank on its contiguous rows: both runs' whole parameters (numpy, flat
    names), this rank's moment bytes under ZeRO-1 and the losses."""
    from repro_torch.configs.archs import smoke_config
    from repro_torch.convert import params_from_jax
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import tensor
    from repro_torch.training import steps
    cfg = smoke_config(arch)
    rules = _tp_rules(shape)
    model = LM(cfg)
    opt_cfg = AdamWConfig(lr=lr, total_steps=n_steps, warmup_steps=2)
    d, n_data = rules.mesh.get_local_rank("data"), shape[0]
    out = {}
    for name, build, zero in (
            ("zero1", steps.make_zero1_train_step, True),
            ("plain", steps.make_train_step, False)):
        params = params_from_jax(params_np, "cpu", mesh=rules.mesh, cfg=cfg)
        opt = steps.init_opt_state(params, model=model if zero else None,
                                   rules=rules if zero else None)
        if zero:
            out["moment_bytes"] = steps._moment_bytes(opt)
        fn = build(model, opt_cfg, rules)
        losses = []
        for b in batches_np[:n_steps]:
            rows = len(b["tokens"]) // n_data
            batch = {k: torch.tensor(v[d * rows:(d + 1) * rows])
                     for k, v in b.items()}
            params, opt, m = fn(params, opt, batch)
            losses.append(float(m["loss"]))
        whole = tensor.gather_params(params, rules.mesh, cfg)
        out[name] = {"params": {k: v.detach().numpy() for k, v in
                                _flat_tensors(whole).items()},
                     "losses": losses}
    return out


def counter_ops():
    """Each collective of ``parallel.comm`` on a (2, 8) f32 tensor over the
    world (4 ranks), under ``launch.hlo_analysis.collective_bytes``: the
    counts by kind of each."""
    from repro_torch.launch.hlo_analysis import collective_bytes
    from repro_torch.parallel import comm
    t = torch.ones((2, 8))
    n, me = dist.get_world_size(), dist.get_rank()
    ops = {
        "all-reduce": lambda: comm.all_reduce_sum(t),
        "all-gather": lambda: comm.all_gather_cat(t, 0),
        "reduce-scatter": lambda: comm.reduce_scatter_sum(t, 1),
        "all-to-all": lambda: comm.all_to_all(t, 1, 1),
        "collective-permute": lambda: comm.exchange(
            [(t, (me + 1) % n)], [(t, (me - 1) % n)]),
    }
    out = {}
    for kind, fn in ops.items():
        with collective_bytes() as c:
            fn()
        out[kind] = dict(c)
    return out


def _drop_halo(t, halo, index, n, group):
    """``comm.Halo.apply`` with its exchange deleted: zeros appended."""
    return torch.cat([t, torch.zeros_like(t[:, :halo])], dim=1)


class _NoCotangentSum(torch.autograd.Function):
    """``comm.Replicated`` with its backward sum dropped."""

    @staticmethod
    def forward(ctx, t, group):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _unpatch(comm):
    """Undo the mutations: the Functions' own ``apply`` again."""
    for cls in (comm.Halo, comm.Replicated):
        if "apply" in vars(cls):
            delattr(cls, "apply")


def shardcheck_cases(cases):
    """Each case (``spec`` fields, ``partition``, ``n_dev``, ``algorithm``,
    ``dtype``, ``precision``, ``mutation``: None, "drop_halo" or
    "drop_cotangent_sum")
    through ``analysis.shardcheck.check_sharding`` on the world's first
    ranks, with this rank's wire counted by :class:`WireCounter`: the
    record and the counted bytes (forward and backward together)."""
    from repro_torch.analysis.shardcheck import check_sharding
    from repro_torch.core.convspec import ConvSpec
    from repro_torch.parallel import comm
    out = []
    for case in cases:
        if case.get("mutation") == "drop_halo":
            comm.Halo.apply = _drop_halo
        elif case.get("mutation") == "drop_cotangent_sum":
            comm.Replicated.apply = _NoCotangentSum.apply
        try:
            with WireCounter() as wire:
                chk = check_sharding(ConvSpec(*case["spec"]),
                                     case["partition"], case["n_dev"],
                                     algorithm=case["algorithm"],
                                     dtype=case.get("dtype", "float32"),
                                     precision=case.get("precision"),
                                     device="cpu")
        finally:
            _unpatch(comm)
        out.append({"record": chk.record, "wire": wire.take(),
                    "ran": chk.outputs is not None})
    return out


def plan_hook(spec_fields):
    """``plan_conv2d`` of a spatial partition under the world's default
    rules (the hook runs the contract on every rank), then again with the
    halo exchange deleted on every rank: the plan's partition, the hook's
    memo and the error the broken exchange raises."""
    from repro_torch.analysis import shardcheck
    from repro_torch.core.convspec import ConvSpec
    from repro_torch.parallel import comm
    from repro_torch.parallel.axes import default_rules, use_rules
    from repro_torch.plan import plan_conv2d
    spec = ConvSpec(*spec_fields)
    rules = default_rules(_mesh((dist.get_world_size(),), ("data",)))
    with use_rules(rules):
        plan = plan_conv2d(spec, backend="cpu", partition="spatial")
        memo = [ok for ok, _ in shardcheck._HOOK_CACHE.values()]
        comm.Halo.apply = _drop_halo
        try:
            broken = spec.__class__(spec.i_n, spec.i_h, spec.i_w, spec.i_c,
                                    spec.k_h, spec.k_w, spec.k_c + 4,
                                    spec.s_h, spec.s_w)
            plan_conv2d(broken, backend="cpu", partition="spatial")
            error = None
        except shardcheck.ShardCheckError as e:
            error = str(e)
        finally:
            _unpatch(comm)
    return {"partition": plan.partition, "axes": plan.partition_axes,
            "memo": memo, "error": error}
