"""The port's tensor-parallel train steps on gloo ranks: the (2, 2)
plain and compressed steps against the JAX package's jitted steps on 4
forced host devices (one subprocess), Megatron-SP and the ``dots`` remat
against the base within the JAX package's own rtol 2e-4, the remat
recompute under the forward's rules from another thread (as the autograd
engine runs a CUDA backward), and checkpoints saved from (1, 2) restored
onto world 1 and (2, 1) to the bit.  A file of its own so the test
runner's workers share the spawns.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_dist_workers as W                        # noqa: E402
from repro_torch.configs import archs as tarchs            # noqa: E402
from repro_torch.launch import mesh as tmesh               # noqa: E402
from repro_torch.models.lm import LM                       # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager     # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, tree_map  # noqa: E402
from repro_torch.training import steps as tsteps           # noqa: E402
from test_torch_tensor_parallel import _nest               # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


# ------------------------------------------------------------- train steps

_JAX_STEPS = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import json, sys
import numpy as np, jax
from jax.sharding import Mesh, NamedSharding
from repro.configs.archs import smoke_config
from repro.data.pipeline import SyntheticLMData
from repro.models.lm import LM
from repro.optim.adamw import AdamWConfig
from repro.parallel import sharding
from repro.parallel.axes import default_rules
from repro.training.steps import (init_opt_state, make_train_step,
                                  make_compressed_train_step)
dst, n_steps = sys.argv[1], int(sys.argv[2])
cfg = smoke_config("yi-6b")
model = LM(cfg)
mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2), ("data", "model"))
rules = default_rules(mesh)
opt_cfg = AdamWConfig(lr=1e-3, total_steps=n_steps, warmup_steps=2)
data = SyntheticLMData(cfg, 8, 32)
batches = [data.next_batch() for _ in range(n_steps)]
out, arrays = {}, {}
for compressed in (False, True):
    params = model.init(jax.random.key(0))
    if not compressed:
        for path, v in jax.tree_util.tree_flatten_with_path(params)[0]:
            arrays["p:" + "/".join(k.key for k in path)] = np.asarray(v)
    specs = sharding.param_specs(params, mesh)
    params = jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), params, specs)
    opt = init_opt_state(params, compressed=compressed)
    builder = make_compressed_train_step if compressed else make_train_step
    fn = jax.jit(builder(model, opt_cfg, rules))
    res = []
    with mesh:
        for b in batches:
            params, opt, m = fn(params, opt, b)
            res.append((float(m["loss"]), float(m["grad_norm"])))
    out["compressed" if compressed else "plain"] = res
for i, b in enumerate(batches):
    for k, v in b.items():
        arrays["b%d:%s" % (i, k)] = np.asarray(v)
np.savez(dst, **arrays)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    dst = tmp_path_factory.mktemp("jax_steps") / "out.npz"
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_STEPS, str(dst), "3"],
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")), cwd=REPO,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    a = np.load(dst)
    params = _nest({k[2:]: a[k] for k in a.files if k.startswith("p:")})
    batches = [{k.split(":")[1]: a[k] for k in a.files
                if k.startswith(f"b{i}:")} for i in range(3)]
    return res, params, batches


@pytest.mark.parametrize("compressed", [False, True])
def test_train_steps_on_2x2_equal_the_jax_package(jax_steps, compressed):
    """Three yi-6b smoke steps on (2, 2) from the JAX package's parameters
    and batches (each data rank its contiguous rows, the JAX package's
    batch sharding): every step's loss and gradient norm within 1e-5 of
    the JAX package's jitted step over 4 forced host devices."""
    res, params, batches = jax_steps
    ref = res["compressed" if compressed else "plain"]
    got = tmesh.spawn(W.tp_train_losses, 4,
                      args=("yi-6b", {}, (2, 2), 3, compressed, batches,
                            1e-3, params), timeout_s=60,
                      join_timeout_s=300)
    for rank in got:
        for (loss, norm), (j_loss, j_norm) in zip(rank, ref):
            assert abs(loss - j_loss) <= 1e-5 * abs(j_loss), (loss, j_loss)
            assert abs(norm - j_norm) <= 1e-5 * abs(j_norm), (norm, j_norm)


def test_seq_parallel_and_dots_remat_equal_base_on_2x2():
    """The JAX package's ``test_dots_remat_and_sp_preserve_loss`` on 4
    gloo ranks: yi-6b smoke with remat, 6 steps, lr 1e-3; dots and SP
    losses equal the base within rtol 2e-4."""
    data = __import__("repro_torch.data.pipeline", fromlist=["x"])
    cfg = tarchs.smoke_config("yi-6b")
    src = data.SyntheticLMData(cfg, 8, 32, device="cpu")
    batches = [{k: v.numpy() for k, v in src.next_batch().items()}
               for _ in range(6)]
    runs = {}
    for name, over in (("base", {"remat": True}),
                       ("dots", {"remat": True, "remat_policy": "dots"}),
                       ("sp", {"remat": True, "seq_parallel": True})):
        got = tmesh.spawn(W.tp_train_losses, 4,
                          args=("yi-6b", over, (2, 2), 6, False, batches,
                                1e-3), timeout_s=60, join_timeout_s=300)
        runs[name] = [loss for loss, _ in got[0]]
    np.testing.assert_allclose(runs["dots"], runs["base"], rtol=2e-4)
    np.testing.assert_allclose(runs["sp"], runs["base"], rtol=2e-4)


@pytest.mark.parametrize("arch", ["zamba2-7b", "yi-6b"])
def test_remat_recompute_runs_under_the_forward_rules(arch):
    """With remat the block is recomputed in the backward, which on CUDA
    the autograd engine runs on its device thread (no rules installed
    there): the backward run from another thread gives the loss's
    gradient norm of a one-process run."""
    got = tmesh.spawn(W.tp_backward_in_another_thread, 2, args=(arch,),
                      timeout_s=60, join_timeout_s=180)
    cfg = tarchs.smoke_config(arch).with_(remat=True)
    model = LM(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = __import__("repro_torch.data.pipeline", fromlist=["x"]) \
        .SyntheticLMData(cfg, 2, 32, device="cpu").next_batch()
    loss, _, grads = tsteps.make_grad_fn(model)(params, batch)
    norm = float(__import__("repro_torch.optim.adamw", fromlist=["x"])
                 .global_norm(grads))
    for r in got:
        assert not r["errors"], r["errors"]
        assert abs(r["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
        assert abs(r["norm"] - norm) <= 1e-5 * norm, (r["norm"], norm)


# ------------------------------------------------------------- checkpoints

def test_checkpoint_from_1x2_restores_onto_world_1_and_2x1(tmp_path):
    """xlstm-125m smoke: two steps on (1, 2), saved with the shardings (the
    whole arrays, rank 0 writes); restored onto (1, 2), onto (2, 1) and
    onto one process, every leaf equal to the bit, and the next step's
    loss equal across the three within 1e-6."""
    cfg = tarchs.smoke_config("xlstm-125m")
    data = __import__("repro_torch.data.pipeline", fromlist=["x"])
    src = data.SyntheticLMData(cfg, 4, 32, device="cpu")
    batches = [{k: v.numpy() for k, v in src.next_batch().items()}
               for _ in range(3)]
    ckpt = str(tmp_path / "ckpt")
    saved, _ = tmesh.spawn(W.tp_save_restore, 2,
                           args=("xlstm-125m", ckpt, (1, 2), "save",
                                 batches), timeout_s=60,
                           join_timeout_s=240)[0]
    losses = []
    for shape in ((1, 2), (2, 1)):
        whole, loss = tmesh.spawn(W.tp_save_restore, 2,
                                  args=("xlstm-125m", ckpt, shape,
                                        "restore", batches), timeout_s=60,
                                  join_timeout_s=240)[0]
        assert whole.keys() == saved.keys()
        for k in saved:
            assert np.array_equal(whole[k], saved[k]), (shape, k)
        losses.append(loss)
    model = LM(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    opt = tsteps.init_opt_state(params)
    got = CheckpointManager(ckpt).restore(2, {"params": params, "opt": opt})
    for k, v in W._numpy_flat(got["params"]).items():
        assert np.array_equal(v, saved[k]), k
    step = tsteps.make_train_step(model, AdamWConfig(
        lr=1e-3, total_steps=8, warmup_steps=1))
    _, _, m = step(got["params"], got["opt"],
                   {k: torch.tensor(v) for k, v in batches[2].items()})
    losses.append(float(m["loss"]))
    assert max(losses) - min(losses) <= 1e-6 * abs(losses[0]), losses


# ------------------------------------------------------------------ ZeRO-1

def _jax_one_device_steps(arch, n_steps, lr):
    """The JAX package's jitted one-device train step on its smoke config
    (f32), from its seed-0 init and its synthetic batches: the initial
    parameters, the batches and the parameters after ``n_steps``."""
    import jax
    from repro.configs.archs import smoke_config
    from repro.data.pipeline import SyntheticLMData
    from repro.models.lm import LM as JLM
    from repro.optim.adamw import AdamWConfig as JAdamW
    from repro.training.steps import init_opt_state, make_train_step
    cfg = smoke_config(arch)
    assert cfg.dtype == "float32"
    model = JLM(cfg)
    data = SyntheticLMData(cfg, 8, 32)
    batches = [{k: np.asarray(v) for k, v in data.next_batch().items()}
               for _ in range(n_steps)]
    params = model.init(jax.random.key(0))
    start = jax.tree.map(np.asarray, params)
    opt = init_opt_state(params)
    fn = jax.jit(make_train_step(
        model, JAdamW(lr=lr, total_steps=n_steps, warmup_steps=2), None))
    losses = []
    for b in batches:
        params, opt, m = fn(params, opt, b)
        losses.append(float(m["loss"]))
    flat = {"/".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    return start, batches, flat, losses


def _zero1_share_bytes(cfg, shape):
    """A rank's AdamW moment bytes (m and v, f32) under ZeRO-1 over "data"
    on a ``shape`` ("data", "model") mesh, from fake whole parameters:
    each of the rank's leaves (its tensor-parallel placement) over the
    data ranks where ``sharding.opt_state_specs`` splits it; where no leaf
    is kept whole, ``opt_state_specs``' share."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.parallel import sharding, tensor
    mesh = tmesh.AbstractMesh(shape, ("data", "model"))
    dp = tmesh.axis_sizes(mesh)["data"]
    with FakeTensorMode():
        params = LM(cfg).init(torch.Generator(), device="cpu")
    specs = sharding.opt_state_specs(sharding.param_specs(params, mesh),
                                     params, mesh, zero_axes=("data",))["m"]
    placements = tensor.local_placement(params, mesh, cfg)
    shares = []

    def one(spec, pl, leaf):
        local = int(np.prod(pl.local_shape(leaf.shape)))
        shares.append(local // dp if "data" in spec else local)

    tree_map(one, specs, placements, params)
    return 2 * 4 * sum(shares)


def test_zero1_share_is_opt_state_specs_where_the_rank_holds_its_spec():
    """At (2, 2) the smoke configs and xlstm-125m hold ``param_specs``'
    bytes, so the rank's share is ``opt_state_specs``' own: each leaf's
    elements over the product of the axes its placement names."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.parallel import sharding
    for cfg in (tarchs.smoke_config("yi-6b"), tarchs.smoke_config(
            "xlstm-125m"), tarchs.ARCHS["xlstm-125m"]):
        mesh = tmesh.AbstractMesh((2, 2), ("data", "model"))
        sizes = tmesh.axis_sizes(mesh)
        with FakeTensorMode():
            params = LM(cfg).init(torch.Generator(), device="cpu")
        specs = sharding.opt_state_specs(sharding.param_specs(params, mesh),
                                         params, mesh)["m"]
        shares = []
        tree_map(lambda sp, leaf: shares.append(leaf.numel() // int(np.prod(
            [sizes[a] for a in sp if a is not None]))), specs, params)
        assert _zero1_share_bytes(cfg, (2, 2)) == 8 * sum(shares)


@pytest.mark.parametrize("arch", ["yi-6b", "xlstm-125m"])
def test_zero1_steps_on_2x2_equal_the_jax_one_device_step(arch):
    """Three ZeRO-1 steps of the smoke ``arch`` (f32) on (2, 2): every
    rank's whole parameters within 1e-5 of the JAX package's one-device
    step and of the port's plain step on the same ranks, the losses
    within 1e-5 (relative) of the JAX package's; each rank's moments
    exactly the share ``opt_state_specs`` gives it, half the plain
    step's."""
    start, batches, ref, ref_losses = _jax_one_device_steps(arch, 3, 1e-3)
    got = tmesh.spawn(W.zero1_train, 4, args=(arch, start, batches, 3, 1e-3),
                      timeout_s=60, join_timeout_s=300)
    share = _zero1_share_bytes(tarchs.smoke_config(arch), (2, 2))
    for r in got:
        assert r["moment_bytes"] == share
        for run in ("zero1", "plain"):
            for a, b in zip(r[run]["losses"], ref_losses):
                assert abs(a - b) <= 1e-5 * abs(b), (run, a, b)
        for k, want in ref.items():
            assert np.max(np.abs(r["zero1"]["params"][k] - want)) <= 1e-5, k
            assert np.max(np.abs(r["zero1"]["params"][k]
                                 - r["plain"]["params"][k])) <= 1e-5, k
