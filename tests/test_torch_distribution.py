"""The port's meshes and process plumbing (``launch.mesh``), sharding rules
(``parallel.axes``, ``parallel.sharding``), gradient compression
(``parallel.compression``) and data-parallel training
(``training.steps``, ``launch.train --mesh host``) against the JAX
package on the CPU.

Placements are held equal to the JAX package's ``PartitionSpec``s on the
same leaf shapes and mesh shapes, the production (16, 16) and
(2, 16, 16) included (abstract meshes on both sides).  Training runs on
gloo ranks (``launch.mesh.spawn``; rank bodies in
``tests/test_torch_dist_workers.py``) as the JAX package's
``test_compressed_training_multidevice_subprocess`` runs on 4 forced
host devices: compressed training's loss falls and ends within 0.35 of
the uncompressed run's.  The int8 reduction and two compressed steps
over 4 ranks equal the JAX package's ``compressed_psum`` under
``shard_map`` (4 forced host devices, a subprocess) and its AdamW on the
same gradients within 1e-6.  One data-parallel gradient over 2 ranks
equals the single-rank gradient of the whole batch within 1e-5 of each
leaf's max |g| (f32).  The launcher runs under ``torchrun`` as a
subprocess.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                 # noqa: E402
import jax.numpy as jnp                                    # noqa: E402

from repro.configs.archs import smoke_config as jsmoke     # noqa: E402
from repro.core.compat import abstract_mesh                # noqa: E402
from repro.models.lm import LM as JLM                      # noqa: E402
from repro.parallel import compression as jcomp            # noqa: E402
from repro.parallel import sharding as jshard              # noqa: E402
from repro.parallel.axes import default_rules as jdefault_rules  # noqa: E402

import test_torch_dist_workers as W                        # noqa: E402
from repro_torch.configs.archs import smoke_config         # noqa: E402
from repro_torch.data.pipeline import SyntheticLMData      # noqa: E402
from repro_torch.launch import mesh as tmesh               # noqa: E402
from repro_torch.launch import train as tlaunch            # noqa: E402
from repro_torch.models.lm import LM                       # noqa: E402
from repro_torch.optim.adamw import tree_map               # noqa: E402
from repro_torch.parallel import axes as taxes             # noqa: E402
from repro_torch.parallel import compression as tcomp      # noqa: E402
from repro_torch.parallel import sharding as tshard        # noqa: E402
from repro_torch.training import steps as tsteps           # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]

MESHES = [((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")), ((4,), ("data",))]
ARCHS = ["qwen3-4b", "qwen3-moe-30b-a3b", "zamba2-7b", "xlstm-125m",
         "whisper-tiny", "llava-next-34b"]


def _flat(tree, prefix=()):
    """{path: leaf} of a nested dict/list tree (a placement tuple is a
    leaf)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (str(k),)))
        return out
    if isinstance(tree, list) and tree and isinstance(tree[0], (dict, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, prefix + (str(i),)))
        return out
    return {"/".join(prefix): tree}


# ------------------------------------------------------------ meshes, rules

@pytest.mark.parametrize("shape,axes", MESHES)
def test_default_rules_equal_the_jax_package(shape, axes):
    mine = taxes.default_rules(tmesh.AbstractMesh(shape, axes))
    ref = jdefault_rules(abstract_mesh(shape, axes))
    assert mine.rules == ref.rules
    assert (mine.dp_axes, mine.ep_axis, mine.tp_axis) == \
        (ref.dp_axes, ref.ep_axis, ref.tp_axis)
    for logical in (("batch", "seq", "embed"), ("batch", None, "heads"),
                    ("zero",)):
        assert mine.spec(logical) == tuple(ref.spec(logical))


def test_constrain_is_an_identity_that_checks_names():
    x = torch.randn(2, 3, 4)
    assert taxes.constrain(x, "anything") is x          # no rules installed
    rules = taxes.default_rules(tmesh.AbstractMesh((2, 2),
                                                   ("data", "model")))
    with taxes.use_rules(rules):
        assert taxes.current_rules() is rules
        assert taxes.constrain(x, "batch", "seq", "embed") is x
        with pytest.raises(ValueError, match="no rule"):
            taxes.constrain(x, "batch", "sequence", "embed")
        with pytest.raises(ValueError, match="rank-3"):
            taxes.constrain(x, "batch", "seq", "embed", None)
    assert taxes.current_rules() is None


@pytest.mark.parametrize("arch", ARCHS)
def test_param_zero1_and_opt_specs_equal_the_jax_package(arch):
    mine_params = LM(smoke_config(arch)).init(
        torch.Generator().manual_seed(0), device="cpu")
    ref_shapes = jax.eval_shape(
        lambda: JLM(jsmoke(arch)).init(jax.random.key(0)))
    for shape, axes in MESHES:
        tm, jm = tmesh.AbstractMesh(shape, axes), abstract_mesh(shape, axes)
        mine = tshard.param_specs(mine_params, tm)
        ref = jshard.param_specs(ref_shapes, jm)
        ref_flat = {k: tuple(v) for k, v in _flat(ref).items()}
        assert {k: v for k, v in _flat(mine).items()} == ref_flat
        zero = tuple(a for a in ("pod", "data") if a in axes)
        for zaxes in (("data",), zero):
            mz = tshard.zero1_specs(mine, mine_params, tm, zaxes)
            rz = jshard.zero1_specs(ref, ref_shapes, jm, zaxes)
            assert _flat(mz) == {k: tuple(v)
                                 for k, v in _flat(rz).items()}
        mo = tshard.opt_state_specs(mine, mine_params, tm)
        ro = jshard.opt_state_specs(ref, ref_shapes, jm)
        assert mo["step"] == tuple(ro["step"])
        assert _flat(mo["m"]) == {k: tuple(v)
                                  for k, v in _flat(ro["m"]).items()}


def test_cache_specs_equal_the_jax_package():
    shapes = {"len": (), "attn_k": (4, 8, 64, 2, 16),
              "attn_v": (4, 8, 64, 2, 16), "cross_k": (2, 8, 12, 2, 16),
              "ssm": {"state": (4, 8, 4, 8, 8), "conv": (4, 8, 3, 96)},
              "blocks": {"k_s": (2, 8, 64, 4, 16), "c": (12, 16, 768)}}
    mine_tree = tree_map(lambda s: torch.empty(s), shapes)
    ref_tree = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32),
                            shapes, is_leaf=lambda s: isinstance(s, tuple))
    for shape, axes in MESHES:
        tm, jm = tmesh.AbstractMesh(shape, axes), abstract_mesh(shape, axes)
        mine = tshard.cache_specs(mine_tree, tm, taxes.default_rules(tm))
        ref = jshard.cache_specs(ref_tree, jm, jdefault_rules(jm))
        assert _flat(mine) == {k: tuple(v)
                               for k, v in _flat(ref).items()}


def test_meshes_without_enough_ranks_raise_the_jax_package_message():
    with pytest.raises(ValueError, match="need 256 devices for mesh"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="need 512 devices for mesh"):
        tmesh.make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="axis names"):
        tmesh.AbstractMesh((2, 2), ("data",))


def test_nccl_is_a_choice_never_a_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="--backend gloo"):
        tmesh.spawn(W.dp_grads, 2, backend="nccl", device="cuda")
    with pytest.raises(ValueError, match="CUDA devices only"):
        tmesh.spawn(W.dp_grads, 2, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        tmesh.spawn(W.dp_grads, 2, backend="mpi")


def test_host_mesh_and_a_failing_rank_on_gloo_ranks():
    """make_host_mesh over 4 ranks (its axis names, shapes smaller than
    the world, the JAX package's errors), and a rank that raises stops
    the run with its traceback instead of hanging it."""
    got = tmesh.spawn(W.host_meshes, 4, timeout_s=30, join_timeout_s=120)
    assert got[0] == {"default": {"data": 4}, "named": {"ax0": 2, "ax1": 2},
                      "sub": [0], "errors": ["axis names", "need 8 devices"]}
    assert got[3]["sub"] is None
    with pytest.raises(RuntimeError, match="rank 1 raised"):
        tmesh.spawn(W.raise_on_rank, 2, args=(1,), timeout_s=10,
                    join_timeout_s=60)


# ------------------------------------------------------------ compression

def test_quantize_round_trip_within_half_a_step_as_the_jax_package():
    x = np.random.RandomState(0).randn(1000).astype(np.float32) * 3.0
    q, s = tcomp.quantize(torch.tensor(x))
    jq, js = jcomp.quantize(jnp.asarray(x))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == pytest.approx(float(js), rel=1e-7)
    err = np.abs(tcomp.dequantize(q, s).numpy() - x)
    assert err.max() <= float(s) / 2 + 1e-6
    ef = tcomp.init_ef({"w": torch.zeros(3, 2, dtype=torch.bfloat16)})
    assert ef["w"].dtype == torch.float32 and not ef["w"].any()


def test_compressed_psum_on_one_rank_is_its_own_quantisation():
    g = {"a": torch.randn(5, 3), "b": [torch.randn(7)]}
    e = tcomp.init_ef(g)
    red, new_e = tcomp.compressed_psum(g, e)
    for key in ("a",):
        q, s = tcomp.quantize(g[key])
        assert torch.equal(red[key], tcomp.dequantize(q, s))
        assert torch.allclose(red[key] + new_e[key], g[key], atol=1e-6)


_JAX_COMPRESSED = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core.compat import shard_map
from repro.launch.mesh import make_host_mesh
from repro.optim import adamw
from repro.parallel.compression import compressed_psum
src, dst, meta = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
a = np.load(src)
mesh = make_host_mesh()

@jax.jit
def reduce(g, e):
    spec = {k: P("data") for k in g}
    def body(g, e):
        r, ne = compressed_psum({k: v[0] for k, v in g.items()},
                                {k: v[0] for k, v in e.items()}, ("data",))
        return ({k: v[None] for k, v in r.items()},
                {k: v[None] for k, v in ne.items()})
    r, ne = shard_map(body, mesh=mesh, in_specs=(spec, spec),
                      out_specs=(spec, spec), check_vma=False)(g, e)
    return {k: v[0] for k, v in r.items()}, ne

out = {}
names = ["%04d" % i for i in range(meta["n_seeded"])]
red, ne = reduce({n: jnp.asarray(a["ag" + n]) for n in names},
                 {n: jnp.asarray(a["ae" + n]) for n in names})
for n in names:
    out["ar" + n], out["ae" + n] = np.asarray(red[n]), np.asarray(ne[n])
names = ["%04d" % i for i in range(meta["n_params"])]
params = {n: jnp.asarray(a["p0_" + n]) for n in names}
ef = {n: jnp.zeros((4,) + params[n].shape, jnp.float32) for n in names}
inner = adamw.init(params)
cfg = adamw.AdamWConfig(**meta["opt_cfg"])
update = jax.jit(lambda g, s, p: adamw.update(cfg, g, s, p)[:2])
for t in range(meta["n_steps"]):
    red, ef = reduce({n: jnp.asarray(a["g%d_%s" % (t, n)]) for n in names},
                     ef)
    params, inner = update(red, inner, params)
    for n in names:
        out["p%d_%s" % (t, n)] = np.asarray(params[n])
        out["e%d_%s" % (t, n)] = np.asarray(ef[n])
np.savez(dst, **out)
"""


def _close(mine, ref, what, tol=1e-6, of=None):
    """|mine - ref| within ``tol`` of the largest |value| of ``of``
    (default ``ref``)."""
    scale = max(float(np.abs(ref if of is None else of).max()), 1e-30)
    err = float(np.abs(np.asarray(mine, np.float64) - ref).max())
    assert err <= tol * scale, (what, err, scale)


def test_compressed_reduction_and_step_on_4_ranks_equal_the_jax_package(
        tmp_path):
    """``compressed_psum`` over 4 gloo ranks on seeded per-rank gradients
    and error-feedback buffers (each rank's gradients at its own scale, so
    a scale on the wrong rank's row or a missing ``/ n`` shows; one leaf
    all zeros), then two compressed steps of yi-6b smoke (f32): the
    reduced gradients, every rank's new ef and the parameters after each
    step against the JAX package's ``compressed_psum`` under ``shard_map``
    on 4 forced host devices followed by its ``adamw.update`` (its
    compressed step's own sequence), fed the gradients each rank's step
    handed the reduction.  Within 1e-6 of each leaf's max |value|; the
    new ef, the folded gradient less its dequantised int8 (one fused
    multiply-add under XLA), within 1e-6 of the folded gradient's, the
    size its rounding has.  A wrong ef update is off by up to half a
    quantisation step, 1/254 of that."""
    world, n_steps = 4, 2
    rng = np.random.RandomState(3)
    shapes = [(5, 3), (7,), (2, 3, 4), (4,)]
    grads = {"%04d" % i: np.stack([rng.randn(*s).astype(np.float32)
                                   * 10.0 ** r for r in range(world)])
             for i, s in enumerate(shapes)}
    ef = {k: (rng.randn(*g.shape) * 0.05).astype(np.float32)
          for k, g in grads.items()}
    grads["0003"][:] = 0.0
    ef["0003"][:] = 0.0
    ranks = tmesh.spawn(W.compressed_cases, world,
                        args=(grads, ef, "yi-6b", n_steps, 8, 32, 1e-3),
                        timeout_s=60, join_timeout_s=240)
    paths = list(ranks[0]["params0"])
    key = {p: "%04d" % i for i, p in enumerate(paths)}
    arrays = {f"ag{k}": v for k, v in grads.items()}
    arrays.update({f"ae{k}": v for k, v in ef.items()})
    arrays.update({f"p0_{key[p]}": ranks[0]["params0"][p] for p in paths})
    for t in range(n_steps):
        arrays.update({f"g{t}_{key[p]}": np.stack(
            [r["steps"][t]["grads"][p] for r in ranks]) for p in paths})
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, **arrays)
    meta = {"n_seeded": len(grads), "n_params": len(paths),
            "n_steps": n_steps, "opt_cfg": ranks[0]["opt_cfg"]}
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_COMPRESSED, str(src), str(dst),
         json.dumps(meta)],
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")), cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = np.load(dst)
    for k in grads:
        for r, mine in enumerate(ranks):
            _close(mine["reduced"][k], ref[f"ar{k}"], ("reduced", k, r))
            _close(mine["ef"][k], ref[f"ae{k}"][r], ("ef", k, r),
                   of=grads[k][r] + ef[k][r])
    # the gradients differ between ranks and steps, so each step reduces
    # new data
    g0 = ranks[0]["steps"][0]["grads"][paths[0]]
    assert not np.array_equal(g0, ranks[1]["steps"][0]["grads"][paths[0]])
    for t in range(n_steps):
        for p in paths:
            for r, mine in enumerate(ranks):
                _close(mine["steps"][t]["params"][p],
                       ref[f"p{t}_{key[p]}"], ("params", t, p, r))
                folded = mine["steps"][t]["grads"][p] + (
                    ref[f"e{t - 1}_{key[p]}"][r] if t else 0.0)
                _close(mine["steps"][t]["ef"][p],
                       ref[f"e{t}_{key[p]}"][r], ("ef", t, p, r),
                       of=folded)


# --------------------------------------------------------------- training

def test_data_parallel_gradient_equals_the_whole_batch_gradient():
    """f32, yi-6b smoke: one data-parallel gradient over 2 ranks against
    the single-rank gradient of the whole global batch."""
    loss2, grads2 = tmesh.spawn(W.dp_grads, 2, args=("yi-6b", 4, 32),
                                timeout_s=60, join_timeout_s=180)[0]
    cfg = smoke_config("yi-6b")
    model = LM(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = SyntheticLMData(cfg, 4, 32, device="cpu").next_batch()
    loss1, _, grads1 = tsteps.make_grad_fn(model)(params, batch)
    assert abs(loss2 - float(loss1)) <= 1e-5 * abs(float(loss1))
    flat1, flat2 = _flat(grads1), _flat(grads2)
    assert flat1.keys() == flat2.keys()
    for k, g in flat1.items():
        g = g.numpy()
        scale = max(float(np.abs(g).max()), 1e-30)
        assert float(np.abs(flat2[k] - g).max()) <= 1e-5 * scale, k


def test_data_parallel_step_keeps_a_conv_on_its_rank():
    """A conv inside ``make_grad_fn(model, rules)`` runs on the rank's own
    batch (never through ``sharded_conv2d``), and the 2-rank gradient
    equals the whole batch's (masked labels included) within 1e-5."""
    rng = np.random.RandomState(5)
    params = {"k": (rng.randn(3, 3, 2, 4) * 0.3).astype(np.float32),
              "head": (rng.randn(4, 16) * 0.5).astype(np.float32)}
    labels = rng.randint(0, 16, size=(4, 16)).astype(np.int64)
    labels[0, :5] = -1
    batch = {"x": rng.randn(4, 6, 6, 2).astype(np.float32),
             "labels": labels}
    loss2, grads2, calls = tmesh.spawn(
        W.dp_conv_grads, 2, args=(params, batch), timeout_s=60,
        join_timeout_s=180)[0]
    assert calls == 0
    loss1, _, grads1 = tsteps.make_grad_fn(W.ConvModel())(
        {k: torch.tensor(v) for k, v in params.items()},
        {k: torch.tensor(v) for k, v in batch.items()})
    assert abs(loss2 - float(loss1)) <= 1e-5 * abs(float(loss1))
    for k, g in grads1.items():
        _close(grads2[k], g.numpy(), k, tol=1e-5)


def test_compressed_training_on_4_ranks_falls_and_tracks_plain():
    """The JAX package's compressed-training test over 4 gloo ranks:
    yi-6b smoke, global batch 8 x 32, lr 1e-3, 12 steps."""
    res = tmesh.spawn(W.train_losses, 4,
                      args=("yi-6b", 12, 8, 32, 1e-3, None),
                      timeout_s=60, join_timeout_s=240)[0]
    lc, lu = res["compressed"], res["plain"]
    assert all(np.isfinite(lc + lu))
    assert lc[-1] < lc[0], "compressed training did not reduce loss"
    assert abs(lc[-1] - lu[-1]) < 0.35, (lc[-1], lu[-1])


def test_train_launcher_under_torchrun_is_data_parallel(tmp_path):
    """``launch.train --mesh host`` under ``torchrun --nproc-per-node 2``
    on gloo CPU ranks, plain and compressed: each rank reports its
    losses, the same on both.  Each rank's standard output goes to its
    own file (``--log-dir``, ``--redirects 1``): two ranks writing one
    pipe can interleave their lines."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    summaries = {}
    for extra in ([], ["--compress-grads"]):
        logs = tmp_path / "logs" / str(len(extra))
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "--log-dir", str(logs),
             "--redirects", "1", "-m", "repro_torch.launch.train",
             "--arch", "yi-6b", "--smoke", "--steps", "4",
             "--global-batch", "4", "--seq-len", "32", "--lr", "3e-3",
             "--mesh", "host", "--device", "cpu", "--backend", "gloo",
             "--ckpt-dir", str(tmp_path / "ckpt" / str(len(extra))),
             "--ckpt-every", "2", *extra],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        outs = sorted(logs.rglob("stdout.log"))
        lines = [json.loads(line.split("summary ", 1)[1])
                 for out in outs for line in out.read_text().splitlines()
                 if line.startswith("[train] summary ")]
        assert len(outs) == 2 and sorted(s["rank"] for s in lines) == \
            [0, 1], [out.read_text()[-2000:] for out in outs]
        assert all(s["world"] == 2 and s["backend"] == "gloo"
                   for s in lines)
        assert lines[0]["losses"] == lines[1]["losses"]
        assert all(np.isfinite(lines[0]["losses"]))
        summaries[bool(extra)] = lines[0]
        assert (tmp_path / "ckpt" / str(len(extra))).exists()
    assert abs(summaries[True]["losses"][-1]
               - summaries[False]["losses"][-1]) < 0.35


def test_train_launcher_meshes_and_single_process_compression():
    with pytest.raises(ValueError, match="need 256 devices"):
        tlaunch.main(["--arch", "yi-6b", "--smoke", "--device", "cpu",
                      "--mesh", "production"])
    res = tlaunch.train(tlaunch.parse_args(
        ["--arch", "yi-6b", "--smoke", "--device", "cpu", "--steps", "3",
         "--global-batch", "2", "--seq-len", "16", "--compress-grads"]))
    assert len(res["losses"]) == 3 and np.isfinite(res["losses"]).all()
