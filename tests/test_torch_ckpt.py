"""The port's checkpointing, resume and watchdog against the JAX package,
on the CPU.

``tests/test_fault_tolerance.py`` ported (all but
``test_elastic_restore_changes_sharding``: restoring onto a mesh is
ROADMAP Queue 1 item 11, and raises): ``ckpt.manager.CheckpointManager``
(round trip with bf16 leaves, atomicity, retention, the async writer),
the crash-and-resume run, ``training.watchdog.StepWatchdog``.  The
on-disk layout is the JAX package's: a checkpoint written by
``repro.ckpt.manager`` (bf16 leaves included) restores in the port and
one written by the port restores in the JAX package, leaf for leaf and
bit for bit.  ``launch.train`` resumed from its checkpoint takes the
uninterrupted run's losses to the bit.  Tensors restored equal the saved
ones exactly (no tolerance: a checkpoint is bits).
"""
import json
import shutil
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                           # noqa: E402
import jax.numpy as jnp                              # noqa: E402

from repro.ckpt import manager as jmanager           # noqa: E402

from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.configs.archs import smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataState, SyntheticLMData  # noqa: E402
from repro_torch.launch import train as tlaunch      # noqa: E402
from repro_torch.models.lm import LM                 # noqa: E402
from repro_torch.optim import adamw                  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig      # noqa: E402
from repro_torch.training.steps import init_opt_state, make_train_step  # noqa: E402
from repro_torch.training.watchdog import StepWatchdog  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """Smoke-size tensors on one intra-op thread: a test runner's parallel
    workers oversubscribe the cores, and torch's thread pool over tiny ops
    then waits far more than it computes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree_equal(a, b) -> bool:
    la, lb = adamw.tree_leaves(a), adamw.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_ckpt_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    tree = {"a": torch.arange(6).reshape(2, 3).to(torch.bfloat16),
            "b": {"c": torch.ones((4,))}}
    mgr.save(7, {"params": tree})
    assert mgr.latest_step() == 7
    out = mgr.restore(7, {"params": tree})
    assert _tree_equal(out["params"], tree)
    assert out["params"]["a"].dtype == torch.bfloat16


def test_ckpt_atomic_no_partial(tmp_path):
    """A leftover .tmp directory is never considered a checkpoint."""
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"params": {"w": torch.ones(3)}})
    fake_tmp = tmp_path / "step_00000002.tmp"
    fake_tmp.mkdir()
    (fake_tmp / "garbage").write_text("crash mid-write")
    assert mgr.latest_step() == 1


def test_ckpt_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"params": {"w": torch.ones(2) * s}})
    assert mgr.all_steps() == [3, 4]


def test_ckpt_async(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save_async(5, {"params": {"w": torch.zeros(128)}})
    mgr.wait()
    assert mgr.latest_step() == 5


def test_save_async_copies_before_it_returns(tmp_path):
    """The step loop may write the parameters in place right after
    ``save_async`` returns: the checkpoint holds the values at the call."""
    mgr = CheckpointManager(tmp_path)
    w = torch.arange(1000, dtype=torch.float32)
    mgr.save_async(1, {"params": {"w": w}})
    w.add_(1.0)
    mgr.wait()
    out = mgr.restore(1, {"params": {"w": torch.empty(1000)}})
    assert torch.equal(out["params"]["w"], torch.arange(1000, dtype=torch.float32))


def test_restore_checks_dtype_and_shape(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"params": {"w": torch.ones((2, 3))}})
    with pytest.raises(ValueError, match="does not match"):
        mgr.restore(1, {"params": {"w": torch.ones((3, 2))}})
    with pytest.raises(ValueError, match="does not match"):
        mgr.restore(1, {"params": {"w": torch.ones((2, 3), dtype=torch.bfloat16)}})


def test_crash_resume_is_exact(tmp_path):
    """Train 8 steps straight vs 4 steps + 'crash' + resume 4 steps: the
    final parameters are bit-identical (atomic checkpoint + resumable
    data)."""
    cfg = smoke_config("yi-6b")
    model = LM(cfg)
    step_fn = make_train_step(model, AdamWConfig(total_steps=8,
                                                 warmup_steps=2))

    def fresh():
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        return (params, init_opt_state(params),
                SyntheticLMData(cfg, 4, 32, device="cpu"))

    params, opt, data = fresh()
    for _ in range(8):
        params, opt, _ = step_fn(params, opt, data.next_batch())
    straight = params

    mgr = CheckpointManager(tmp_path)
    params, opt, data = fresh()
    for _ in range(4):
        params, opt, _ = step_fn(params, opt, data.next_batch())
    mgr.save(4, {"params": params, "opt": opt, "data": data.state.to_dict()})
    del params, opt, data                      # "crash"

    params, opt, data = fresh()                # cold restart
    restored = mgr.restore(4, {"params": params, "opt": opt,
                               "data": data.state.to_dict()})
    params, opt = restored["params"], restored["opt"]
    data.state = DataState.from_dict(restored["data"])
    assert data.state.step == 4 and int(opt["step"]) == 4
    for _ in range(4):
        params, opt, _ = step_fn(params, opt, data.next_batch())
    assert _tree_equal(straight, params), "resume diverged from straight run"


def test_restore_onto_a_mesh_raises(tmp_path):
    """``restore(shardings=)`` keeps each rank's pieces of the stored whole
    array (the elastic path; across real meshes in
    ``tests/test_torch_tensor_parallel.py``), and a like leaf that is not
    the rank's slice of the stored array raises."""
    from repro_torch.parallel.tensor import Placement, Sharding
    mgr = CheckpointManager(tmp_path)
    tree = {"w": torch.arange(16.0).reshape(4, 4)}
    mgr.save(1, {"params": tree})
    cols = Placement(-1, ((4, True),), 2)
    for rank in range(2):
        out = mgr.restore(1, {"params": {"w": torch.empty(4, 2)}},
                          shardings={"params": {"w": Sharding(cols, rank)}})
        assert torch.equal(out["params"]["w"],
                           tree["w"][:, 2 * rank:2 * rank + 2])
    with pytest.raises(ValueError, match="does not match"):
        mgr.restore(1, {"params": {"w": torch.empty(4, 4)}},
                    shardings={"params": {"w": Sharding(cols, 0)}})


def test_watchdog_flags_straggler():
    dog = StepWatchdog(threshold=2.0, warmup_steps=0)
    for dt in [0.01] * 8:
        dog.start_step()
        time.sleep(dt)
        dog.end_step()
    dog.start_step()
    time.sleep(0.1)                  # 10x median
    dog.end_step()
    assert dog.straggler_events >= 1


def test_watchdog_hard_deadline():
    dog = StepWatchdog(hard_timeout_s=0.01)
    dog.start_step()
    time.sleep(0.05)
    with pytest.raises(TimeoutError):
        dog.check_deadline()


# ---------------------------------------------------------------------------
# the JAX package's layout, both ways
# ---------------------------------------------------------------------------

def _jax_tree():
    rng = np.random.RandomState(0)
    return {"params": {"emb": jnp.asarray(rng.randn(5, 3), jnp.bfloat16),
                       "blocks": {"w": jnp.asarray(rng.randn(2, 3, 4),
                                                   jnp.float32),
                                  "n": jnp.asarray(rng.randn(2, 3),
                                                   jnp.bfloat16)}},
            "opt": {"step": jnp.asarray(3, jnp.int32),
                    "m": {"w": jnp.asarray(rng.randn(4), jnp.float32)}},
            "data": {"step": np.asarray(9)}}


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.dtype.kind == "i" and tree.ndim == 0:
        return tree
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jtree = _jax_tree()
    jmanager.CheckpointManager(tmp_path).save(12, jtree)
    like = _as_torch(jtree)
    mgr = CheckpointManager(tmp_path)
    assert mgr.latest_step() == 12
    out = mgr.restore(12, like)
    assert _tree_equal(out["params"], like["params"])
    assert out["params"]["emb"].dtype == torch.bfloat16
    assert _tree_equal(out["opt"], like["opt"])
    assert DataState.from_dict(out["data"]).step == 9


def test_port_checkpoint_restores_in_jax(tmp_path):
    jtree = _jax_tree()
    CheckpointManager(tmp_path).save(3, _as_torch(jtree))
    manifest = json.loads((tmp_path / "step_00000003" / "manifest.json")
                          .read_text())
    assert manifest["trees"]["params"]["emb"]["dtype"] == "bfloat16"
    assert manifest["trees"]["params"]["blocks/w"]["file"] == "blocks__w.npy"
    out = jmanager.CheckpointManager(tmp_path).restore(3, jtree)
    for name in ("params", "opt"):
        for a, b in zip(jax.tree.leaves(out[name]), jax.tree.leaves(jtree[name])):
            assert a.dtype == b.dtype
            assert np.array_equal(np.asarray(a).reshape(-1).view(np.uint8),
                                  np.asarray(b).reshape(-1).view(np.uint8))


# ---------------------------------------------------------------------------
# the launcher's resume
# ---------------------------------------------------------------------------

def _run(tmp_path, steps, ckpt_dir):
    args = tlaunch.parse_args([
        "--arch", "xlstm-125m", "--smoke", "--steps", str(steps),
        "--global-batch", "4", "--seq-len", "16", "--ckpt-dir", str(ckpt_dir),
        "--ckpt-every", "4", "--log-every", "100", "--device", "cpu"])
    return tlaunch.train(args)


def test_launch_train_resumes_to_the_uninterrupted_losses(tmp_path):
    """8 steps with checkpoints at 4 and 8; a second run from the step-4
    checkpoint alone takes steps 4..7 with the same losses, to the bit, and
    its final checkpoint equals the first run's."""
    first = _run(tmp_path, 8, tmp_path / "a")
    assert first["start"] == 0 and len(first["losses"]) == 8
    assert first["losses"][-1] < first["losses"][0]
    (tmp_path / "b").mkdir()
    shutil.copytree(tmp_path / "a" / "step_00000004",
                    tmp_path / "b" / "step_00000004")
    second = _run(tmp_path, 8, tmp_path / "b")
    assert second["start"] == 4
    assert second["losses"] == first["losses"][4:]
    assert _tree_equal(second["params"], first["params"])
    assert CheckpointManager(tmp_path / "b").all_steps() == [4, 8]
