"""The training slice: the port's AdamW and CNN trainer against the JAX
package's ``repro.optim.adamw`` and ``examples/train_cnn.py``.

The JAX trainer is loaded from its file with ``importlib``, unchanged.
Inputs (images, labels, parameters, gradients) are made with numpy from
a seed, or carried from JAX by ``convert.params_from_jax``, and fed to
both packages.  On the CPU the port's MEC kernels run their plain
versions and the JAX package's Pallas kernels run in interpret mode.

Tolerances, as scale-normalized max errors:
- AdamW is elementwise f32 arithmetic in the same order on both sides,
  so parameters and moments agree to 1e-6 and the scalars (grad norm,
  learning rate) to 1e-6 relative.
- A train step's gradients are held to 2 x the contract's grad tolerance
  (``numerics.grad_tolerance``, f32 scaled by sqrt(R/27)) at the model's
  largest reduction R (the first conv's d_kernel, i_n*o_h*o_w), its loss
  to 2 x the forward tolerance, and its updated parameters to the same
  bound as the gradients, since each side is held to the budget on its
  own.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                           # noqa: E402
import jax.numpy as jnp                              # noqa: E402

from repro.optim import adamw as j_adamw             # noqa: E402

from repro_torch.convert import params_from_jax      # noqa: E402
from repro_torch.core.numerics import fwd_tolerance, grad_tolerance  # noqa: E402
from repro_torch.examples import train_cnn           # noqa: E402
from repro_torch.kernels import mec_conv as K        # noqa: E402
from repro_torch.kernels.ref import scaled_error     # noqa: E402
from repro_torch.optim import adamw                  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PLAN_ENV = ("REPRO_TORCH_PLAN_CACHE_DIR", "REPRO_TORCH_CALIBRATION",
            "REPRO_PLAN_CACHE_DIR", "REPRO_CALIBRATION")


@pytest.fixture(autouse=True)
def plan_env(tmp_path, monkeypatch):
    """``--algorithm auto`` plans through both packages' plan caches: keep
    them, and the calibrations they consult, under tmp_path."""
    import repro.plan as jplan
    import repro_torch.plan as tplan
    for name in PLAN_ENV:
        monkeypatch.setenv(name, str(tmp_path / name))
    for mod in (tplan, jplan):
        mod.reset_global_plan_cache()
        mod.reset_calibration_cache()
    yield
    for mod in (tplan, jplan):
        mod.reset_global_plan_cache()
        mod.reset_calibration_cache()


def _jax_train_cnn():
    spec = importlib.util.spec_from_file_location(
        "jax_examples_train_cnn", REPO / "examples" / "train_cnn.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _leaf_pairs(j_tree, t_tree):
    """(jax leaf, torch leaf) pairs in the same order."""
    return list(zip(jax.tree.leaves(j_tree), adamw.tree_leaves(t_tree)))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _tree(rng, scale=1.0):
    return {"conv": {"w": rng.randn(3, 3, 2, 4).astype(np.float32) * scale,
                     "b": rng.randn(4).astype(np.float32) * scale},
            "head": {"w": rng.randn(8, 4).astype(np.float32) * scale}}


@pytest.mark.parametrize("cfg", [
    j_adamw.AdamWConfig(),                                     # clips (norm > 1)
    j_adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=3,
                        weight_decay=0.01, clip_norm=100.0),   # cosine, no clip
    j_adamw.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=2,
                        min_lr_frac=0.0, b2=0.999),            # past the end
], ids=["clip-warmup", "cosine", "past-end"])
def test_adamw_updates_match_jax(cfg):
    """Three updates on the same params and gradients: params, moments,
    step, grad norm and learning rate."""
    rng = np.random.RandomState(0)
    params = _tree(rng)
    j_params = jax.tree.map(jnp.asarray, params)
    t_params = params_from_jax(params, device="cpu")
    t_cfg = adamw.AdamWConfig(**cfg.__dict__)
    j_opt, t_opt = j_adamw.init(j_params), adamw.init(t_params)
    for _ in range(3):
        grads = _tree(rng, scale=0.7)
        j_params, j_opt, j_stats = j_adamw.update(
            cfg, jax.tree.map(jnp.asarray, grads), j_opt, j_params)
        t_params, t_opt, t_stats = adamw.update(
            t_cfg, params_from_jax(grads, device="cpu"), t_opt, t_params)
        for key in ("grad_norm", "lr"):
            assert float(t_stats[key]) == pytest.approx(float(j_stats[key]),
                                                        rel=1e-6)
        assert int(t_opt["step"]) == int(j_opt["step"])
        for j_tree, t_tree in ((j_params, t_params), (j_opt["m"], t_opt["m"]),
                               (j_opt["v"], t_opt["v"])):
            for j_leaf, t_leaf in _leaf_pairs(j_tree, t_tree):
                assert t_leaf.dtype == torch.float32
                assert scaled_error(t_leaf, _t(j_leaf)) <= 1e-6


def test_adamw_schedule_matches_jax():
    cfg = j_adamw.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=50)
    t_cfg = adamw.AdamWConfig(**cfg.__dict__)
    steps = np.arange(0, 60, dtype=np.int32)
    j_lr = np.asarray(j_adamw.schedule(cfg, jnp.asarray(steps)))
    t_lr = adamw.schedule(t_cfg, torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(t_lr, j_lr, rtol=1e-6, atol=0)


def test_adamw_decays_matrices_only_and_keeps_dtypes():
    params = {"w": torch.ones((2, 2), dtype=torch.bfloat16),
              "b": torch.ones((2,), dtype=torch.bfloat16)}
    zeros = adamw.tree_map(torch.zeros_like, params)
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=0, total_steps=1,
                            weight_decay=0.5)
    new, opt, stats = adamw.update(cfg, zeros, adamw.init(params), params)
    assert new["w"].dtype == torch.bfloat16 and opt["m"]["w"].dtype == torch.float32
    assert torch.equal(new["b"], params["b"])              # no decay on a vector
    assert torch.all(new["w"] < params["w"])               # decay on a matrix
    assert float(stats["grad_norm"]) == 0.0


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algorithm", ["mec_fused2", "mec"])
def test_train_step_matches_jax(algorithm):
    """One step of the CNN at width 4, batch 4, on 16x16 numpy images:
    the same loss, gradients and updated parameters as the JAX trainer's
    forward + value_and_grad + AdamW, with parameters carried over."""
    jtc = _jax_train_cnn()
    j_params = jtc.init_model(jax.random.key(0), 4)
    t_params = params_from_jax(jax.device_get(j_params), device="cpu")
    rng = np.random.RandomState(7)
    labels = rng.randint(0, 4, size=4).astype(np.int32)
    imgs = (0.3 * rng.randn(4, 16, 16, 1)).astype(np.float32)
    imgs[np.arange(4), 4 + 8 * (labels // 2), 4 + 8 * (labels % 2), 0] += 1.0

    def loss_fn(p):
        logits = jtc.forward(p, jnp.asarray(imgs), algorithm)
        return -jax.nn.log_softmax(logits)[jnp.arange(4), labels].mean()

    j_loss, j_grads = jax.value_and_grad(loss_fn)(j_params)
    cfg = j_adamw.AdamWConfig(lr=3e-3, total_steps=200, warmup_steps=10,
                              weight_decay=0.01)
    j_new, _, _ = j_adamw.update(cfg, j_grads, j_adamw.init(j_params), j_params)

    t_imgs, t_labels = torch.from_numpy(imgs), torch.from_numpy(labels).long()
    t_loss, _, t_grads = train_cnn.loss_and_grads(t_params, t_imgs, t_labels,
                                                  algorithm)
    t_new, _, t_loss2, _ = train_cnn.train_step(
        t_params, adamw.init(t_params), t_imgs, t_labels,
        adamw.AdamWConfig(**cfg.__dict__), algorithm)

    r_max = 4 * 8 * 8                 # c1's d_kernel: i_n * o_h * o_w
    tol = 2 * grad_tolerance(algorithm, "float32", r_max)
    assert float(t_loss) == pytest.approx(float(j_loss),
                                          rel=2 * fwd_tolerance(algorithm, "float32", 27))
    assert float(t_loss2) == float(t_loss)
    for j_leaf, t_leaf in _leaf_pairs(j_grads, t_grads):
        assert tuple(t_leaf.shape) == j_leaf.shape
        assert scaled_error(t_leaf, _t(j_leaf)) <= tol
    for j_leaf, t_leaf in _leaf_pairs(j_new, t_new):
        assert scaled_error(t_leaf, _t(j_leaf)) <= tol


def test_make_batch_draws_quadrant_blobs():
    gen = torch.Generator().manual_seed(3)
    imgs, labels = train_cnn.make_batch(gen, 64)
    assert tuple(imgs.shape) == (64, 32, 32, 1) and imgs.dtype == torch.float32
    assert labels.dtype == torch.int64 and set(labels.tolist()) <= {0, 1, 2, 3}
    quads = imgs[..., 0].reshape(64, 2, 16, 2, 16).mean(dim=(2, 4)).reshape(64, 4)
    assert torch.equal(quads.argmax(-1), labels)
    again, _ = train_cnn.make_batch(torch.Generator().manual_seed(3), 64)
    assert torch.equal(imgs, again)


def test_init_model_is_seeded_and_shaped():
    params = train_cnn.init_model(torch.Generator().manual_seed(0), 16, "cpu")
    jtc = _jax_train_cnn()
    j_shapes = jax.tree.map(lambda a: a.shape, jtc.init_model(jax.random.key(0), 16))
    assert [tuple(t.shape) for t in adamw.tree_leaves(params)] == \
        jax.tree.leaves(j_shapes, is_leaf=lambda x: isinstance(x, tuple))
    again = train_cnn.init_model(torch.Generator().manual_seed(0), 16, "cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(adamw.tree_leaves(params), adamw.tree_leaves(again)))


@pytest.mark.parametrize("algorithm", ["mec_fused2", "auto"])
def test_train_cnn_main_learns_on_cpu(algorithm, capsys):
    """The trainer at its defaults (width 16, batch 32, 200 steps) on CPU
    tensors clears the JAX trainer's bar, acc > 0.8, and launches no
    kernel."""
    K.reset_launch_counts()
    acc = train_cnn.main(["--algorithm", algorithm, "--device", "cpu"])
    assert acc > 0.8
    assert sum(K.launch_counts().values()) == 0
    out = capsys.readouterr().out
    assert f"every conv via conv2d(algorithm={algorithm!r})" in out
    assert "step  199" in out and "final acc" in out


@pytest.mark.parametrize("batch", [8, 32])
def test_resolve_plans_matches_the_jax_trainer(batch):
    """``--algorithm auto`` resolves one ConvPlan per layer, once: on the
    CPU the JAX trainer's plans, field for field (for the card, K1 plans);
    and a step replaying them equals the same step through the kwargs."""
    jtc = _jax_train_cnn()
    j_plans = jtc.resolve_plans(jtc.init_model(jax.random.key(0), 16), batch)
    params = train_cnn.init_model(torch.Generator().manual_seed(0), 16, "cpu")
    plans = train_cnn.resolve_plans(params, batch)
    assert {n: p.to_dict() for n, p in plans.items()} == \
        {n: p.to_dict() for n, p in j_plans.items()}
    assert train_cnn.resolve_plans(params, batch) == plans   # cache hits
    imgs, labels = train_cnn.make_batch(torch.Generator().manual_seed(2), batch)
    got = train_cnn.loss_and_grads(params, imgs, labels, "auto", plans)
    want = train_cnn.loss_and_grads(params, imgs, labels, plans["c1"].algorithm)
    assert torch.equal(got[1], want[1])
    from repro_torch.models.layers import plan_conv2d_layer
    card = plan_conv2d_layer(params["c1"], (batch, 32, 32, 1), stride=2,
                             backend="cuda")
    assert (card.algorithm, card.backend) == ("mec_fused", "cuda")
