"""The port's LM training step against the JAX package, per family, on the
CPU: the attention families (dense, vlm, moe with and without a shared
expert).  ``tests/test_torch_train_parity_recurrent.py`` runs the same
checks on the hybrid, ssm and audio families, from the helpers here (two
files, so the test runner's workers share the JAX compiles).

For each architecture at smoke size, on one synthetic batch from both
packages' pipelines (numpy, equal bits) and the JAX package's parameters
carried across with ``convert.params_from_jax``: ``LM.forward``'s hidden
states and aux loss; ``training.steps.make_loss_fn``'s loss, metrics and
every leaf's gradient; one ``make_train_step`` step (the AdamW update in
place): loss, grad norm, lr, the new parameters and moments.  The JAX
side is ``make_loss_fn``'s value and gradient (one jitted program, the
forward's outputs kept) and ``make_train_step``'s ``adamw.update`` on
those gradients.

Tolerance, as scale-normalised max errors (max|port - jax| / max|jax|):
1e-4, the slice bar of ``tests/test_torch_lm.py`` (``SLICE_TOL``), for the
hidden states, the loss, each leaf's gradient, the metrics and the
moments; the new parameters against the largest parameter of the tree
(AdamW divides each gradient by its own magnitude, so a near-zero
gradient's element has a meaningless leaf-relative error while the step
moves it by at most lr).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                           # noqa: E402

from repro.configs import archs as jarchs            # noqa: E402
from repro.data import pipeline as jpipe             # noqa: E402
from repro.models.lm import LM as JLM                # noqa: E402
from repro.optim import adamw as jadamw              # noqa: E402
from repro.training import loss as jloss             # noqa: E402
from repro.training import steps as jsteps           # noqa: E402

from repro_torch.configs import archs as tarchs      # noqa: E402
from repro_torch.convert import params_from_jax      # noqa: E402
from repro_torch.data import pipeline as tpipe       # noqa: E402
from repro_torch.models import lm as tlm             # noqa: E402
from repro_torch.optim import adamw                  # noqa: E402
from repro_torch.training import steps as tsteps     # noqa: E402

SLICE_TOL = 1e-4
OPT = adamw.AdamWConfig(total_steps=10)
# one architecture of each attention family, kimi-k2 for the shared expert
ATTN_ARCHS = ["qwen3-4b", "llava-next-34b", "qwen3-moe-30b-a3b",
              "kimi-k2-1t-a32b"]
_JAX = {}


@pytest.fixture(autouse=True)
def one_thread():
    """Smoke-size tensors on one intra-op thread: a test runner's parallel
    workers oversubscribe the cores, and torch's thread pool over tiny ops
    then waits far more than it computes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _err(port, ref) -> float:
    p = (port.detach().to(torch.float64).numpy()
         if isinstance(port, torch.Tensor) else np.asarray(port, np.float64))
    r = np.asarray(ref, np.float64)
    assert p.shape == r.shape, (p.shape, r.shape)
    scale = np.abs(r).max()
    return float(np.abs(p - r).max() / (scale if scale > 0 else 1.0))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _torch_side(arch):
    """The port's config, the JAX parameters carried across, its batch."""
    batch = tpipe.SyntheticLMData(tarchs.smoke_config(arch), 2, 32,
                                  device="cpu").next_batch()
    params = params_from_jax(jax.device_get(_jax_side(arch)[0]), device="cpu")
    return tarchs.smoke_config(arch), params, batch


def _jax_side(arch):
    """(params, (h, aux), (loss, metrics), grads, (new params, new state,
    metrics)) of the JAX package at smoke size, once per arch."""
    if arch not in _JAX:
        model = JLM(jarchs.smoke_config(arch))
        params = model.init(jax.random.key(0))
        batch = jpipe.SyntheticLMData(jarchs.smoke_config(arch), 2,
                                      32).next_batch()

        def loss_fn(params, batch):
            # jsteps.make_loss_fn's body, with the forward's outputs kept
            h, aux = model.forward(params, batch)
            loss, metrics = jloss.chunked_softmax_xent(
                h, model.head_weights(params), batch["labels"])
            return loss + aux, (dict(metrics, aux=aux), (h, aux))
        (loss, (metrics, fwd)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params, batch)
        # jsteps.make_train_step's update, on those gradients
        new_params, new_opt, om = jax.jit(functools.partial(
            jadamw.update, OPT))(grads, jsteps.init_opt_state(params), params)
        _JAX[arch] = (params, fwd, (loss, metrics), grads,
                      (new_params, new_opt, dict(metrics, loss=loss, **om)))
    return _JAX[arch]


def check_forward(arch):
    _, (jh, jaux), _, _, _ = _jax_side(arch)
    cfg, params, batch = _torch_side(arch)
    th, taux = tlm.LM(cfg).forward(params, batch)
    assert _err(th, jh) <= SLICE_TOL
    assert _err(taux, jaux) <= SLICE_TOL
    if cfg.family == "moe":
        assert float(taux) > 0


def check_gradients(arch):
    _, _, (jl, jm), jg, _ = _jax_side(arch)
    cfg, params, batch = _torch_side(arch)
    tp = tlm.tree_map(lambda t: t.requires_grad_(True), params)
    tl, tm = tsteps.make_loss_fn(tlm.LM(cfg))(tp, batch)
    tl.backward()
    assert _err(tl, jl) <= SLICE_TOL
    for key in ("nll", "aux", "tokens"):
        assert _err(tm[key], jm[key]) <= SLICE_TOL, key
    jleaves = _leaves(jax.device_get(jg))
    for name, t in _leaves(tp).items():
        assert _err(t.grad, jleaves[name]) <= SLICE_TOL, name


def check_train_step(arch):
    _, _, _, _, (jnew, jopt, jmet) = _jax_side(arch)
    cfg, params, batch = _torch_side(arch)
    step = tsteps.make_train_step(tlm.LM(cfg), OPT)
    opt = tsteps.init_opt_state(params)
    p2, o2, met = step(params, opt, batch)
    assert p2 is params and o2 is opt
    for key in ("loss", "grad_norm", "lr", "nll", "aux"):
        assert _err(met[key], jmet[key]) <= SLICE_TOL, key
    wl = {n: np.asarray(v, np.float32)
          for n, v in _leaves(jax.device_get(jnew)).items()}
    scale = max(np.abs(v).max() for v in wl.values())
    for name, t in _leaves(p2).items():
        assert np.abs(t.float().numpy() - wl[name]).max() <= SLICE_TOL * scale
    for got, want in ((o2["m"], jopt["m"]), (o2["v"], jopt["v"])):
        wl = _leaves(jax.device_get(want))
        for name, t in _leaves(got).items():
            assert _err(t, wl[name]) <= SLICE_TOL, name
    assert int(o2["step"]) == int(jopt["step"]) == 1


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_forward_and_aux_match_jax(arch):
    check_forward(arch)


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_loss_gradients_match_jax(arch):
    check_gradients(arch)


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_train_step_matches_jax(arch):
    """One step: loss, grad norm, lr, the new parameters and moments."""
    check_train_step(arch)
