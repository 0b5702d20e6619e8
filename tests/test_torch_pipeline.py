"""The port's GPipe primitive (``repro_torch.parallel.pipeline``) on 4 gloo
CPU ranks, as the JAX package's ``tests/test_pipeline.py`` runs it on 4
forced host devices: 8 layers in 4 stages, 4 microbatches, against the
sequential stack of the same numpy parameters in both packages (forward
error under 1e-5, gradient error under 1e-4, the reference's bars), with
and without rematerialisation."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                 # noqa: E402
import jax.numpy as jnp                                    # noqa: E402

import test_torch_dist_workers as W                        # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, spawn    # noqa: E402
from repro_torch.parallel.pipeline import pipeline_apply   # noqa: E402

L, D, B = 8, 16, 12


def _inputs():
    rng = np.random.RandomState(0)
    params = {"w": (rng.randn(L, D, D) * D ** -0.5).astype(np.float32),
              "b": (rng.randn(L, D) * 0.1).astype(np.float32)}
    return params, rng.randn(B, D).astype(np.float32)


def _jax_sequential(params, x):
    def block(p, h):
        return jnp.tanh(h @ p["w"] + p["b"]) + h

    def loss(p, xx):
        out, _ = jax.lax.scan(lambda h, q: (block(q, h), None), xx, p)
        return jnp.sum(out ** 2), out

    (_, out), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    return {"out": np.asarray(out), "dx": np.asarray(gx),
            "dw": np.asarray(gp["w"]), "db": np.asarray(gp["b"])}


def _torch_sequential(params, x):
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    xt = torch.tensor(x, requires_grad=True)
    h = xt
    for i in range(L):
        h = torch.tanh(h @ p["w"][i] + p["b"][i]) + h
    (h ** 2).sum().backward()
    return {"out": h.detach().numpy(), "dx": xt.grad.numpy(),
            "dw": p["w"].grad.numpy(), "db": p["b"].grad.numpy()}


@pytest.fixture(scope="module")
def pipelined():
    """Both rematerialisation settings, one spawn of 4 ranks."""
    params, x = _inputs()
    ranks = spawn(W.pipeline_cases, 4, args=(params, x, 4, (True, False)),
                  timeout_s=30, join_timeout_s=120)
    return params, x, ranks


@pytest.mark.parametrize("remat", [True, False])
def test_pipeline_matches_sequential_and_trains(pipelined, remat):
    params, x, ranks = pipelined
    for ref in (_torch_sequential(params, x), _jax_sequential(params, x)):
        for rank in ranks:                 # every stage holds the whole
            got = rank[remat]
            err = float(np.max(np.abs(got["out"] - ref["out"])))
            gerr = max(float(np.max(np.abs(got[k] - ref[k])))
                       for k in ("dx", "dw", "db"))
            assert err < 1e-5, err
            assert gerr < 1e-4, gerr


def test_pipeline_rejects_uneven_splits():
    mesh = AbstractMesh((4,), ("pipe",))
    params = {"w": torch.zeros(6, 2, 2)}
    with pytest.raises(ValueError, match="layers"):
        pipeline_apply(lambda p, h: h, params, torch.zeros(4, 2), mesh,
                       "pipe", 2)
    params = {"w": torch.zeros(8, 2, 2)}
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(lambda p, h: h, params, torch.zeros(6, 2), mesh,
                       "pipe", 4)
