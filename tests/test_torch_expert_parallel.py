"""The port's expert parallelism (``models.moe._moe_ep``), its int8
all-to-all and the moe family's data-parallel routing against the JAX
package on the CPU.

``moe_ffn`` with ``moe_impl="ep"`` on 4 gloo ranks under
``("data", "model")`` (2, 2) rules against the JAX package's ``_moe_ep``
on 4 forced host devices (one subprocess), on the same seeded inputs and
experts: the output, the aux loss and the gradients of sum(y * g) + aux
(input, router, experts) within 1e-5 of their largest value with the
float dispatch, within the JAX package's own 5e-4 with
``moe_dispatch_int8`` (an entry on a rounding boundary may quantize one
step apart).  ``int8_all_to_all`` fed seeded rows on 2 ranks equals the
JAX package's under ``shard_map`` on 2 forced devices to the bit,
forward and VJP, and its all-to-all sends a quarter of the f32 bytes
plus the bf16 scales.  The data-parallel gradient of the moe smoke
config on 2 ranks equals one process's on the global batch: the
gradient within 1e-5, the dropped assignments exactly.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                 # noqa: E402
import jax.numpy as jnp                                    # noqa: E402

from repro.configs import archs as jarchs                  # noqa: E402
from repro.models import moe as jmoe                       # noqa: E402

import test_torch_dist_workers as W                        # noqa: E402
from repro_torch.configs import archs as tarchs            # noqa: E402
from repro_torch.launch import mesh as tmesh               # noqa: E402
from repro_torch.models import moe as tmoe                 # noqa: E402
from repro_torch.models.lm import LM                       # noqa: E402
from repro_torch.training import steps as tsteps           # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


def _close(mine, ref, what, tol):
    ref = np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(np.asarray(mine, np.float64) - ref).max())
    assert err <= tol * scale, (what, err, scale)


_JAX_EP = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs.archs import smoke_config
from repro.models import moe
from repro.parallel.axes import default_rules, use_rules
src, dst = sys.argv[1], sys.argv[2]
a = np.load(src)
mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2), ("data", "model"))
rules = default_rules(mesh)
out = {}
for int8 in (False, True):
    cfg = smoke_config("qwen3-moe-30b-a3b").with_(
        moe_impl="ep", moe_dispatch_int8=int8, capacity_factor=2.0)
    p = {k: jnp.asarray(a[k]) for k in ("router", "wg", "wu", "wd")}

    def loss(p, x):
        with use_rules(rules):
            y, aux = moe._moe_ep(p, cfg, x, rules)
        return jnp.sum(y * jnp.asarray(a["g"])) + aux, (y, aux)

    with mesh:
        (_, (y, aux)), (dp, dx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(a["x"]))
    tag = "i" if int8 else "f"
    out[tag + "y"], out[tag + "aux"] = np.asarray(y), np.asarray(aux)
    out[tag + "dx"] = np.asarray(dx)
    for k in ("router", "wg", "wu", "wd"):
        out[tag + "d" + k] = np.asarray(dp[k])
np.savez(dst, **out)
"""


@pytest.fixture(scope="module")
def ep_case(tmp_path_factory):
    """Seeded experts, input and cotangent; the JAX package's ``_moe_ep``
    on (2, 2) forced host devices (float and int8 dispatch)."""
    cfg = jarchs.smoke_config("qwen3-moe-30b-a3b")
    p = jax.device_get(jmoe.init_moe(jax.random.key(11), cfg, jnp.float32))
    rng = np.random.RandomState(4)
    x = rng.randn(4, 8, cfg.d_model).astype(np.float32)
    g = rng.randn(4, 8, cfg.d_model).astype(np.float32)
    tmp = tmp_path_factory.mktemp("ep")
    np.savez(tmp / "in.npz", x=x, g=g,
             **{k: np.asarray(p[k]) for k in ("router", "wg", "wu", "wd")})
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_EP, str(tmp / "in.npz"),
         str(tmp / "out.npz")],
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")), cwd=REPO,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return ({k: np.asarray(p[k]) for k in ("router", "wg", "wu", "wd")}, x,
            g, dict(np.load(tmp / "out.npz")))


@pytest.mark.parametrize("int8", [False, True])
def test_expert_parallel_on_2x2_matches_the_jax_package(ep_case, int8):
    p, x, g, ref = ep_case
    tol, tag = (5e-4, "i") if int8 else (1e-5, "f")
    ranks = tmesh.spawn(W.ep_forward, 4,
                        args=(p, x, g, {"moe_dispatch_int8": int8,
                                        "capacity_factor": 2.0}, (2, 2)),
                        timeout_s=60, join_timeout_s=240)
    # rank = data * 2 + model: the model ranks of a data rank hold its rows
    y = np.concatenate([ranks[0]["y"], ranks[2]["y"]])
    dx = np.concatenate([ranks[0]["dx"], ranks[2]["dx"]])
    assert np.array_equal(ranks[0]["y"], ranks[1]["y"])
    _close(y, ref[tag + "y"], "y", tol)
    _close(dx, ref[tag + "dx"], "dx", tol)
    aux = (ranks[0]["aux"] + ranks[2]["aux"]) / 2
    assert abs(aux - float(ref[tag + "aux"])) <= tol * abs(
        float(ref[tag + "aux"]))
    _close(ranks[0]["drouter"] + ranks[2]["drouter"], ref[tag + "drouter"],
           "drouter", tol)
    for k in ("wg", "wu", "wd"):
        mine = np.concatenate([ranks[m]["dexperts"][k]
                               + ranks[2 + m]["dexperts"][k]
                               for m in range(2)])
        _close(mine, ref[tag + "d" + k], k, tol)
    # the bytes each rank sends: int8 codes and bf16 scales a row, or f32
    e, d = 8, x.shape[-1]
    cap = tmoe._capacity(2 * 4, tarchs.smoke_config(
        "qwen3-moe-30b-a3b").with_(capacity_factor=2.0))
    rows = 2 * (e // 2) * cap              # dispatch and return, half sent
    per_row = d + 2 if int8 else 4 * d
    fwd_bwd = 2
    assert ranks[0]["a2a_bytes"] == fwd_bwd * rows * per_row


_JAX_INT8 = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.core.compat import shard_map
from repro.models.moe import int8_all_to_all
src, dst = sys.argv[1], sys.argv[2]
a = np.load(src)
mesh = Mesh(np.asarray(jax.devices()), ("model",))
n, e = a["x"].shape[:2]
f = shard_map(lambda v: int8_all_to_all(v, "model", 0, 1), mesh=mesh,
              in_specs=P("model"), out_specs=P("model"), check_vma=False)
x = jnp.asarray(a["x"].reshape((n * e,) + a["x"].shape[2:]))
y, vjp = jax.vjp(f, x)
g = a["g"].reshape((n * a["g"].shape[1],) + a["g"].shape[2:])
(dx,) = vjp(jnp.asarray(g))
np.savez(dst, y=np.asarray(y), dx=np.asarray(dx))
"""


def test_int8_all_to_all_and_its_vjp_equal_the_jax_package(tmp_path):
    rng = np.random.RandomState(8)
    # (ranks, E, C, d): each rank's buckets; rows of very different scales
    x = (rng.randn(2, 4, 3, 16) * np.exp(rng.randn(2, 4, 3, 1) * 2)
         ).astype(np.float32)
    g = (rng.randn(2, 2, 6, 16)).astype(np.float32)
    np.savez(tmp_path / "in.npz", x=x, g=g)
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_INT8, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")],
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")), cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = np.load(tmp_path / "out.npz")
    ranks = tmesh.spawn(W.int8_a2a, 2, args=(x, g), timeout_s=60,
                        join_timeout_s=120)
    for r, (y, dx) in enumerate(ranks):
        assert np.array_equal(y, ref["y"][r * 2:(r + 1) * 2]), r
        assert np.array_equal(dx, ref["dx"][r * 4:(r + 1) * 4]), r


def test_q8_codes_and_scales_equal_the_jax_package():
    x = np.random.RandomState(2).randn(6, 5, 32).astype(np.float32) * 3.0
    q, s = tmoe._q8(torch.tensor(x))
    jq, js = jmoe._q8(jnp.asarray(x))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.float().numpy(),
                          np.asarray(js.astype(jnp.float32)))


def test_moe_data_parallel_gradient_equals_the_global_batch():
    """qwen3-moe smoke at capacity factor 1.0 (so assignments drop), f32:
    the 2-rank data-parallel gradient and the ranks' dropped assignments
    against one process on the global batch."""
    over = {"capacity_factor": 1.0}
    cfg = tarchs.smoke_config("qwen3-moe-30b-a3b").with_(**over)
    data = __import__("repro_torch.data.pipeline", fromlist=["x"])
    batch = {k: v.numpy() for k, v in data.SyntheticLMData(
        cfg, 8, 32, device="cpu").next_batch().items()}
    loss2, grads2, drops2 = tmesh.spawn(W.moe_dp_grads, 2,
                                        args=(batch, over), timeout_s=60,
                                        join_timeout_s=240)[0]
    model = LM(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    with tmoe.count_drops("cpu") as drops:
        loss1, _, grads1 = tsteps.make_grad_fn(model)(
            params, {k: torch.tensor(v) for k, v in batch.items()})
    assert int(drops) > 0 and drops2 == int(drops)
    assert abs(loss2 - float(loss1)) <= 1e-5 * abs(float(loss1))
    for k, g in W._numpy_flat(grads1).items():
        _close(grads2[k], g, k, 1e-5)


def test_rank_local_expert_draws_equal_the_slice_of_the_whole():
    """``init_moe(tp=(2, r))`` draws the whole stream and keeps rank r's
    experts: equal to the slice of the one-rank draw, to the bit."""
    cfg = tarchs.smoke_config("kimi-k2-1t-a32b").with_(moe_impl="ep")
    whole = tmoe.init_moe(torch.Generator().manual_seed(3), cfg,
                          torch.float32, device="cpu", prefix=(3,))
    e = cfg.n_experts
    for r in range(2):
        part = tmoe.init_moe(torch.Generator().manual_seed(3), cfg,
                             torch.float32, device="cpu", prefix=(3,),
                             tp=(2, r))
        for k in ("wg", "wu", "wd"):
            assert torch.equal(part[k],
                               whole[k][:, r * e // 2:(r + 1) * e // 2])
        assert torch.equal(part["router"], whole["router"])
        f = whole["shared"]["gate"]["w"].shape[-1]
        assert torch.equal(part["shared"]["gate"]["w"],
                           whole["shared"]["gate"]["w"][
                               ..., r * f // 2:(r + 1) * f // 2])
