"""The port's LM training path against the JAX package, on the CPU.

K5's gradient (``kernels.mec_conv1d.conv1d_grads``, the backward of the
``mec_conv1d`` autograd node) against the plain version's autograd;
``training.loss.chunked_softmax_xent`` against ``repro.training.loss``
(the three chunked-xent tests of ``tests/test_training.py`` ported);
``optim.adamw.update_`` against the pure ``update``;
``tests/test_archs.py``'s ``test_forward_and_train_step`` and
``test_decode_matches_prefill`` for every architecture;
``data.pipeline.SyntheticLMData`` against ``repro.data.pipeline``;
``tests/test_training.py::test_train_loss_decreases_end_to_end`` through
``repro_torch.launch.train``.  Inputs are made with numpy from a seed
(the synthetic batches are numpy in both packages); parameters are drawn
by the JAX package and carried across with ``convert.params_from_jax``.
``LM.forward``, the loss's gradients and one ``make_train_step`` step per
family are held to the JAX package in ``tests/test_torch_train_parity.py``
(and ``..._recurrent.py``).

Tolerances, as scale-normalised max errors (max|port - jax| / max|jax|),
the bars of ``tests/test_torch_lm.py``: 1e-5 for a function in f32
(``F32_TOL``: the loss over given hidden states and its gradients; the
fused conv's gradients against the lowered conv's).  K5's gradients on the
CPU, the in-place AdamW step against the pure one, the synthetic batches,
a recomputed (remat) block's gradients and a resumed run's losses are
equal to the bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                           # noqa: E402
import jax.numpy as jnp                              # noqa: E402

from repro.configs import archs as jarchs            # noqa: E402
from repro.data import pipeline as jpipe             # noqa: E402
from repro.optim import adamw as jadamw              # noqa: E402
from repro.training import loss as jloss             # noqa: E402
from repro.training import steps as jsteps           # noqa: E402

from repro_torch.configs import archs as tarchs      # noqa: E402
from repro_torch.configs.shapes import SHAPES, make_batch, smoke_shape  # noqa: E402
from repro_torch.convert import params_from_jax      # noqa: E402
from repro_torch.data import pipeline as tpipe       # noqa: E402
from repro_torch.kernels import mec_conv1d as C      # noqa: E402
from repro_torch.launch import train as tlaunch      # noqa: E402
from repro_torch.models import lm as tlm             # noqa: E402
from repro_torch.models import serve as tserve       # noqa: E402
from repro_torch.optim import adamw                  # noqa: E402
from repro_torch.training import loss as tloss       # noqa: E402
from repro_torch.training import steps as tsteps     # noqa: E402

F32_TOL = 1e-5
ALL_ARCHS = sorted(tarchs.ARCHS)
CONV_FAMILY_ARCHS = ["zamba2-7b", "xlstm-125m"]


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


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _to_torch(tree):
    return params_from_jax(jax.device_get(tree), device="cpu")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _batches(arch, batch=2, seq=32, seed=0):
    """The same synthetic batch from both packages' pipelines."""
    jd = jpipe.SyntheticLMData(jarchs.smoke_config(arch), batch, seq, seed=seed)
    td = tpipe.SyntheticLMData(tarchs.smoke_config(arch), batch, seq, seed=seed,
                               device="cpu")
    return jd.next_batch(), td.next_batch()


# ---------------------------------------------------------------------------
# K5's gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k_w", [1, 3, 4, 9])
@pytest.mark.parametrize("x_dtype,k_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"), ("float16", "float16"),
    ("bfloat16", "float32"), ("float32", "bfloat16"), ("float16", "bfloat16")])
def test_conv1d_grads_equal_the_plain_autograd(x_dtype, k_dtype, k_w):
    """The autograd node's dx and dk equal the plain version's autograd to
    the bit, in the operands' own dtypes, on a strided x (a column slice of
    a wider row, as the Mamba2 block passes it)."""
    xd, kd = getattr(torch, x_dtype), getattr(torch, k_dtype)
    row = torch.from_numpy(_rand((2, 37, 19), 1)).to(xd)
    k = torch.from_numpy(_rand((k_w, 11), 2)).to(kd)
    g = torch.from_numpy(_rand((2, 37, 11), 3)).to(xd)
    grads = []
    for fn in (C.mec_conv1d_plain, C.mec_conv1d):
        r = row.clone().requires_grad_(True)
        kk = k.clone().requires_grad_(True)
        y = fn(r[..., 4:15], kk)
        y.backward(g)
        grads.append((r.grad, kk.grad, y))
    (rp, kp, yp), (rk, kk_, yk) = grads
    assert yk.grad_fn is not None and torch.equal(yk, yp)
    assert rk.dtype == xd and kk_.dtype == kd
    assert torch.equal(rk, rp) and torch.equal(kk_, kp)


def test_conv1d_grads_write_out_the_formulas():
    """dx is the anti-causal conv of g, dk the products of g with the
    left-padded x (f64 against the module's formulas)."""
    x = torch.from_numpy(_rand((2, 9, 5), 4)).double()
    k = torch.from_numpy(_rand((4, 5), 5)).double()
    g = torch.from_numpy(_rand((2, 9, 5), 6)).double()
    dx, dk = C.conv1d_grads(g, x, k)
    gp = torch.nn.functional.pad(g, (0, 0, 0, 3))
    want_dx = sum(gp[:, 3 - j:3 - j + 9] * k[j] for j in range(4))
    xp = torch.nn.functional.pad(x, (0, 0, 3, 0))
    want_dk = torch.stack([(xp[:, j:j + 9] * g).sum((0, 1)) for j in range(4)])
    assert torch.allclose(dx, want_dx) and torch.allclose(dk, want_dk)
    # and it is the flipped causal conv of the flipped cotangent
    flip = C.mec_conv1d_plain(g.flip(1), k).flip(1)
    assert torch.allclose(dx, flip)


def test_conv1d_is_once_differentiable():
    x = torch.randn(1, 6, 3, requires_grad=True)
    k = torch.randn(2, 3, requires_grad=True)
    y = C.mec_conv1d(x, k).square().sum()
    (gx,) = torch.autograd.grad(y, x, create_graph=True)
    with pytest.raises(RuntimeError):
        gx.sum().backward()


@pytest.mark.parametrize("arch", CONV_FAMILY_ARCHS)
def test_fused_conv_gradients_equal_the_lowered(arch):
    """A train step's gradients through ``conv_impl="fused"`` (K5's node)
    against ``"lowered"`` (the compact L, autograd), f32."""
    cfg = tarchs.smoke_config(arch)
    params = tlm.LM(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    _, batch = _batches(arch)
    grads = {}
    for impl in ("fused", "lowered"):
        model = tlm.LM(cfg.with_(conv_impl=impl))
        p = tlm.tree_map(lambda t: t.clone().requires_grad_(True), params)
        loss, _ = tsteps.make_loss_fn(model)(p, batch)
        loss.backward()
        grads[impl] = {n: t.grad for n, t in _leaves(p).items()}
    for name, g in grads["fused"].items():
        assert _err(g, grads["lowered"][name].numpy()) <= F32_TOL, name


# ---------------------------------------------------------------------------
# chunked cross-entropy (tests/test_training.py, ported and held to JAX)
# ---------------------------------------------------------------------------

def _dense_xent(h, w, labels):
    logits = h @ w
    return -torch.log_softmax(logits, -1).gather(
        -1, labels[..., None].long())[..., 0].mean()


def test_chunked_xent_matches_dense():
    b, s, d, v = 2, 13, 8, 31
    h, w = torch.from_numpy(_rand((b, s, d), 0)), torch.from_numpy(_rand((d, v), 1))
    labels = torch.from_numpy(np.random.RandomState(2).randint(0, v, (b, s)))
    loss, metrics = tloss.chunked_softmax_xent(h, w, labels, chunk=4,
                                               z_loss=0.0)
    np.testing.assert_allclose(float(loss), float(_dense_xent(h, w, labels)),
                               rtol=1e-5)
    assert int(metrics["tokens"]) == b * s


def test_chunked_xent_ignores_masked():
    h, w = torch.from_numpy(_rand((1, 6, 4), 3)), torch.from_numpy(_rand((4, 9), 4))
    labels = torch.tensor([[1, 2, -1, -1, 3, -1]])
    loss, metrics = tloss.chunked_softmax_xent(h, w, labels, chunk=2,
                                               z_loss=0.0)
    assert int(metrics["tokens"]) == 3
    assert np.isfinite(float(loss))


def test_chunked_xent_grad_matches_dense():
    b, s, d, v = 2, 8, 6, 17
    h = torch.from_numpy(_rand((b, s, d), 5))
    w0 = torch.from_numpy(_rand((d, v), 6))
    labels = torch.from_numpy(np.random.RandomState(7).randint(0, v, (b, s)))
    w1, w2 = w0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
    tloss.chunked_softmax_xent(h, w1, labels, chunk=3, z_loss=0.0)[0].backward()
    _dense_xent(h, w2, labels).backward()
    np.testing.assert_allclose(w1.grad.numpy(), w2.grad.numpy(), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [3, 4, 512])
def test_chunked_xent_matches_jax(chunk, dtype):
    """Loss, metrics and the gradients of h and the head against the JAX
    package's, z-loss and ignored labels included; the gradients come back
    in the operands' dtypes."""
    b, s, d, v = 2, 13, 8, 31
    h, w = _rand((b, s, d), 8), _rand((d, v), 9)
    labels = np.random.RandomState(10).randint(0, v, (b, s)).astype(np.int32)
    labels[0, 3] = labels[1, 7] = -1
    jdt = jnp.dtype(dtype)

    def jfn(h, w):
        loss, m = jloss.chunked_softmax_xent(h, w, jnp.asarray(labels),
                                             chunk=chunk)
        return loss, m
    (jl, jm), (jgh, jgw) = jax.value_and_grad(jfn, argnums=(0, 1),
                                              has_aux=True)(
        jnp.asarray(h, jdt), jnp.asarray(w, jdt))
    th = torch.from_numpy(h).to(getattr(torch, dtype)).requires_grad_(True)
    tw = torch.from_numpy(w).to(getattr(torch, dtype)).requires_grad_(True)
    tl, tm = tloss.chunked_softmax_xent(th, tw, torch.from_numpy(labels),
                                        chunk=chunk)
    tl.backward()
    tol = F32_TOL if dtype == "float32" else 1e-2
    assert _err(tl, jl) <= F32_TOL and _err(tm["nll"], jm["nll"]) <= F32_TOL
    assert int(tm["tokens"]) == int(jm["tokens"]) == b * s - 2
    assert th.grad.dtype == th.dtype and tw.grad.dtype == tw.dtype
    assert _err(th.grad.float(), np.asarray(jgh, np.float32)) <= tol
    assert _err(tw.grad.float(), np.asarray(jgw, np.float32)) <= tol


# ---------------------------------------------------------------------------
# AdamW in place
# ---------------------------------------------------------------------------

def test_inplace_update_equals_the_pure_update(monkeypatch):
    """Three steps of ``update_`` against three of ``update``: parameters
    (f32 and bf16, matrices decayed), moments, step, grad norm and lr to the
    bit, with leaves longer than a slice (SLICE made small)."""
    monkeypatch.setattr(adamw, "SLICE", 7)
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    params = {"w": torch.from_numpy(_rand((5, 6), 11)),
              "b": torch.from_numpy(_rand((6,), 12)).to(torch.bfloat16),
              "m": {"k": torch.from_numpy(_rand((3, 4, 5), 13)).to(torch.bfloat16)}}
    pure_p, pure_s = params, adamw.init(params)
    ip_p = adamw.tree_map(torch.clone, params)
    ip_s = adamw.init(ip_p)
    for i in range(3):
        grads = adamw.tree_map(
            lambda t: torch.from_numpy(_rand(tuple(t.shape), 20 + i)).to(t.dtype),
            params)
        pure_p, pure_s, pm = adamw.update(cfg, grads, pure_s, pure_p)
        same_p = ip_p
        im = adamw.update_(cfg, grads, ip_s, ip_p)
        assert same_p is ip_p
        for a, b in zip(adamw.tree_leaves(pure_p), adamw.tree_leaves(ip_p)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        for key in ("m", "v"):
            for a, b in zip(adamw.tree_leaves(pure_s[key]),
                            adamw.tree_leaves(ip_s[key])):
                assert torch.equal(a, b)
        assert int(ip_s["step"]) == int(pure_s["step"]) == i + 1
        assert torch.equal(pm["grad_norm"], im["grad_norm"])
        assert torch.equal(pm["lr"], im["lr"])


def test_inplace_update_refuses_strided_leaves():
    p = {"w": torch.zeros((4, 6))[:, ::2]}
    with pytest.raises(ValueError, match="contiguous"):
        adamw.update_(adamw.AdamWConfig(), {"w": torch.ones((4, 3))},
                      adamw.init(p), p)


def test_global_norm_by_slices_matches_jax(monkeypatch):
    monkeypatch.setattr(adamw, "SLICE", 10)
    tree = {"a": _rand((7, 9), 30), "b": _rand((13,), 31)}
    want = jadamw.global_norm({k: jnp.asarray(v) for k, v in tree.items()})
    got = adamw.global_norm({k: torch.from_numpy(v) for k, v in tree.items()})
    assert _err(got, want) <= F32_TOL


# ---------------------------------------------------------------------------
# per architecture, on the port (the parity per family is in
# tests/test_torch_train_parity*.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cell():
    return smoke_shape(SHAPES["train_4k"])


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_forward_and_train_step(arch, cell):
    """``tests/test_archs.py::test_forward_and_train_step`` on the port."""
    cfg = tarchs.smoke_config(arch)
    model = tlm.LM(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = make_batch(cfg, cell, device="cpu")
    h, aux = model.forward(params, batch)
    assert h.shape == (cell.global_batch, batch["tokens"].shape[1], cfg.d_model)
    assert not bool(torch.isnan(h).any())
    before = adamw.tree_map(torch.clone, params)
    step = tsteps.make_train_step(model, adamw.AdamWConfig(total_steps=10))
    p2, _, metrics = step(params, tsteps.init_opt_state(params), batch)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    delta = sum(float((a.detach().float() - b.float()).abs().sum()) for a, b in
                zip(adamw.tree_leaves(p2), adamw.tree_leaves(before)))
    assert delta > 0


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_decode_matches_prefill(arch):
    """``tests/test_archs.py::test_decode_matches_prefill`` on the port."""
    cfg = tarchs.smoke_config(arch)
    model = tlm.LM(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    b, s = 2, 17
    toks = torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab, (b, s)))
    batch, full = {"tokens": toks[:, :s - 1]}, {"tokens": toks}
    max_len = s + 8 + (cfg.prefix_len if cfg.family == "vlm" else 0)
    if cfg.family == "vlm":
        batch["vision"] = full["vision"] = torch.from_numpy(
            _rand((b, cfg.prefix_len, cfg.d_model), 2))
    if cfg.family == "audio":
        batch["frames"] = full["frames"] = torch.from_numpy(
            _rand((b, cfg.encoder_len, cfg.d_model), 3))
    with torch.inference_mode():
        _, cache = tserve.prefill(model, params, batch, max_len=max_len)
        dec, _ = tserve.decode_step(model, params, cache, toks[:, s - 1:s])
        ref, _ = tserve.prefill(model, params, full, max_len=max_len)
    rel = float((dec - ref).abs().max() / (ref.abs().max() + 1e-9))
    assert rel < 2e-2, f"{arch}: decode/prefill mismatch rel={rel}"


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ["yi-6b", "qwen3-moe-30b-a3b", "zamba2-7b",
                                  "xlstm-125m", "whisper-tiny"])
def test_remat_gradients_equal_no_remat(arch, policy):
    """Checkpointed blocks recompute the same values: loss and gradients
    equal to the bit with ``remat`` off."""
    cfg = tarchs.smoke_config(arch)
    params = tlm.LM(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    _, batch = _batches(arch)
    out = []
    for remat in (False, True):
        model = tlm.LM(cfg.with_(remat=remat, remat_policy=policy))
        p = tlm.tree_map(lambda t: t.clone().requires_grad_(True), params)
        loss, _ = tsteps.make_loss_fn(model)(p, batch)
        loss.backward()
        out.append((loss, [t.grad for t in _leaves(p).values()]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


@pytest.mark.parametrize("arch", ["yi-6b", "qwen3-moe-30b-a3b", "zamba2-7b",
                                  "xlstm-125m", "whisper-tiny"])
def test_layers_split_each_stacked_leaf_once(arch):
    """``LM.forward`` splits every stacked leaf once (``lm.layer_trees``):
    in the loss's graph one node feeds each leaf's gradient, so the
    backward stacks the layers' gradients once, where a view a layer would
    feed it from every layer."""
    cfg = tarchs.smoke_config(arch).with_(n_layers=4)
    params = tlm.LM(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    _, batch = _batches(arch)
    p = tlm.tree_map(lambda t: t.clone().requires_grad_(True), params)
    loss, _ = tsteps.make_loss_fn(tlm.LM(cfg))(p, batch)
    feeders, seen, todo = {}, set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if nxt is not None and hasattr(nxt, "variable"):
                feeders.setdefault(id(nxt.variable), set()).add(node)
            todo.append(nxt)
    stacked = {"blocks", "enc_blocks", "dec_blocks", "mamba", "mlstm", "slstm"}
    leaves = {n: t for n, t in _leaves(p).items()
              if n.split("/")[1] in stacked | {"mamba_norms"}}
    assert leaves
    for name, t in leaves.items():
        assert len(feeders.get(id(t), ())) == 1, name


def test_distributed_steps_raise():
    """What distributed training cannot run raises: rules over a mesh whose
    "model" axis has no ranks behind it (an AbstractMesh; the steps run
    tensor parallel over a DeviceMesh, ``tests/test_torch_tensor_parallel.py``)
    and the production mesh on a world of one process (the JAX package's
    "need N devices"), from either launcher.  What one process has runs:
    the compressed step carries ``ef`` and trains."""
    from repro_torch.launch import serve as tserve_launch
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.axes import default_rules
    cfg = tarchs.smoke_config("yi-6b")
    model = tlm.LM(cfg)
    tp = default_rules(AbstractMesh((2, 2), ("data", "model")))
    for call in (lambda: tsteps.make_compressed_train_step(model, None, tp),
                 lambda: tsteps.make_train_step(model, None, rules=tp)):
        with pytest.raises(ValueError, match="DeviceMesh"):
            call()
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    prompt = {"tokens": torch.zeros((1, 4), dtype=torch.long)}
    with pytest.raises(ValueError, match="DeviceMesh"):
        tsteps.make_prefill_step(model, 8, rules=tp)(params, prompt)
    for main in (tlaunch.main, tserve_launch.main):
        with pytest.raises(ValueError, match="need 256 devices"):
            main(["--arch", "yi-6b", "--smoke", "--device", "cpu",
                  "--mesh", "production"])
    state = tsteps.init_opt_state(params, compressed=True)
    assert sorted(state) == ["ef", "m", "step", "v"]
    step = tsteps.make_compressed_train_step(
        model, AdamWConfig(lr=1e-3, total_steps=2, warmup_steps=1), None)
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32),
             "labels": torch.ones((2, 8), dtype=torch.int32)}
    _, state, metrics = step(params, state, batch)
    assert torch.isfinite(metrics["loss"]) and int(state["step"]) == 1
    assert any(bool(e.any()) for e in adamw.tree_leaves(state["ef"]))


def test_metrics_shape_is_the_jax_package_own():
    assert tsteps.metrics_shape(None) == jsteps.metrics_shape(None)


# ---------------------------------------------------------------------------
# the data pipeline and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["yi-6b", "llava-next-34b", "whisper-tiny"])
def test_synthetic_batches_equal_the_jax_package_bits(arch):
    jd = jpipe.SyntheticLMData(jarchs.smoke_config(arch), 4, 16, seed=3)
    td = tpipe.SyntheticLMData(tarchs.smoke_config(arch), 4, 16, seed=3,
                               device="cpu")
    for _ in range(3):
        jb, tb = jd.next_batch(), td.next_batch()
        assert sorted(jb) == sorted(tb)
        for key in jb:
            want = np.array(jb[key])
            assert tb[key].dtype == torch.from_numpy(want).dtype, key
            assert np.array_equal(tb[key].numpy(), want), key
    assert td.state.step == jd.state.step == 3
    state = tpipe.DataState.from_dict(td.state.to_dict())
    assert state.step == 3
    assert jpipe.DataState.from_dict(td.state.to_dict()).step == 3


def test_data_pipeline_host_sharding():
    cfg = tarchs.smoke_config("yi-6b")
    full = tpipe.SyntheticLMData(cfg, 8, 16, device="cpu")
    h0 = tpipe.SyntheticLMData(cfg, 8, 16, host_id=0, num_hosts=2, device="cpu")
    h1 = tpipe.SyntheticLMData(cfg, 8, 16, host_id=1, num_hosts=2, device="cpu")
    bf, b0, b1 = full.next_batch(), h0.next_batch(), h1.next_batch()
    assert torch.equal(bf["tokens"][0::2], b0["tokens"])
    assert torch.equal(bf["tokens"][1::2], b1["tokens"])
    with pytest.raises(ValueError):
        tpipe.SyntheticLMData(cfg, 7, 16, num_hosts=2, device="cpu")


def test_train_loss_decreases_end_to_end():
    """``tests/test_training.py::test_train_loss_decreases_end_to_end``
    through the port's launcher: a tiny dense model on the structured
    synthetic data must learn."""
    loss = tlaunch.main(["--arch", "qwen3-4b", "--smoke", "--steps", "60",
                         "--global-batch", "16", "--seq-len", "64",
                         "--lr", "3e-3", "--log-every", "100",
                         "--device", "cpu"])
    # random floor ln(256) = 5.55; the topic structure is worth ln(16) = 2.77
    assert loss < 4.3, loss
