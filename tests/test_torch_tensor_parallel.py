"""The port's tensor parallelism over the "model" axis
(``repro_torch.parallel.tensor`` and the layers that read it) against the
JAX package on the CPU.

Ranks are gloo processes (``launch.mesh.spawn``; rank bodies in
``tests/test_torch_dist_workers.py``).  Every family's smoke config on a
(1, 2) mesh, from the JAX package's parameters (``params_from_jax(mesh=)``
gives each rank its slices), against the JAX package's one-device
forward, gradient and gradient norm (f32): the final hidden and the loss
within 1e-5 of their largest value, every leaf's gradient (gathered
whole) within 1e-5 of its largest |g|, the global norm within 1e-6.
Placements: Mamba2's ``in_proj`` cut per segment, the kv slots of every
rank's q heads, and each rank's bytes equal to ``param_specs``' plus the
replicated excess at tp 2, 4, 8 and 16 (fake-free meta trees of the full
configs from the JAX package's ``eval_shape``).  Serving and the segment
round trip are in ``test_torch_tensor_parallel_serve.py``, the train
steps and checkpoints in ``test_torch_tensor_parallel_steps.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                 # noqa: E402

from repro.configs import archs as jarchs                  # noqa: E402
from repro.data import pipeline as jpipe                   # noqa: E402
from repro.models.lm import LM as JLM                      # noqa: E402
from repro.optim import adamw as jadamw                    # noqa: E402
from repro.training import steps as jsteps                 # noqa: E402

import test_torch_dist_workers as W                        # noqa: E402
from repro_torch.configs import archs as tarchs            # noqa: E402
from repro_torch.launch import mesh as tmesh               # noqa: E402
from repro_torch.models.lm import LM                       # noqa: E402
from repro_torch.parallel import tensor                    # noqa: E402
from repro_torch.parallel.axes import default_rules, use_rules  # noqa: E402

#: one architecture of each family
FAMILIES = ["qwen3-4b", "llava-next-34b", "whisper-tiny", "zamba2-7b",
            "xlstm-125m", "qwen3-moe-30b-a3b"]
#: the cases where a segment does not divide into whole heads, on 2 ranks
EDGES = [("yi-6b", {"n_kv_heads": 1}),
         ("yi-6b", {"n_heads": 6, "n_kv_heads": 3}),
         ("yi-6b", {"n_heads": 3, "n_kv_heads": 1}),
         ("kimi-k2-1t-a32b", {}),
         ("zamba2-7b", {"conv_impl": "fused"}),
         ("xlstm-125m", {"conv_impl": "fused"})]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
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


def _close(mine, ref, what, tol):
    ref = np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(np.asarray(mine, np.float64) - ref).max())
    assert err <= tol * scale, (what, err, scale)


def _jax_grads(arch, over):
    """The JAX package's one-device (params, batch, loss, hidden, grads,
    global norm) of the smoke ``arch`` (f32)."""
    cfg = jarchs.smoke_config(arch).with_(**over)
    model = JLM(cfg)
    params = model.init(jax.random.key(0))
    batch = jpipe.SyntheticLMData(cfg, 2, 32).next_batch()
    loss_fn = jsteps.make_loss_fn(model)
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, batch)
    h, _ = jax.jit(model.forward)(params, batch)
    return (jax.device_get(params), {k: np.asarray(v) for k, v in
                                     batch.items()},
            float(loss), np.asarray(h), _flat(jax.device_get(grads)),
            float(jadamw.global_norm(grads)))


#: the recurrent families' cases, run by
#: ``test_torch_tensor_parallel_recurrent.py`` (two files, so the test
#: runner's workers share the load)
RECURRENT = {"zamba2-7b", "xlstm-125m"}


def check_family(arch, over):
    params, batch, loss, h, grads, gnorm = _jax_grads(arch, over)
    got = tmesh.spawn(W.tp_family_grads, 2, args=(arch, params, batch, over),
                      timeout_s=60, join_timeout_s=240)[0]
    t_loss, t_h, t_grads, t_norm = got
    assert abs(t_loss - loss) <= 1e-5 * abs(loss)
    _close(t_h, h, "hidden", 1e-5)
    assert set(t_grads) == {k.replace("/", "/") for k in grads}
    for k, g in grads.items():
        _close(t_grads[k], g, k, 1e-5)
    assert abs(t_norm - gnorm) <= 1e-6 * gnorm, (t_norm, gnorm)


@pytest.mark.parametrize("arch,over", [(a, o) for a, o in
                                       [(a, {}) for a in FAMILIES] + EDGES
                                       if a not in RECURRENT])
def test_family_on_2_ranks_matches_the_jax_package(arch, over):
    check_family(arch, over)


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-125m",
                                  "qwen3-moe-30b-a3b"])
def test_params_from_jax_gives_each_rank_its_slice(arch):
    over = {"moe_impl": "ep"} if arch.startswith("qwen3-moe") else {}
    cfg = jarchs.smoke_config(arch).with_(**over)
    params = jax.device_get(JLM(cfg).init(jax.random.key(1)))
    assert all(tmesh.spawn(W.tp_params_from, 2, args=(arch, params, over),
                           timeout_s=60, join_timeout_s=180))


# ------------------------------------------------------------- placements

def test_mamba_in_proj_is_cut_per_segment():
    """Rank r's in_proj holds its half of z, of x and of dt, and the whole
    B and C; conv_w its half of x and the whole B and C."""
    cfg = tarchs.smoke_config("zamba2-7b")
    d_in, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    h = d_in // cfg.ssm_head_dim
    w = torch.arange(2 * d_in + 2 * n + h, dtype=torch.float32)[None]
    c = torch.arange(d_in + 2 * n, dtype=torch.float32)[None]
    tree = {"mamba": {"in_proj": {"w": w}, "conv_w": c}}
    for r in range(2):
        got = tensor.shard_params(tree, 2, cfg, r)["mamba"]
        half, hh = d_in // 2, h // 2
        z = torch.arange(r * half, (r + 1) * half)
        x = d_in + z
        bc = torch.arange(2 * d_in, 2 * d_in + 2 * n)
        dt = 2 * d_in + 2 * n + torch.arange(r * hh, (r + 1) * hh)
        assert torch.equal(got["in_proj"]["w"][0],
                           torch.cat([z, x, bc, dt]).float())
        assert torch.equal(got["conv_w"][0], torch.cat(
            [z, torch.arange(d_in, d_in + 2 * n)]).float())


def _meta_params(arch):
    """The full config's parameter tree as meta tensors (shapes and dtypes
    from the JAX package's ``eval_shape``)."""
    shapes = jax.eval_shape(lambda: JLM(jarchs.ARCHS[arch]).init(
        jax.random.key(0)))
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    return {k: torch.empty(v.shape, dtype=dt[str(v.dtype)], device="meta")
            for k, v in _flat(shapes).items()}


def _expected_excess(arch, tp, flat, spec_bytes):
    """The replicated excess of each leaf, by the rules written out: a
    block whose heads do not divide is whole on every rank (so its leaves
    carry what ``param_specs`` split), kv heads that do not divide keep
    wk/wv whole, Mamba2 keeps B and C whole, local-dispatch experts are
    whole; in each case the excess is the whole leaf's bytes less the
    spec's share."""
    cfg = tarchs.ARCHS[arch]
    out = {}

    def whole_minus_spec(k):
        t = flat[k]
        diff = t.numel() * t.element_size() - spec_bytes[k]
        if diff:
            out[k] = diff

    for k, t in flat.items():
        leaf = k.split("/")
        if "attn" in leaf or "xattn" in leaf:
            if cfg.n_heads % tp:
                whole_minus_spec(k)
            elif cfg.n_kv_heads % tp and leaf[-2] in ("wk", "wv") \
                    and leaf[-1] == "w":
                whole_minus_spec(k)
        elif leaf[0] in ("mamba", "mamba_tail") and leaf[-1] != "b":
            h = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
            if h % tp:
                whole_minus_spec(k)
            elif leaf[-2:] == ["in_proj", "w"] or leaf[-1] == "conv_w":
                rows = t.numel() // t.shape[-1]
                # B and C (2n columns) whole where the spec splits by tp
                bc = rows * 2 * cfg.ssm_state * t.element_size()
                out[k] = bc - bc // tp
        elif leaf[0] in ("mlstm", "slstm") and cfg.n_heads % tp:
            whole_minus_spec(k)
        elif leaf[-2:-1] == ["moe"] and leaf[-1] in ("wg", "wu", "wd") \
                and cfg.moe_impl != "ep":
            whole_minus_spec(k)
    return out


@pytest.mark.parametrize("arch", sorted(tarchs.ARCHS))
def test_rank_bytes_are_the_specs_plus_the_replicated_excess(arch):
    flat = _meta_params(arch)
    tree = _nest(flat)
    cfg = tarchs.ARCHS[arch]
    for tp in (2, 4, 8, 16):
        mesh = tmesh.AbstractMesh((16 // tp if tp < 16 else 1, tp),
                                  ("data", "model"))
        from repro_torch.parallel.sharding import param_specs
        specs = _flat(param_specs(tree, mesh))
        spec_bytes = {}
        for k, t in flat.items():
            div = 1
            for dim, ax in zip(t.shape, specs[k]):
                if ax is not None:
                    div *= tp
            spec_bytes[k] = t.numel() * t.element_size() // div
        excess = tensor.excess_bytes(tree, mesh, cfg)
        assert excess == _expected_excess(arch, tp, flat, spec_bytes), tp
        assert tensor.local_param_bytes(tree, mesh, cfg) == \
            tensor.spec_local_bytes(tree, mesh, cfg) + sum(excess.values())
        assert tensor.spec_local_bytes(tree, mesh, cfg) == sum(spec_bytes.values())


@pytest.mark.parametrize("tp", [2, 4, 8, 16])
def test_kv_slots_cover_the_q_heads_of_the_rank(tp):
    """Every q head of every rank reads, through its local kv slot, the kv
    head the whole model's GQA grouping gives it."""
    for arch in sorted(tarchs.ARCHS):
        cfg = tarchs.ARCHS[arch]
        if cfg.n_heads % tp:
            continue
        h_loc, g = cfg.n_heads // tp, cfg.n_heads // cfg.n_kv_heads
        for r in range(tp):
            slots = tensor.kv_slots(cfg, tp, r)
            assert len(slots) == tensor.local_kv_heads(
                cfg, tensor.TP(None, 0, tp)) and h_loc % len(slots) == 0
            g_loc = h_loc // len(slots)
            for i in range(h_loc):
                assert slots[i // g_loc] == (r * h_loc + i) // g, (arch, r)


def test_rules_over_an_abstract_model_axis_raise():
    """A forward under rules whose "model" axis has no ranks behind it
    raises; a 1-way axis is the one-rank path."""
    cfg = tarchs.smoke_config("yi-6b")
    model = LM(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with use_rules(default_rules(tmesh.AbstractMesh((1, 2),
                                                    ("data", "model")))):
        with pytest.raises(ValueError, match="needs a DeviceMesh"):
            model.forward(params, {"tokens": tokens})
    h1, _ = model.forward(params, {"tokens": tokens})
    with use_rules(default_rules(tmesh.AbstractMesh((4, 1),
                                                    ("data", "model")))):
        h2, _ = model.forward(params, {"tokens": tokens})
    assert torch.equal(h1, h2)


