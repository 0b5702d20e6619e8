"""The published Zamba2 hybrid block (``zamba2-7b-instruct``) on the CPU at
smoke size, seeded random weights, float32:

(a) the port's ``models.serve.prefill`` logits, and prefill then
    ``decode_step`` at every decode position, equal the plain reference's
    (``mecbench/reference/zamba2-7b-instruct.py``) full forward;
(b) that reference equals transformers' ``Zamba2ForCausalLM``, built from
    a local ``Zamba2Config`` with the same weights;
(c) the port with a part of the block left out or changed (no LoRA, one
    shared block for every hybrid layer, the gated norm over all channels,
    one B/C group for every head) misses the reference by far more than
    the tolerance;
(d) the ``zamba2-7b`` arch builds the tree it built before the published
    block came in, and every arch of ``ARCHS`` counts the parameters it
    counted; ``zamba2-7b-instruct`` counts its published size.

Imports no jax.
"""
import importlib.util
import os
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.archs import (ARCHS, PUBLISHED,  # noqa: E402
                                       ZAMBA2_7B_INSTRUCT, smoke_config,
                                       zamba2_config)
from repro_torch.models import mamba2, serve  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.launch import costmodel  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

#: f32 through six layers: the port's chunked scan and streaming attention
#: sum in other orders than the reference's quadratic forms (observed
#: under 1e-6 of max|ref|); every ablation misses by more than 1e-2
TOL = 2e-5

#: irregular hybrid ids (gaps 3 and 1), both shared blocks, two groups
SMOKE = dict(
    ZAMBA2_7B_INSTRUCT, num_hidden_layers=6, hidden_size=64,
    hybrid_layer_ids=[1, 4, 5], num_attention_heads=4, num_key_value_heads=4,
    attention_head_dim=32, attention_hidden_size=128, intermediate_size=96,
    n_mamba_heads=8, mamba_headdim=16, mamba_d_state=8, mamba_ngroups=2,
    adapter_rank=8, vocab_size=256, chunk_size=8, max_position_embeddings=64)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _load("zamba2_reference",
            ROOT / "mecbench/reference/zamba2-7b-instruct.py")
DRIVER_PATH = ROOT / "mecbench/drivers/lm_serve.py"


def _cfg(**over):
    return zamba2_config(SMOKE, "smoke", dtype="float32", q_chunk=8,
                         kv_chunk=8, **over)


def _model(seed=0):
    """The port's model and weights, every norm's weight drawn around 1
    so that each norm matters."""
    cfg = _cfg()
    gen = torch.Generator().manual_seed(seed)
    params = LM(cfg).init(gen, device="cpu")
    for leaf in (params["final_norm"], params["mamba_norms"],
                 params["mamba"]["norm"], params["shared"]["norm1"],
                 params["shared"]["norm2"]):
        leaf.mul_(1 + 0.2 * torch.randn(leaf.shape, generator=gen))
    return cfg, params


def _weights(params, cfg):
    import sys
    sys.path.insert(0, str(ROOT))
    try:
        return _load("lm_serve_driver", DRIVER_PATH).reference_weights(
            params, cfg)
    finally:
        sys.path.remove(str(ROOT))


@pytest.fixture(scope="module")
def setup():
    cfg, params = _model()
    tokens = torch.randint(0, cfg.vocab, (2, 24),
                           generator=torch.Generator().manual_seed(1))
    ref = REF.logits(_weights(params, cfg), SMOKE, tokens)
    return cfg, params, tokens, ref


def _serve(cfg, params, tokens, prompt=16):
    """The port's logits at positions prompt - 1 .. S - 1: prefill, then
    a decode step a token."""
    model = LM(cfg)
    logits, cache = serve.prefill(model, params, {"tokens": tokens[:, :prompt]},
                                  tokens.shape[1])
    out = [logits]
    for i in range(prompt, tokens.shape[1]):
        logits, cache = serve.decode_step(model, params, cache,
                                          tokens[:, i:i + 1])
        out.append(logits)
    return torch.stack(out, dim=1)


def test_prefill_and_decode_equal_the_reference(setup):
    cfg, params, tokens, ref = setup
    got = _serve(cfg, params, tokens)
    assert REF.scaled_error(got[:, :1], ref[:, 15:16]) < TOL
    for i in range(1, got.shape[1]):
        assert REF.scaled_error(got[:, i:i + 1], ref[:, 15 + i:16 + i]) < TOL


def test_the_forward_equals_the_reference(setup):
    cfg, params, tokens, ref = setup
    h, _ = LM(cfg).forward(params, {"tokens": tokens})
    assert REF.scaled_error(h @ params["emb"].T, ref) < TOL


def _hf_model(params, cfg):
    """transformers' Zamba2ForCausalLM at the smoke sizes, the port's
    weights copied in.  Its torch path (the one without mamba_ssm) departs
    from the published kernels in two places, which the config steps
    around: it clamps dt below at time_step_min (time_step_limit null: the
    kernels do not), so time_step_min lies below every dt; and its
    hand-off of the state between chunks sums over the wrong chunk axis
    (4.57.6, ``modeling_zamba2.py:882``; Mamba2's and Bamba's torch paths
    transpose first), so its chunk (32) holds the whole sequence.  The
    port runs chunks of 8 against the reference."""
    os.environ.setdefault("USE_TF", "0")       # no TensorFlow import
    tf = pytest.importorskip("transformers")
    types = ["hybrid" if n in SMOKE["hybrid_layer_ids"] else "mamba"
             for n in range(SMOKE["num_hidden_layers"])]
    conf = tf.Zamba2Config(
        vocab_size=256, hidden_size=64, num_hidden_layers=6,
        layers_block_type=types, mamba_d_state=8, mamba_d_conv=4,
        mamba_expand=2, mamba_ngroups=2, n_mamba_heads=8,
        use_conv_bias=True, chunk_size=32, intermediate_size=96,
        hidden_act="gelu", num_attention_heads=4, num_key_value_heads=4,
        num_mem_blocks=2, use_shared_attention_adapter=False, adapter_rank=8,
        use_mem_rope=True, rope_theta=10000, rms_norm_eps=1e-5,
        time_step_min=1e-30, max_position_embeddings=64,
        tie_word_embeddings=True, attn_implementation="eager")
    torch.manual_seed(0)
    model = tf.Zamba2ForCausalLM(conf).eval()
    w = _weights(params, cfg)
    m = model.model
    ids = SMOKE["hybrid_layer_ids"]
    with torch.no_grad():
        m.embed_tokens.weight.copy_(w["embed"])
        m.final_layernorm.weight.copy_(w["final_norm"])
        for n, layer in enumerate(m.layers):
            dec = layer.mamba_decoder if n in ids else layer
            mix = dec.mamba
            dec.input_layernorm.weight.copy_(w[f"layers.{n}.norm"])
            mix.in_proj.weight.copy_(w[f"layers.{n}.in_proj"].T)
            mix.conv1d.weight.copy_(w[f"layers.{n}.conv_w"].T[:, None, :])
            mix.conv1d.bias.copy_(w[f"layers.{n}.conv_b"])
            mix.dt_bias.copy_(w[f"layers.{n}.dt_bias"])
            mix.A_log.copy_(w[f"layers.{n}.a_log"])
            mix.D.copy_(w[f"layers.{n}.d"])
            mix.norm.weight.copy_(w[f"layers.{n}.gated_norm"])
            mix.out_proj.weight.copy_(w[f"layers.{n}.out_proj"].T)
            if n not in ids:
                continue
            k = ids.index(n)
            b = f"blocks.{k % 2}."
            block = layer.shared_transformer
            assert block.block_id == k % 2
            layer.linear.weight.copy_(w[f"hybrid.{k}.linear"].T)
            block.input_layernorm.weight.copy_(w[b + "norm1"])
            for name in ("q", "k", "v", "o"):
                getattr(block.self_attn, f"{name}_proj").weight.copy_(
                    w[b + name].T)
            block.pre_ff_layernorm.weight.copy_(w[b + "norm2"])
            block.feed_forward.gate_up_proj.weight.copy_(w[b + "gate_up"].T)
            block.feed_forward.down_proj.weight.copy_(w[b + "down"].T)
            lora = block.feed_forward.gate_up_proj_adapter_list[k]
            lora[0].weight.copy_(w[f"hybrid.{k}.lora_a"].T)
            lora[1].weight.copy_(w[f"hybrid.{k}.lora_b"].T)
    assert model.lm_head.weight.data_ptr() == m.embed_tokens.weight.data_ptr()
    return model


def test_the_reference_equals_transformers(setup):
    cfg, params, tokens, ref = setup
    model = _hf_model(params, cfg)
    with torch.no_grad():
        hf = model(input_ids=tokens, use_cache=False).logits
    assert REF.scaled_error(hf, ref) < TOL


def _whole_norm(cfg, y, z, w, tp):
    return mamba2.tensor.rms_norm(y * torch.nn.functional.silu(z), w,
                                  cfg.norm_eps, tp)


def _group_zero(orig):
    def bc(cfg, xbc, d_in, n):
        b, c = orig(cfg, xbc, d_in, n)
        return b[..., :1, :].expand_as(b), c[..., :1, :].expand_as(c)
    return bc


@pytest.mark.parametrize("fault", ["no LoRA", "one shared block",
                                   "norm over all channels",
                                   "one B/C group"])
def test_a_block_missing_a_part_misses_the_reference(setup, fault,
                                                     monkeypatch):
    cfg, params, tokens, ref = setup
    if fault == "no LoRA":
        params = dict(params, hybrid={"linear": params["hybrid"]["linear"]})
    elif fault == "one shared block":
        params = dict(params, shared={k: v for k, v in params["shared"].items()})
        cfg = cfg.with_(n_mem_blocks=1)
    elif fault == "norm over all channels":
        monkeypatch.setattr(mamba2, "_gated_norm", _whole_norm)
    else:
        monkeypatch.setattr(mamba2, "_bc", _group_zero(mamba2._bc))
    got = _serve(cfg, params, tokens)
    assert REF.scaled_error(got, ref[:, 15:]) > 1e-2


def test_zamba2_7b_builds_its_tree_as_before():
    cfg = smoke_config("zamba2-7b")
    params = LM(cfg).init(torch.Generator().manual_seed(0), device="cpu")

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(leaves(v, f"{prefix}/{k}"))
            return out
        return {prefix: tuple(tree.shape)}
    m = {"in_proj/w": (64, 288), "conv_w": (4, 144), "a_log": (16,),
         "d_skip": (16,), "dt_bias": (16,), "norm": (128,),
         "out_proj/w": (128, 64)}
    want = {"/emb": (256, 64), "/final_norm": (64,), "/lm_head/w": (64, 256),
            "/shared/norm1": (64,), "/shared/attn/wq/w": (64, 64),
            "/shared/attn/wk/w": (64, 64), "/shared/attn/wv/w": (64, 64),
            "/shared/attn/wo/w": (64, 64), "/shared/norm2": (64,),
            "/shared/mlp/gate/w": (64, 96), "/shared/mlp/up/w": (64, 96),
            "/shared/mlp/down/w": (96, 64), "/mamba_norms": (5, 64)}
    want.update({f"/mamba/{k}": (2, 2) + v for k, v in m.items()})
    want.update({f"/mamba_tail/{k}": (1,) + v for k, v in m.items()})
    assert leaves(params) == want
    assert list(leaves(params)) == ["/emb", "/final_norm", "/lm_head/w"] + [
        f"/mamba/{k}" for k in m] + [f"/mamba_tail/{k}" for k in m] + [
        k for k in want if k.startswith("/shared")] + ["/mamba_norms"]


#: the counts of the ten archs before the published block came in
COUNTS = {"qwen3-4b": 4022272000, "phi3-medium-14b": 14659092480,
          "command-r-35b": 30282874880, "yi-6b": 6060769280,
          "zamba2-7b": 6749630976, "qwen3-moe-30b-a3b": 30531911680,
          "kimi-k2-1t-a32b": 1043852558336, "llava-next-34b": 34388049920,
          "xlstm-125m": 204668928, "whisper-tiny": 61065984}


def test_parameter_counts():
    assert {a: c.param_count() for a, c in ARCHS.items()} == COUNTS
    cfg = PUBLISHED["zamba2-7b-instruct"]
    # 81 Mamba2 layers of 78.4 M, 2 shared blocks of 334.2 M, 13 LoRAs of
    # 4.1 M and linears of 12.8 M, the embedding of 114.7 M once (tied);
    # 7.47 B with the head counted apart
    assert 7.35e9 < cfg.param_count() < 7.36e9
    assert 7.4e9 < cfg.with_(tie_embeddings=False).param_count() < 7.6e9
    assert cfg.shared_apps == 13 and cfg.head_dim == 224


def test_the_cost_model_counts_the_published_block():
    """A prefill's forward operations: each Mamba2 layer's projections,
    conv and scan, and at each of the 13 hybrid layers the shared block
    over the 7168-wide input, its LoRA and the layer's linear; the scan's
    quadratic term over chunks of 256."""
    cfg = PUBLISHED["zamba2-7b-instruct"]
    b, s = 2, 1024
    d, d_in, g, n, h = 3584, 7168, 2, 64, 112
    proj = 2 * b * s * d * (2 * d_in + 2 * g * n + h) + 2 * b * s * d_in * d
    conv = 2 * b * s * 4 * (d_in + 2 * g * n)
    ssd = (2 * b * s * 256 * g * n + 2 * b * s * 256 * h * 64
           + 4 * b * s * h * 64 * n)
    attn = (2 * b * s * 7168 * 224 * 96 + 2 * b * s * 7168 * d
            + 4 * b * 32 * s * s * 224)
    app = (attn + 3 * 2 * b * s * d * 14336
           + 2 * b * s * 128 * (d + 2 * 14336) + 2 * b * s * d * d)
    want = 81 * (proj + conv + ssd) + 13 * app
    assert costmodel.flops_fwd(cfg, b, s) == pytest.approx(want, rel=1e-12)
    dec = costmodel.decode_cost(cfg, 32, 256, costmodel.MeshShape(1, 1, 1))
    assert dec["model_flops"] == 2 * cfg.param_count(True) * 32
    assert dec["flops"] == (2 * cfg.param_count(True) * 32
                            + 2 * 13 * 32 * 32 * 256 * 224 * 2)
    old = ARCHS["zamba2-7b"]
    assert costmodel.flops_fwd(old, 2, 1024) == 37811099009024.0
    assert costmodel.decode_cost(old, 32, 256, costmodel.MeshShape(
        1, 1, 1))["hbm_bytes_chip"] == 15025988608.0
