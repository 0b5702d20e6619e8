"""The port's input-shape cells (``repro_torch.configs.shapes``) against
``repro.configs.shapes``, on the CPU.

The cells, the long-context archs and ``cell_applicable`` are copies; every
family's input specs at full size have the JAX package's shapes and
dtypes (its decode specs from ``jax.eval_shape``, the port's from the
``meta`` device, so neither allocates); ``make_batch`` at ``smoke_shape``
builds what the specs say and the models take it.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                           # noqa: E402

from repro.configs import archs as jarchs            # noqa: E402
from repro.configs import shapes as jshapes          # noqa: E402

from repro_torch.configs import archs as tarchs      # noqa: E402
from repro_torch.configs import shapes as tshapes    # noqa: E402
from repro_torch.models import lm as tlm             # noqa: E402
from repro_torch.models import serve as tserve       # noqa: E402

PORTED = sorted(tarchs.ARCHS)
# one arch of each family, for the batches at smoke size
FAMILY_ARCHS = ["qwen3-4b", "llava-next-34b", "zamba2-7b", "xlstm-125m",
                "whisper-tiny", "qwen3-moe-30b-a3b"]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _dtype_name(dt) -> str:
    return str(dt).split(".")[-1]


def _cells(arch):
    return [name for name in jshapes.SHAPES
            if jshapes.cell_applicable(arch, name)]


def test_cells_are_copies_of_the_jax_package():
    assert sorted(tshapes.SHAPES) == sorted(jshapes.SHAPES)
    for name, cell in jshapes.SHAPES.items():
        assert dataclasses.asdict(tshapes.SHAPES[name]) == dataclasses.asdict(cell)
        assert (dataclasses.asdict(tshapes.smoke_shape(tshapes.SHAPES[name]))
                == dataclasses.asdict(jshapes.smoke_shape(cell)))
    assert tshapes.LONG_CONTEXT_ARCHS == jshapes.LONG_CONTEXT_ARCHS


@pytest.mark.parametrize("arch", sorted(jarchs.ARCHS))
def test_cell_applicable_equals_the_jax_package(arch):
    for shape in jshapes.SHAPES:
        assert (tshapes.cell_applicable(arch, shape)
                == jshapes.cell_applicable(arch, shape))


@pytest.mark.parametrize("arch", PORTED)
def test_input_specs_match_the_jax_package_at_full_size(arch):
    """Every applicable cell: the same entries, shapes and dtypes (decode:
    every cache leaf), nothing allocated on either side."""
    jcfg, tcfg = jarchs.ARCHS[arch], tarchs.ARCHS[arch]
    for name in _cells(arch):
        j = _leaves(jshapes.input_specs(jcfg, jshapes.SHAPES[name]))
        t = _leaves(tshapes.input_specs(tcfg, tshapes.SHAPES[name]))
        assert sorted(j) == sorted(t), name
        for leaf, sds in j.items():
            if sds is None:
                assert t[leaf] is None, (name, leaf)
                continue
            assert isinstance(t[leaf], tshapes.Spec)
            assert t[leaf].shape == tuple(sds.shape), (name, leaf)
            assert _dtype_name(t[leaf].dtype) == str(sds.dtype), (name, leaf)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_make_batch_at_smoke_shape(arch):
    """make_batch(smoke_config, smoke_shape(cell)) for every applicable
    cell: the JAX package's entries, shapes and dtypes, token ids in
    range, float entries and caches zero; the decode batch goes through
    one ``decode_step``, a prefill batch through ``prefill``."""
    jcfg, tcfg = jarchs.smoke_config(arch), tarchs.smoke_config(arch)
    model = tlm.LM(tcfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    for name in _cells(arch):
        cell = tshapes.smoke_shape(tshapes.SHAPES[name])
        j = _leaves(jax.device_get(jshapes.make_batch(
            jcfg, jshapes.smoke_shape(jshapes.SHAPES[name]))))
        batch = tshapes.make_batch(tcfg, cell, seed=1, device="cpu")
        t = _leaves(batch)
        assert sorted(j) == sorted(t), name
        for leaf, arr in j.items():
            if arr is None:
                assert t[leaf] is None
                continue
            assert tuple(t[leaf].shape) == np.shape(arr), (name, leaf)
            assert _dtype_name(t[leaf].dtype) == str(arr.dtype), (name, leaf)
            if t[leaf].dtype.is_floating_point:
                assert float(t[leaf].abs().sum()) == 0, (name, leaf)
            elif leaf != "/cache/len":
                assert 0 <= int(t[leaf].min()) and int(t[leaf].max()) < tcfg.vocab
        if cell.kind == "decode":
            assert int(batch["cache"]["len"]) == cell.seq_len - 1
            logits, _ = tserve.decode_step(model, params, batch["cache"],
                                           batch["tokens"])
            assert tuple(logits.shape) == (cell.global_batch, tcfg.vocab)
        elif cell.kind == "prefill":
            logits, _ = tserve.prefill(model, params, batch, cell.seq_len + 1)
            assert bool(torch.isfinite(logits).all())


def test_make_batch_is_seeded():
    cfg = tarchs.smoke_config("qwen3-4b")
    cell = tshapes.smoke_shape(tshapes.SHAPES["train_4k"])
    a, b, c = (tshapes.make_batch(cfg, cell, seed=s, device="cpu")
               for s in (3, 3, 4))
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])


def test_long_500k_decode_state_is_length_free():
    """xlstm-125m's long_500k batch: batch 1, the cache at position
    524287, its state as large as at 64 positions."""
    cfg = tarchs.ARCHS["xlstm-125m"]
    batch = tshapes.make_batch(cfg, tshapes.SHAPES["long_500k"], device="cpu")
    assert tuple(batch["tokens"].shape) == (1, 1)
    assert int(batch["cache"]["len"]) == 524287
    short = tserve.init_decode_cache(tlm.LM(cfg), 1, 64, device="cpu")
    size = {n: t.numel() for n, t in _leaves(batch["cache"]).items()}
    assert size == {n: t.numel() for n, t in _leaves(short).items()}
