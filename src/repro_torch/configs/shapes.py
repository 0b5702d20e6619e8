"""Assigned input-shape cells and their input specs (counterpart of
``repro.configs.shapes``).

LM shapes: train_4k / prefill_32k feed ``train_step`` / ``prefill``;
decode_32k / long_500k feed one decode step (one token against a
seq_len cache).  long_500k runs only for the archs whose decode state
does not grow with the sequence (zamba2-7b, xlstm-125m).

A spec is a :class:`Spec` (shape, torch dtype), the port's stand-in for
``jax.ShapeDtypeStruct``.  Decode specs come from
``models.serve.init_decode_cache`` on the ``meta`` device, so nothing is
allocated.  :func:`make_batch` builds a concrete batch on an explicit
device from a seeded ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.models import serve
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import LM, torch_dtype, tree_map


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


@dataclasses.dataclass(frozen=True)
class Spec:
    """An input's shape and dtype."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}

# archs with O(1)/sub-quadratic decode state — the only ones that run long_500k
LONG_CONTEXT_ARCHS = ("zamba2-7b", "xlstm-125m")


def cell_applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True


def smoke_shape(cell: ShapeCell) -> ShapeCell:
    return dataclasses.replace(cell, seq_len=32, global_batch=2)


def train_input_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict:
    b, s = cell.global_batch, cell.seq_len
    dt = torch_dtype(cfg)
    if cfg.family == "vlm":
        s_text = s - cfg.prefix_len
        return {"tokens": Spec((b, s_text), torch.int32),
                "labels": Spec((b, s_text), torch.int32),
                "vision": Spec((b, cfg.prefix_len, cfg.d_model), dt)}
    if cfg.family == "audio":
        return {"tokens": Spec((b, s), torch.int32),
                "labels": Spec((b, s), torch.int32),
                "frames": Spec((b, cfg.encoder_len, cfg.d_model), dt)}
    return {"tokens": Spec((b, s), torch.int32),
            "labels": Spec((b, s), torch.int32)}


def prefill_input_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict:
    spec = train_input_specs(cfg, cell)
    spec.pop("labels")
    return spec


def decode_input_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict:
    """Decode: one new token against a seq_len cache."""
    cache = serve.init_decode_cache(LM(cfg), cell.global_batch, cell.seq_len,
                                    device="meta")
    return {"cache": tree_map(lambda t: Spec(tuple(t.shape), t.dtype), cache),
            "tokens": Spec((cell.global_batch, 1), torch.int32)}


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict:
    if cell.kind == "train":
        return train_input_specs(cfg, cell)
    if cell.kind == "prefill":
        return prefill_input_specs(cfg, cell)
    return decode_input_specs(cfg, cell)


def make_batch(cfg: ModelConfig, cell: ShapeCell, seed: int = 0,
               device="cuda") -> Dict:
    """A concrete synthetic batch matching :func:`input_specs`, on
    ``device``: a zero decode cache and (B, 1) token ids for a decode cell;
    otherwise token ids and labels uniform in [0, max(2, vocab - 1)) and
    zero float entries.  Ids come from a generator on ``device`` seeded
    with ``seed``, drawn in the specs' order."""
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    if cell.kind == "decode":
        cache = serve.init_decode_cache(LM(cfg), cell.global_batch,
                                        cell.seq_len, device=device)
        tokens = torch.randint(0, cfg.vocab, (cell.global_batch, 1),
                               generator=generator, device=device,
                               dtype=torch.int32)
        return {"cache": cache, "tokens": tokens}

    def gen(spec: Spec) -> torch.Tensor:
        if not spec.dtype.is_floating_point:
            return torch.randint(0, max(2, cfg.vocab - 1), spec.shape,
                                 generator=generator, device=device,
                                 dtype=spec.dtype)
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)

    return {name: gen(spec) for name, spec in input_specs(cfg, cell).items()}
