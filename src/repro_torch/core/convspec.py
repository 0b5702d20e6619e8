"""Shared convolution geometry helpers (paper Table 1 / Eq. 1).

PyTorch counterpart of ``repro.core.convspec``; the geometry is pure
arithmetic and is copied, not imported, so the port never loads jax.

All tensors are NHWC (the paper's n-h-w-c) and kernels are HWIO
(k_h, k_w, i_c, k_c).  Padding is assumed to have been applied to the
input already (paper §2.1); helpers to apply SAME/VALID padding live here
so every algorithm sees an identical pre-padded input.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """Geometry of one 2-D convolution, pre-padding (paper Eq. 1)."""

    i_n: int
    i_h: int
    i_w: int
    i_c: int
    k_h: int
    k_w: int
    k_c: int
    s_h: int = 1
    s_w: int = 1

    @property
    def o_h(self) -> int:
        return (self.i_h - self.k_h) // self.s_h + 1

    @property
    def o_w(self) -> int:
        return (self.i_w - self.k_w) // self.s_w + 1

    @property
    def out_shape(self) -> Tuple[int, int, int, int]:
        return (self.i_n, self.o_h, self.o_w, self.k_c)

    def validate(self) -> None:
        if self.i_h < self.k_h or self.i_w < self.k_w:
            raise ValueError(f"kernel larger than input: {self}")
        if min(self.s_h, self.s_w) < 1:
            raise ValueError(f"strides must be >= 1: {self}")


def normalize_stride(stride) -> Tuple[int, int]:
    """Canonical ``(s_h, s_w)`` from an int or a 2-sequence."""
    s_h, s_w = (stride, stride) if isinstance(stride, int) else tuple(stride)
    if min(s_h, s_w) < 1:
        raise ValueError(f"strides must be >= 1, got {(s_h, s_w)}")
    return s_h, s_w


def padding_amounts(i_h: int, i_w: int, k_h: int, k_w: int,
                    s_h: int, s_w: int, padding) -> Tuple[int, int]:
    """Total (rows, cols) ``conv_api.apply_padding`` would add, as pure
    arithmetic, so analytic models can size post-padding geometry."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return 0, 0
        if mode == "SAME":
            o_h, o_w = -(-i_h // s_h), -(-i_w // s_w)
            return (max((o_h - 1) * s_h + k_h - i_h, 0),
                    max((o_w - 1) * s_w + k_w - i_w, 0))
        raise ValueError(f"unknown padding {padding!r}")
    if isinstance(padding, int):
        padding = ((padding, padding), (padding, padding))
    p_h, p_w = padding
    if isinstance(p_h, int):
        p_h = (p_h, p_h)
    if isinstance(p_w, int):
        p_w = (p_w, p_w)
    if min(tuple(p_h) + tuple(p_w)) < 0:
        raise ValueError(f"padding must be non-negative, got {(p_h, p_w)}")
    return sum(p_h), sum(p_w)


def padded_spec(s: ConvSpec, padding) -> ConvSpec:
    """The post-padding ConvSpec of a pre-padding geometry + padding mode.
    VALID is the identity."""
    pad_h, pad_w = padding_amounts(s.i_h, s.i_w, s.k_h, s.k_w,
                                   s.s_h, s.s_w, padding)
    if pad_h == 0 and pad_w == 0:
        return s
    return dataclasses.replace(s, i_h=s.i_h + pad_h, i_w=s.i_w + pad_w)


def spec_of(inp: torch.Tensor, kernel: torch.Tensor, stride) -> ConvSpec:
    s_h, s_w = normalize_stride(stride)
    i_n, i_h, i_w, i_c = inp.shape
    k_h, k_w, kic, k_c = kernel.shape
    if kic != i_c:
        raise ValueError(f"channel mismatch: input {i_c} kernel {kic}")
    spec = ConvSpec(i_n, i_h, i_w, i_c, k_h, k_w, k_c, s_h, s_w)
    spec.validate()
    return spec


def pad_nhwc(inp: torch.Tensor, p_h: Tuple[int, int],
             p_w: Tuple[int, int]) -> torch.Tensor:
    """Zero-pad the H and W axes of an NHWC tensor by (lo, hi) each."""
    # F.pad lists pads from the last axis backwards: C, W, H.
    return F.pad(inp, (0, 0, p_w[0], p_w[1], p_h[0], p_h[1]))


def pad_same(inp: torch.Tensor, k_h: int, k_w: int, s_h: int = 1,
             s_w: int = 1) -> torch.Tensor:
    """Explicit SAME padding (the paper assumes pre-padded input); an odd
    pad row or column goes to the high end, as in the JAX package."""
    _, i_h, i_w, _ = inp.shape
    o_h = -(-i_h // s_h)
    o_w = -(-i_w // s_w)
    pad_h = max((o_h - 1) * s_h + k_h - i_h, 0)
    pad_w = max((o_w - 1) * s_w + k_w - i_w, 0)
    return pad_nhwc(inp, (pad_h // 2, pad_h - pad_h // 2),
                    (pad_w // 2, pad_w - pad_w // 2))
