"""The 2-D convolution front-end, NHWC x HWIO -> NHWC (counterpart of
``repro.core.conv_api``).

Every conv call site of the port goes through ``conv2d``.  It owns
padding (SAME/VALID/explicit), validates geometry through
:class:`~repro_torch.core.convspec.ConvSpec`, and dispatches to one of
the algorithm back-ends:

=============== ===========================================================
``direct``      ``F.conv2d`` in f32 (numerical oracle)
``im2col``      full Toeplitz lowering + one GEMM (paper Eq. 2 baseline)
``mec``         paper Algorithm 2 in eager torch (Solutions A/B)
``mec_lowered`` CUDA kernels K2 + K3: L materialized in device memory
``mec_fused``   CUDA kernel K1: lowering fused into the GEMM, no L
``auto``        ``launch.costmodel.pick_conv2d_algorithm`` on the
                tensors' device type: ``mec_fused`` on CUDA
=============== ===========================================================

``fft``, ``winograd`` and ``mec_fused2`` and the ``plan=`` and
``partition=`` arguments are not ported yet and raise
``NotImplementedError`` naming their ROADMAP item.  ``conv2d`` runs where
its inputs live: CUDA tensors go through the kernels, CPU tensors
through the kernels' plain versions.

The MEC algorithms run inside one ``torch.autograd.Function``.  Its
backward (the JAX package's MEC custom VJP) is not ported yet and raises,
so a gradient is never silently missing.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from repro_torch.core.convspec import (ConvSpec, normalize_stride, pad_nhwc,
                                       pad_same, padding_amounts, spec_of)
from repro_torch.core.direct import direct_conv2d
from repro_torch.core.im2col import im2col_conv2d
from repro_torch.core.mec import mec_conv2d as _mec_reference
from repro_torch.launch.costmodel import pick_conv2d_algorithm

MEC_ALGORITHMS = ("mec", "mec_lowered", "mec_fused", "mec_fused2")
ALGORITHMS = ("auto", "direct", "im2col", "fft", "winograd") + MEC_ALGORITHMS

# Algorithms of ALGORITHMS the port does not run yet -> their ROADMAP item.
_NOT_PORTED = {
    "fft": "ROADMAP Queue 1 item 5",
    "winograd": "ROADMAP Queue 1 item 5",
    "mec_fused2": "ROADMAP Queue 2 K4",
}

Padding = Union[str, int, Tuple]


def apply_padding(inp: torch.Tensor, k_h: int, k_w: int, s_h: int, s_w: int,
                  padding: Padding) -> torch.Tensor:
    """SAME / VALID / explicit padding, applied once so every algorithm
    sees an identical pre-padded input (paper §2.1).  Negative explicit
    pads are rejected."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return inp
        if mode == "SAME":
            return pad_same(inp, k_h, k_w, s_h, s_w)
        raise ValueError(f"unknown padding {padding!r}")
    if isinstance(padding, int):
        padding = ((padding, padding), (padding, padding))
    p_h, p_w = padding
    if isinstance(p_h, int):
        p_h = (p_h, p_h)
    if isinstance(p_w, int):
        p_w = (p_w, p_w)
    p_h, p_w = tuple(p_h), tuple(p_w)
    if min(p_h + p_w) < 0:
        raise ValueError(
            f"padding must be non-negative, got {(p_h, p_w)}; negative "
            "pads (cropping) are not a convolution padding")
    return pad_nhwc(inp, p_h, p_w)


def _mec_forward(inp, kernel, s_h, s_w, variant, solution):
    if variant == "mec":
        return _mec_reference(inp, kernel, (s_h, s_w), solution=solution)
    # Lazy import: the kernels import core modules, and core/__init__
    # imports this module.
    from repro_torch.kernels.ops import mec_conv2d_cuda
    return mec_conv2d_cuda(inp, kernel, (s_h, s_w), mode=variant[len("mec_"):])


class _MecConv(torch.autograd.Function):
    """Every MEC path behind one autograd node; forward only so far."""

    @staticmethod
    def forward(ctx, inp, kernel, s_h, s_w, variant, solution):
        return _mec_forward(inp, kernel, s_h, s_w, variant, solution)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError("MEC VJP: ROADMAP Queue 1 item 8")


def resolve_algorithm(spec: ConvSpec, device: Union[str, torch.device]) -> str:
    """What ``conv2d(algorithm="auto")`` runs for ``spec`` on ``device``."""
    return pick_conv2d_algorithm(spec, backend=torch.device(device).type)


def _dispatch(x: torch.Tensor, kernel: torch.Tensor, s_h: int, s_w: int,
              algorithm: str, solution: str) -> torch.Tensor:
    """Execution of a *resolved* algorithm on the pre-padded input."""
    if algorithm in _NOT_PORTED:
        raise NotImplementedError(
            f"algorithm={algorithm!r} is not ported yet: "
            f"{_NOT_PORTED[algorithm]}")
    if algorithm == "direct":
        return direct_conv2d(x, kernel, (s_h, s_w))
    if algorithm == "im2col":
        return im2col_conv2d(x, kernel, (s_h, s_w))
    return _MecConv.apply(x, kernel, s_h, s_w, algorithm, solution)


def conv2d(inp: torch.Tensor, kernel: torch.Tensor, *, stride=1,
           padding: Padding = "VALID", algorithm: str = "auto",
           solution: str = "auto", partition=None,
           plan=None) -> torch.Tensor:
    """2-D convolution, NHWC x HWIO -> NHWC.

    inp: (i_n, i_h, i_w, i_c); kernel: (k_h, k_w, i_c, k_c), on one
    device.  stride: int or (s_h, s_w).  padding: 'SAME' | 'VALID' | int |
    ((lo, hi), (lo, hi)).  algorithm: one of :data:`ALGORITHMS`.
    solution: MEC Solution 'A' | 'B' | 'auto' (``mec`` only).
    partition: only None or 'none' (single device) so far; plan: only
    None so far.
    """
    if plan is not None:
        raise NotImplementedError(
            "conv2d(plan=...): the ConvPlan planner is not ported yet: "
            "ROADMAP Queue 1 item 6")
    if partition not in (None, "none"):
        raise NotImplementedError(
            f"conv2d(partition={partition!r}): distributed execution is "
            "not ported yet: ROADMAP Queue 1 item 11")
    if inp.device != kernel.device:
        raise ValueError(f"input on {inp.device} but kernel on "
                         f"{kernel.device}")
    algorithm = algorithm.lower()
    if algorithm not in ALGORITHMS:
        raise ValueError(
            f"unknown algorithm {algorithm!r}; expected one of {ALGORITHMS}")

    s_h, s_w = normalize_stride(stride)
    k_h, k_w = kernel.shape[0], kernel.shape[1]
    x = apply_padding(inp, k_h, k_w, s_h, s_w, padding)
    spec = spec_of(x, kernel, (s_h, s_w))
    if algorithm == "auto":
        algorithm = resolve_algorithm(spec, x.device)
    return _dispatch(x, kernel, s_h, s_w, algorithm, solution)


def conv2d_spec(inp: torch.Tensor, kernel: torch.Tensor, *, stride=1,
                padding: Padding = "VALID") -> ConvSpec:
    """The post-padding ConvSpec ``conv2d`` would dispatch on (for cost
    and memory accounting without running the conv)."""
    s_h, s_w = normalize_stride(stride)
    i_n, i_h, i_w, i_c = inp.shape
    k_h, k_w, _, k_c = kernel.shape
    pad_h, pad_w = padding_amounts(i_h, i_w, k_h, k_w, s_h, s_w, padding)
    return ConvSpec(i_n, i_h + pad_h, i_w + pad_w, i_c, k_h, k_w, k_c,
                    s_h, s_w)
