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
``mec_fused2``  CUDA kernel K4: K1 h-blocked, oh_blk output rows per CTA
``auto``        ``launch.costmodel.pick_conv2d_algorithm`` on the
                tensors' device type: ``mec_fused`` on CUDA
=============== ===========================================================

``fft`` and ``winograd`` and the ``plan=`` and ``partition=`` arguments
are not ported yet and raise ``NotImplementedError`` naming their ROADMAP
item.  ``conv2d`` runs where its inputs live: CUDA tensors go through the
kernels, CPU tensors through the kernels' plain versions.

The MEC algorithms run inside one ``torch.autograd.Function``, the port
of the JAX package's MEC custom VJP; its backward is the same for every
MEC algorithm:

* input gradient = a transposed MEC conv: the cotangent, stride-dilated
  and fully padded, is MEC-convolved (``core.mec.mec_conv2d``) with the
  spatially flipped, channel-swapped kernel;
* weight gradient from the compact L (``core.mec.mec_lower``): one
  contraction per kernel row over the stride-s_h view of L.

Both run in f32 and are cast back to the operand dtypes.  The backward
is plain PyTorch (``torch.matmul``), as the JAX package's is plain jnp:
it has no Pallas backward kernel.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from repro_torch.core.convspec import (ConvSpec, normalize_stride, pad_nhwc,
                                       pad_same, padding_amounts, spec_of)
from repro_torch.core.direct import direct_conv2d
from repro_torch.core.im2col import im2col_conv2d
from repro_torch.core.mec import mec_conv2d as _mec_reference, mec_lower
from repro_torch.launch.costmodel import pick_conv2d_algorithm

MEC_ALGORITHMS = ("mec", "mec_lowered", "mec_fused", "mec_fused2")
ALGORITHMS = ("auto", "direct", "im2col", "fft", "winograd") + MEC_ALGORITHMS

# Algorithms of ALGORITHMS the port does not run yet -> their ROADMAP item.
_NOT_PORTED = {
    "fft": "ROADMAP Queue 1 item 5",
    "winograd": "ROADMAP Queue 1 item 5",
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


def _mec_input_grad(g: torch.Tensor, kernel: torch.Tensor, s_h: int,
                    s_w: int, i_h: int, i_w: int) -> torch.Tensor:
    """dL/dI as a transposed MEC conv: stride-dilate the cotangent, pad it
    fully, and MEC-convolve with the spatially flipped kernel whose
    channel axes are swapped (HWIO -> HWOI)."""
    k_h, k_w = kernel.shape[:2]
    g32 = g.to(torch.float32)
    i_n, o_h, o_w, k_c = g.shape
    if s_h > 1 or s_w > 1:
        gd = g32.new_zeros((i_n, (o_h - 1) * s_h + 1, (o_w - 1) * s_w + 1,
                            k_c))
        gd[:, ::s_h, ::s_w, :] = g32
    else:
        gd = g32
    gp = pad_nhwc(gd, (k_h - 1, k_h - 1), (k_w - 1, k_w - 1))
    k_t = kernel.flip(0, 1).permute(0, 1, 3, 2).to(torch.float32)
    di = _mec_reference(gp, k_t, (1, 1))   # (n, (o_h-1)s_h + k_h, ..., i_c)
    # Input rows/cols beyond the last kernel window receive zero gradient.
    return pad_nhwc(di, (0, i_h - di.shape[1]), (0, i_w - di.shape[2]))


def _mec_weight_grad(inp: torch.Tensor, g: torch.Tensor, s_h: int, s_w: int,
                     k_h: int, k_w: int) -> torch.Tensor:
    """dL/dK from the compact L (Eq. 3): for each kernel row r, the
    stride-s_h view of L against the cotangent, the k_h-decomposition of
    the forward kernels run in reverse."""
    low = mec_lower(inp, k_w, s_w).to(torch.float32)  # (n, o_w, i_h, k_w, i_c)
    o_h = g.shape[1]
    g32 = g.to(torch.float32)
    rows = []
    for r in range(k_h):
        lr = low[:, :, r:r + s_h * (o_h - 1) + 1:s_h]  # (n, o_w, o_h, k_w, i_c)
        rows.append(torch.einsum("nwhjc,nhwo->jco", lr, g32))
    return torch.stack(rows)               # (k_h, k_w, i_c, k_c)


class _MecConv(torch.autograd.Function):
    """Every MEC path behind one autograd node: the forward runs the
    chosen algorithm, the backward is the shared MEC VJP."""

    @staticmethod
    def forward(ctx, inp, kernel, s_h, s_w, variant, solution):
        ctx.save_for_backward(inp, kernel)
        ctx.strides = (s_h, s_w)
        return _mec_forward(inp, kernel, s_h, s_w, variant, solution)

    @staticmethod
    def backward(ctx, grad_out):
        # variant and solution shape the forward only: the VJP math is the
        # same for every MEC execution path.
        inp, kernel = ctx.saved_tensors
        s_h, s_w = ctx.strides
        d_inp = d_ker = None
        if ctx.needs_input_grad[0]:
            d_inp = _mec_input_grad(grad_out, kernel, s_h, s_w, inp.shape[1],
                                    inp.shape[2]).to(inp.dtype)
        if ctx.needs_input_grad[1]:
            d_ker = _mec_weight_grad(inp, grad_out, s_h, s_w, kernel.shape[0],
                                     kernel.shape[1]).to(kernel.dtype)
        return d_inp, d_ker, None, None, None, None


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
