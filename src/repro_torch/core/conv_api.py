"""The 2-D convolution front-end, NHWC x HWIO -> NHWC (counterpart of
``repro.core.conv_api``).

Every conv call site of the port goes through ``conv2d``.  It owns
padding (SAME/VALID/explicit), validates geometry through
:class:`~repro_torch.core.convspec.ConvSpec`, and dispatches to one of
the algorithm back-ends:

=============== ===========================================================
``direct``      ``F.conv2d`` in f32 (numerical oracle)
``im2col``      full Toeplitz lowering + one GEMM (paper Eq. 2 baseline)
``fft``         frequency domain in complex64 (paper §2.2 FFT baseline)
``winograd``    F(2x2, 3x3); requires a 3x3 kernel and stride 1
``mec``         paper Algorithm 2 in eager torch (Solutions A/B)
``mec_lowered`` CUDA kernels K2 + K3: L materialized in device memory
``mec_fused``   CUDA kernel K1: lowering fused into the GEMM, no L
``mec_fused2``  CUDA kernel K4: K1 h-blocked, oh_blk output rows per CTA
``auto``        the cached :class:`repro_torch.plan.ConvPlan` for the
                tensors' device type (analytic on a miss: ``mec_fused``
                on CUDA)
=============== ===========================================================

``conv2d(..., plan=)`` executes exactly the decision a
:class:`repro_torch.plan.ConvPlan` holds: the plan's algorithm, solution
and kernel ``w_blk`` win over the kwargs, and the call's geometry, dtype
and device must reproduce the plan's.  ``partition=`` other than None or
'none' raises ``NotImplementedError`` naming its ROADMAP item.
``conv2d`` runs where its inputs live: CUDA tensors go through the
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

from typing import TYPE_CHECKING, Optional, Tuple, Union

import torch

from repro_torch.core.convspec import (ConvSpec, normalize_stride, pad_nhwc,
                                       pad_same, padding_amounts, spec_of)
from repro_torch.core.direct import direct_conv2d
from repro_torch.core.fft_conv import fft_conv2d
from repro_torch.core.im2col import im2col_conv2d
from repro_torch.core.mec import mec_conv2d as _mec_reference, mec_lower
from repro_torch.core.winograd import winograd_conv2d
from repro_torch.launch.costmodel import pick_conv2d_algorithm

if TYPE_CHECKING:  # repro_torch.plan imports core; the cycle is lazy
    from repro_torch.plan import ConvPlan

MEC_ALGORITHMS = ("mec", "mec_lowered", "mec_fused", "mec_fused2")
ALGORITHMS = ("auto", "direct", "im2col", "fft", "winograd") + MEC_ALGORITHMS

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


def _mec_forward(inp, kernel, s_h, s_w, variant, solution, w_blk):
    if variant == "mec":
        return _mec_reference(inp, kernel, (s_h, s_w), solution=solution)
    # Lazy import: the kernels import core modules, and core/__init__
    # imports this module.
    from repro_torch.kernels.ops import mec_conv2d_cuda
    return mec_conv2d_cuda(inp, kernel, (s_h, s_w), mode=variant[len("mec_"):],
                           w_blk=w_blk)


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
    def forward(ctx, inp, kernel, s_h, s_w, variant, solution, w_blk):
        ctx.save_for_backward(inp, kernel)
        ctx.strides = (s_h, s_w)
        return _mec_forward(inp, kernel, s_h, s_w, variant, solution, w_blk)

    @staticmethod
    def backward(ctx, grad_out):
        # variant, solution and w_blk shape the forward only: the VJP math
        # is the same for every MEC execution path.
        inp, kernel = ctx.saved_tensors
        s_h, s_w = ctx.strides
        d_inp = d_ker = None
        if ctx.needs_input_grad[0]:
            d_inp = _mec_input_grad(grad_out, kernel, s_h, s_w, inp.shape[1],
                                    inp.shape[2]).to(inp.dtype)
        if ctx.needs_input_grad[1]:
            d_ker = _mec_weight_grad(inp, grad_out, s_h, s_w, kernel.shape[0],
                                     kernel.shape[1]).to(kernel.dtype)
        return d_inp, d_ker, None, None, None, None, None


def resolve_algorithm(spec: ConvSpec, device: Union[str, torch.device]) -> str:
    """The analytic pick for ``spec`` on ``device`` (the costmodel rule
    that ``conv2d(algorithm="auto")`` plans with on a cache miss)."""
    return pick_conv2d_algorithm(spec, backend=torch.device(device).type)


def _dispatch(x: torch.Tensor, kernel: torch.Tensor, spec: ConvSpec,
              s_h: int, s_w: int, algorithm: str, solution: str,
              w_blk: Optional[int]) -> torch.Tensor:
    """Execution of a *resolved* algorithm on the pre-padded input: the
    executor core that the kwargs path and ``conv2d(plan=)`` share."""
    if algorithm == "direct":
        return direct_conv2d(x, kernel, (s_h, s_w))
    if algorithm == "im2col":
        return im2col_conv2d(x, kernel, (s_h, s_w))
    if algorithm == "fft":
        return fft_conv2d(x, kernel, (s_h, s_w))
    if algorithm == "winograd":
        if (spec.k_h, spec.k_w, s_h, s_w) != (3, 3, 1, 1):
            raise ValueError(
                "winograd F(2x2,3x3) requires a 3x3 kernel and stride 1; "
                f"got kernel {(spec.k_h, spec.k_w)} stride {(s_h, s_w)}")
        return winograd_conv2d(x, kernel)
    return _MecConv.apply(x, kernel, s_h, s_w, algorithm, solution, w_blk)


def _check_devices(inp: torch.Tensor, kernel: torch.Tensor) -> None:
    if inp.device != kernel.device:
        raise ValueError(f"input on {inp.device} but kernel on "
                         f"{kernel.device}")


def conv2d(inp: torch.Tensor, kernel: torch.Tensor, *, stride=1,
           padding: Padding = "VALID", algorithm: str = "auto",
           solution: str = "auto", partition=None,
           plan: Optional["ConvPlan"] = None) -> torch.Tensor:
    """2-D convolution, NHWC x HWIO -> NHWC.

    inp: (i_n, i_h, i_w, i_c); kernel: (k_h, k_w, i_c, k_c), on one
    device.  stride: int or (s_h, s_w).  padding: 'SAME' | 'VALID' | int |
    ((lo, hi), (lo, hi)).  algorithm: one of :data:`ALGORITHMS`.
    solution: MEC Solution 'A' | 'B' | 'auto' (``mec`` only).
    partition: only None or 'none' (single device) so far.

    plan: a resolved :class:`repro_torch.plan.ConvPlan`.  Its decision
    fields (algorithm, solution, kernel ``w_blk``) win over the kwargs;
    the geometry kwargs (stride, padding) stay the caller's and must
    reproduce ``plan.spec``, and the operands' dtype and device the
    plan's, or the call raises.  Without a plan, ``algorithm="auto"``
    resolves through the plan cache (``repro_torch.plan.
    resolve_cached_plan``: process LRU, on-disk JSON, then the analytic
    costmodel pick), so repeated shapes reuse one decision.
    """
    if plan is not None:
        return _execute_plan(inp, kernel, plan, stride=stride,
                             padding=padding)
    if partition not in (None, "none"):
        raise NotImplementedError(
            f"conv2d(partition={partition!r}): distributed execution is "
            "not ported yet: ROADMAP Queue 1 item 11")
    _check_devices(inp, kernel)
    algorithm = algorithm.lower()
    if algorithm not in ALGORITHMS:
        raise ValueError(
            f"unknown algorithm {algorithm!r}; expected one of {ALGORITHMS}")

    s_h, s_w = normalize_stride(stride)
    k_h, k_w = kernel.shape[0], kernel.shape[1]
    x = apply_padding(inp, k_h, k_w, s_h, s_w, padding)
    spec = spec_of(x, kernel, (s_h, s_w))
    w_blk = None
    if algorithm == "auto":
        # Lazy import: plan sits above core.
        from repro_torch.plan import resolve_cached_plan
        cached = resolve_cached_plan(spec, dtype=x.dtype,
                                     backend=x.device.type)
        algorithm, w_blk = cached.algorithm, cached.w_blk
    return _dispatch(x, kernel, spec, s_h, s_w, algorithm, solution, w_blk)


def _execute_plan(inp: torch.Tensor, kernel: torch.Tensor, plan: "ConvPlan",
                  *, stride, padding: Padding) -> torch.Tensor:
    """Execute exactly the decision ``plan`` holds.  The caller's geometry
    (stride, padding, shapes), dtype and device must reproduce the
    plan's; every decision field comes from the plan."""
    from repro_torch.plan.convplan import ConvPlan
    if not isinstance(plan, ConvPlan):
        raise TypeError(f"conv2d(plan=...) takes a repro_torch.plan.ConvPlan, "
                        f"got {type(plan).__name__}")
    _check_devices(inp, kernel)
    s_h, s_w = normalize_stride(stride)
    k_h, k_w = kernel.shape[0], kernel.shape[1]
    x = apply_padding(inp, k_h, k_w, s_h, s_w, padding)
    spec = spec_of(x, kernel, (s_h, s_w))
    plan.check_executable(spec, x.dtype, x.device)
    return _dispatch(x, kernel, spec, s_h, s_w, plan.algorithm,
                     plan.solution, plan.w_blk)


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
