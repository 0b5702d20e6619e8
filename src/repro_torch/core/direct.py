"""Direct convolution (paper Fig. 1a): the numerical oracle.

The counterpart of ``repro.core.direct``, which calls XLA's direct
convolution.  XLA's conv is not a Pallas kernel, so the port uses the
library convolution (``F.conv2d``) here: inputs are upcast to f32, the
conv accumulates in f32, and the result narrows once to the input dtype.
Autograd differentiates the upcast convolution and narrows each gradient
back to its operand dtype through the casts, as the JAX custom VJP does.

cuDNN runs f32 convolutions in TF32 by default, which cannot meet the f32
budget of ``numerics.CONTRACTS``; the CUDA call therefore turns TF32 off,
in the forward and in its gradients, which autograd runs later, outside
the forward's context (:class:`_IeeeConv2d`).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from repro_torch.core.convspec import normalize_stride


@contextlib.contextmanager
def ieee_f32_conv():
    """Run cuDNN convolutions in IEEE f32 (TF32 off), then restore."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def accum_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 for sub-f32 inputs; wider inputs keep their own width."""
    return torch.promote_types(dtype, torch.float32)


def cudnn_operands(inp: torch.Tensor, kernel: torch.Tensor):
    """The operands :func:`direct_conv2d` hands ``F.conv2d``: the NHWC
    input as an NCHW view, which is channels-last memory (no copy in
    f32), and the HWIO kernel as an OIHW view, both in the accumulation
    dtype.  cuDNN then writes its output channels-last, which is the NHWC
    result.  No view of HWIO memory is channels-last OIHW (cuDNN's KRSC
    filter for an NHWC conv), so PyTorch's cuDNN binding makes that one
    kernel-sized copy inside ``F.conv2d``; the memory auditor counts it,
    with cuDNN's workspace, as the library's (``analysis.memaudit``)."""
    acc = accum_dtype(inp.dtype)
    return inp.permute(0, 3, 1, 2).to(acc), kernel.permute(3, 2, 0, 1).to(acc)


class _IeeeConv2d(torch.autograd.Function):
    """``F.conv2d`` (NCHW x OIHW, VALID) with TF32 off in the forward and
    in the one ``convolution_backward`` of its gradients."""

    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        with ieee_f32_conv():
            return F.conv2d(x, w, stride=stride)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with ieee_f32_conv():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, list(ctx.stride), [0, 0], [1, 1], False,
                [0, 0], 1, [ctx.needs_input_grad[0],
                            ctx.needs_input_grad[1], False])
        return dx, dw, None


def direct_conv2d(inp: torch.Tensor, kernel: torch.Tensor,
                  stride=1) -> torch.Tensor:
    """inp (n, h, w, c) pre-padded; kernel (k_h, k_w, i_c, k_c); VALID.
    Operands of two dtypes raise ``TypeError``, as the JAX package's
    direct convolution does."""
    if inp.dtype != kernel.dtype:
        raise TypeError(f"direct_conv2d requires arguments to have the same "
                        f"dtypes, got {inp.dtype} and {kernel.dtype}")
    x, w = cudnn_operands(inp, kernel)
    y = _IeeeConv2d.apply(x, w, normalize_stride(stride))
    return y.permute(0, 2, 3, 1).to(inp.dtype).contiguous()
