"""Direct convolution (paper Fig. 1a): the numerical oracle.

The counterpart of ``repro.core.direct``, which calls XLA's direct
convolution.  XLA's conv is not a Pallas kernel, so the port uses the
library convolution (``F.conv2d``) here: inputs are upcast to f32, the
conv accumulates in f32, and the result narrows once to the input dtype.
Autograd differentiates the upcast convolution and narrows each gradient
back to its operand dtype through the casts, as the JAX custom VJP does.

cuDNN runs f32 convolutions in TF32 by default, which cannot meet the f32
budget of ``numerics.CONTRACTS``; the CUDA call therefore turns TF32 off.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

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


def direct_conv2d(inp: torch.Tensor, kernel: torch.Tensor,
                  stride=1) -> torch.Tensor:
    """inp (n, h, w, c) pre-padded; kernel (k_h, k_w, i_c, k_c); VALID.
    Operands of two dtypes raise ``TypeError``, as the JAX package's
    direct convolution does."""
    if inp.dtype != kernel.dtype:
        raise TypeError(f"direct_conv2d requires arguments to have the same "
                        f"dtypes, got {inp.dtype} and {kernel.dtype}")
    s = normalize_stride(stride)
    acc = accum_dtype(inp.dtype)
    x = inp.permute(0, 3, 1, 2).to(acc)           # NCHW
    w = kernel.permute(3, 2, 0, 1).to(acc)        # OIHW
    with ieee_f32_conv():
        y = F.conv2d(x, w, stride=s)
    return y.permute(0, 2, 3, 1).to(inp.dtype).contiguous()
