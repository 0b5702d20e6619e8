"""Conventional im2col-based convolution (the paper's main baseline).

Lowers the input into the full Toeplitz matrix ``(i_n*o_h*o_w,
k_h*k_w*i_c)`` (paper Eq. 2) and performs a single GEMM with f32
accumulation.  Counterpart of ``repro.core.im2col``.
"""
from __future__ import annotations

import torch

from repro_torch.core.convspec import spec_of
from repro_torch.core.direct import accum_dtype


def im2col_lower(inp: torch.Tensor, k_h: int, k_w: int, s_h: int,
                 s_w: int) -> torch.Tensor:
    """inp (i_n, i_h, i_w, i_c) -> L (i_n*o_h*o_w, k_h*k_w*i_c)."""
    i_n, _, _, i_c = inp.shape
    # (i_n, o_h, i_w, i_c, k_h) -> (i_n, o_h, o_w, i_c, k_h, k_w)
    win = inp.unfold(1, k_h, s_h).unfold(2, k_w, s_w)
    _, o_h, o_w = win.shape[:3]
    low = win.permute(0, 1, 2, 4, 5, 3)   # (i_n, o_h, o_w, k_h, k_w, i_c)
    return low.reshape(i_n * o_h * o_w, k_h * k_w * i_c)


def im2col_conv2d(inp: torch.Tensor, kernel: torch.Tensor,
                  stride=1) -> torch.Tensor:
    spec = spec_of(inp, kernel, stride)
    low = im2col_lower(inp, spec.k_h, spec.k_w, spec.s_h, spec.s_w)
    kernel_mat = kernel.reshape(spec.k_h * spec.k_w * spec.i_c, spec.k_c)
    acc = accum_dtype(low.dtype)
    out = torch.matmul(low.to(acc), kernel_mat.to(low.dtype).to(acc))
    return out.to(low.dtype).reshape(spec.out_shape)
