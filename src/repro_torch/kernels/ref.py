"""Plain oracles for every kernel in this package (counterpart of
``repro.kernels.ref``), plus the f64 oracle and the scale-normalized
error the numeric contracts are stated in."""
from __future__ import annotations

import torch

from repro_torch.core.direct import direct_conv2d
from repro_torch.core.mec import mec_conv1d_depthwise, mec_lower


def conv2d_ref(inp: torch.Tensor, kernel: torch.Tensor,
               stride=1) -> torch.Tensor:
    """Oracle for mec_gemm / mec_conv_fused."""
    return direct_conv2d(inp, kernel, stride)


def lower_ref(inp: torch.Tensor, k_w: int, s_w: int) -> torch.Tensor:
    """Oracle for mec_lower: L (n, o_w, i_h, k_w*i_c)."""
    low = mec_lower(inp, k_w, s_w)  # (n, o_w, i_h, k_w, i_c)
    n, o_w, i_h, kw, i_c = low.shape
    return low.reshape(n, o_w, i_h, kw * i_c)


def conv1d_ref(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Oracle for mec_conv1d (causal depthwise)."""
    return mec_conv1d_depthwise(x, kernel, causal=True)


def conv2d_f64(inp: torch.Tensor, kernel: torch.Tensor,
               stride=1) -> torch.Tensor:
    """The f64 oracle: the direct conv of the inputs upcast to float64
    (for bf16/f16 inputs, of the same quantized values)."""
    return conv2d_ref(inp.to(torch.float64), kernel.to(torch.float64), stride)


def scaled_error(y: torch.Tensor, ref: torch.Tensor) -> float:
    """max|y - ref| / max|ref|, the contracts' error measure."""
    if y.shape != ref.shape:
        raise ValueError(f"shape {tuple(y.shape)} != {tuple(ref.shape)}")
    y64, r64 = y.to(torch.float64), ref.to(torch.float64)
    scale = r64.abs().max().item()
    return (y64 - r64).abs().max().item() / (scale if scale > 0 else 1.0)
