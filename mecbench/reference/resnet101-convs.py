"""Plain PyTorch reference of the conv stack: each 2-D convolution (NHWC x
HWIO -> NHWC, VALID, stride s) and its gradients, computed in float64 by
``torch.nn.functional.conv2d`` on the operands the benchmark drew.

The control (``LOWER``) is the same reference computed in the precision
just below the one the traffic states: operands rounded to float8 e4m3
with a per-tensor scale for bfloat16 traffic; to TF32 (10 mantissa bits,
to nearest) for float32 traffic, whose products the program computes to
float32 accuracy (TF32 off).  Imports nothing of the port.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

F64 = torch.float64
#: the traffic's dtype -> the precision just below it
LOWER = {"bfloat16": "float8_e4m3fn", "float32": "tf32"}


def round_to(t: torch.Tensor, precision: Optional[str]) -> torch.Tensor:
    """``t`` in float64 after rounding to ``precision`` (None: as is);
    float8 with a per-tensor scale that maps the largest magnitude to the
    format's largest finite value; TF32 by rounding float32's mantissa to
    10 bits."""
    t = t.detach().to(F64)
    if precision is None:
        return t
    if precision == "bfloat16":
        return t.to(torch.bfloat16).to(F64)
    if precision == "tf32":
        bits = t.to(torch.float32).view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF       # 23 -> 10 mantissa bits
        return bits.view(torch.float32).to(F64)
    fmt = getattr(torch, precision)
    scale = t.abs().max().clamp(min=1e-30) / torch.finfo(fmt).max
    return (t / scale).to(fmt).to(F64) * scale


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _conv(x64, w64, stride: int):
    y = F.conv2d(_nchw(x64), w64.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def forward(x, w, stride: int, precision: Optional[str] = None):
    """The conv's output, float64 (B, o_h, o_w, k_c)."""
    with torch.no_grad():
        return _conv(round_to(x, precision), round_to(w, precision), stride)


def forward_backward(x, w, stride: int, cot, precision: Optional[str] = None
                     ) -> dict:
    """Output, input gradient and kernel gradient for cotangent ``cot``,
    float64."""
    x64 = round_to(x, precision).requires_grad_()
    w64 = round_to(w, precision).requires_grad_()
    with torch.enable_grad():
        y = _conv(x64, w64, stride)
        dx, dw = torch.autograd.grad(y, (x64, w64), round_to(cot, precision))
    return {"out_err": y.detach(), "dx_err": dx, "dw_err": dw}


def scaled_error(y: torch.Tensor, ref: torch.Tensor) -> float:
    """max |y - ref| / max |ref|."""
    if tuple(y.shape) != tuple(ref.shape):
        raise ValueError(f"shape {tuple(y.shape)} against {tuple(ref.shape)}")
    d = (y.detach().to(F64) - ref).abs().max().item()
    scale = ref.abs().max().item()
    return d / (scale if scale > 0 else 1.0)
