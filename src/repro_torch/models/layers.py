"""Model primitives (counterpart of ``repro.models.layers``); this slice
ports the conv layer: ``init_conv2d`` and ``conv2d_layer``."""
from __future__ import annotations

import torch

from repro_torch.core.conv_api import conv2d


def init_conv2d(generator: torch.Generator, k_h: int, k_w: int, c_in: int,
                c_out: int, dtype: torch.dtype = torch.float32,
                bias: bool = True, device="cuda") -> dict:
    """HWIO weights ~ N(0, 1/(k_h*k_w*c_in)) drawn from ``generator`` on
    the generator's device, then moved to ``device``; zero bias."""
    w = torch.randn((k_h, k_w, c_in, c_out), generator=generator,
                    dtype=torch.float32, device=generator.device)
    p = {"w": (w * (k_h * k_w * c_in) ** -0.5).to(device=device, dtype=dtype)}
    if bias:
        p["b"] = torch.zeros((c_out,), dtype=dtype, device=device)
    return p


def conv2d_layer(p: dict, x: torch.Tensor, *, stride=1, padding="SAME",
                 algorithm: str = "auto") -> torch.Tensor:
    """One conv block through the front-end (``core.conv_api.conv2d``):
    the weights follow the activations' dtype, then the bias is added."""
    y = conv2d(x, p["w"].to(x.dtype), stride=stride, padding=padding,
               algorithm=algorithm)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y
