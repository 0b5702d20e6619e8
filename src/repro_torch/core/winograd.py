"""Winograd F(2x2, 3x3) convolution (the paper's Wino.cpu/Wino.gpu
baseline); counterpart of ``repro.core.winograd``.

Only for k_h == k_w == 3 at stride 1 (the paper notes the same
restriction).  Lavin (2015): kernel transform U = G g G^T, input-tile
transform V = B^T d B, elementwise products M = U . V reduced over input
channels, inverse transform Y = A^T M A, all in f32.  Plain PyTorch
(``einsum``), as the JAX function is plain jnp.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.convspec import spec_of

_BT = ((1, 0, -1, 0),
       (0, 1, 1, 0),
       (0, -1, 1, 0),
       (0, 1, 0, -1))
_G = ((1, 0, 0),
      (0.5, 0.5, 0.5),
      (0.5, -0.5, 0.5),
      (0, 0, 1))
_AT = ((1, 1, 1, 0),
       (0, 1, -1, -1))


def winograd_conv2d(inp: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """inp (n, h, w, c) pre-padded; kernel (3, 3, i_c, k_c); stride 1
    VALID.  The output is in inp.dtype."""
    spec = spec_of(inp, kernel, 1)
    if (spec.k_h, spec.k_w) != (3, 3):
        raise ValueError("Winograd F(2x2,3x3) requires a 3x3 kernel")
    bt, g, at = (torch.tensor(m, dtype=torch.float32, device=inp.device)
                 for m in (_BT, _G, _AT))
    o_h, o_w = spec.o_h, spec.o_w
    t_h, t_w = -(-o_h // 2), -(-o_w // 2)          # 2x2 output tiles
    need_h, need_w = 2 * t_h + 2, 2 * t_w + 2      # input the tiles cover
    x = F.pad(inp.to(torch.float32),
              (0, 0, 0, need_w - spec.i_w, 0, need_h - spec.i_h))
    # Overlapping 4x4 input tiles at stride 2: (n, t_h, t_w, c, 4, 4).
    tiles = x.unfold(1, 4, 2).unfold(2, 4, 2)
    v = torch.einsum("ij,nthcjk,lk->nthilc", bt, tiles, bt)     # B^T d B
    u = torch.einsum("ij,jkco,lk->ilco", g, kernel.to(torch.float32), g)
    m = torch.einsum("nthilc,ilco->nthilo", v, u)               # sum over c
    y = torch.einsum("ij,nthjko,lk->nthilo", at, m, at)         # A^T M A
    out = y.permute(0, 1, 3, 2, 4, 5).reshape(spec.i_n, 2 * t_h, 2 * t_w,
                                              spec.k_c)
    return out[:, :o_h, :o_w, :].to(inp.dtype).contiguous()
