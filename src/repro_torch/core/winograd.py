"""Winograd F(2x2, 3x3) convolution (the paper's Wino.cpu/Wino.gpu
baseline); counterpart of ``repro.core.winograd``.

Only for k_h == k_w == 3 at stride 1 (the paper notes the same
restriction).  Lavin (2015): kernel transform U = G g G^T, input-tile
transform V = B^T d B, elementwise products M = U . V reduced over input
channels, inverse transform Y = A^T M A, all in f32.  Plain PyTorch, as the JAX
function is plain jnp.

Memory: U, V and M (``core.memory.winograd_overhead``) are the only
buffers of their size.  The transforms are sums of the input's, the
kernel's and M's strided views with the matrices' few nonzero
coefficients (powers of two), added in place into U and V and, for Y,
into one buffer of a quarter of the output's tiles: no padded input, no
transposed copy.  The product is one batched GEMM over the 16 tile
positions.
"""
from __future__ import annotations

import torch

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


def _terms(a, b):
    """(i, l, j, k, a[i][j] * b[l][k]) for every nonzero coefficient of
    the bilinear transform a . X . b^T."""
    return [(i, l, j, k, a[i][j] * b[l][k])
            for i in range(len(a)) for l in range(len(b))
            for j in range(len(a[0])) for k in range(len(b[0]))
            if a[i][j] * b[l][k] != 0]


def winograd_conv2d(inp: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """inp (n, h, w, c) pre-padded; kernel (3, 3, i_c, k_c); stride 1
    VALID.  The output is in inp.dtype."""
    spec = spec_of(inp, kernel, 1)
    if (spec.k_h, spec.k_w) != (3, 3):
        raise ValueError("Winograd F(2x2,3x3) requires a 3x3 kernel")
    i_n, i_c, k_c = spec.i_n, spec.i_c, spec.k_c
    o_h, o_w = spec.o_h, spec.o_w
    t_h, t_w = -(-o_h // 2), -(-o_w // 2)          # 2x2 output tiles
    f32 = dict(dtype=torch.float32, device=inp.device)
    # the result first: a temporary is whatever the call holds beside it
    out = torch.empty((i_n, o_h, o_w, k_c), **f32)
    # V = B^T d B over the overlapping 4x4 input tiles at stride 2: tile
    # element (j, k) of every tile is the strided view x[:, j::2, k::2].
    # The last tile row or column may reach past the input (odd o_h, o_w):
    # the zero padding it would read adds nothing.
    v = torch.zeros((4, 4, i_n, t_h, t_w, i_c), **f32)
    for i, l, j, k, coef in _terms(_BT, _BT):
        src = inp[:, j::2, k::2, :][:, :t_h, :t_w]
        v[i, l, :, :src.shape[1], :src.shape[2]].add_(src, alpha=coef)
    # U = G g G^T, (4, 4, i_c, k_c)
    u = torch.zeros((4, 4, i_c, k_c), **f32)
    for i, l, j, k, coef in _terms(_G, _G):
        u[i, l].add_(kernel[j, k], alpha=coef)
    # M = sum over c of U . V, per tile position: (16, tiles, k_c)
    tiles = i_n * t_h * t_w
    m = torch.bmm(v.view(16, tiles, i_c), u.view(16, i_c, k_c))
    del v, u
    m = m.view(4, 4, i_n, t_h, t_w, k_c)
    # Y = A^T M A, one of the four positions of every output tile at a time
    y = torch.empty((i_n, t_h, t_w, k_c), **f32)
    inverse = _terms(_AT, _AT)
    for a in range(2):
        for b in range(2):
            y.zero_()
            for p, q, i, l, coef in inverse:
                if (p, q) == (a, b):
                    y.add_(m[i, l], alpha=coef)
            dst = out[:, a::2, b::2, :]
            dst.copy_(y[:, :dst.shape[1], :dst.shape[2]])
    return out.to(inp.dtype)
