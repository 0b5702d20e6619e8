"""Operations and bytes of one 2-D convolution, NHWC x HWIO -> NHWC, and
the paper's memory overheads (Cho & Brand, ICML 2017, Eqs. 2-4).

A frozen copy of the arithmetic: the same count whatever implements the
convolution.  A geometry is the tuple ``(i_n, i_h, i_w, i_c, k_h, k_w,
k_c, s_h, s_w)`` of an input already padded (VALID).
"""
from __future__ import annotations

from typing import Sequence, Tuple

from mecbench.yardstick.peaks import DTYPE_BYTES, bound_s

Geometry = Tuple[int, int, int, int, int, int, int, int, int]


def out_hw(g: Geometry) -> Tuple[int, int]:
    i_n, i_h, i_w, i_c, k_h, k_w, k_c, s_h, s_w = g
    return (i_h - k_h) // s_h + 1, (i_w - k_w) // s_w + 1


def flops(g: Geometry) -> int:
    """Two operations a multiply-add: 2 n o_h o_w k_h k_w i_c k_c."""
    i_n, _, _, i_c, k_h, k_w, k_c, _, _ = g
    o_h, o_w = out_hw(g)
    return 2 * i_n * o_h * o_w * k_h * k_w * i_c * k_c


def elements(g: Geometry) -> Tuple[int, int, int]:
    """(input, kernel, output) element counts."""
    i_n, i_h, i_w, i_c, k_h, k_w, k_c, _, _ = g
    o_h, o_w = out_hw(g)
    return i_n * i_h * i_w * i_c, k_h * k_w * i_c * k_c, i_n * o_h * o_w * k_c


def forward_bytes(g: Geometry, dtype: str) -> int:
    """Each input and kernel byte read once, each output byte written once."""
    return sum(elements(g)) * DTYPE_BYTES[dtype]


def im2col_overhead(g: Geometry) -> int:
    """Eq. 2: the lowered Toeplitz matrix, in elements."""
    i_n, _, _, i_c, k_h, k_w, _, _, _ = g
    o_h, o_w = out_hw(g)
    return i_n * o_h * o_w * k_h * k_w * i_c


def mec_overhead(g: Geometry) -> int:
    """Eq. 3: MEC's compact lowered matrix L, in elements."""
    i_n, i_h, _, i_c, _, k_w, _, _, _ = g
    _, o_w = out_hw(g)
    return i_n * o_w * i_h * k_w * i_c


def mec_saving(g: Geometry) -> int:
    """Eq. 4: im2col's overhead less MEC's."""
    return im2col_overhead(g) - mec_overhead(g)


def stack_flops(geoms: Sequence[Geometry], train: bool = False) -> int:
    """A step of the stack: the forwards, or forward and backward (three
    times the forward's products)."""
    return (3 if train else 1) * sum(flops(g) for g in geoms)


def stack_bound_s(geoms: Sequence[Geometry], dtype: str) -> float:
    """The forwards' bound, conv by conv, summed."""
    return sum(bound_s(flops(g), forward_bytes(g, dtype), dtype)
               for g in geoms)
