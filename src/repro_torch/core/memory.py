"""Analytic memory-overhead model (paper §3.4, Eqs. 2-4) for every
convolution algorithm compared in §4.  "Overhead" = temporary storage
beyond input/kernel/output, in elements (multiply by dtype size for bytes).

A copy of ``repro.core.memory``: pure arithmetic on a ConvSpec.
"""
from __future__ import annotations

from repro_torch.core.convspec import ConvSpec, padded_spec


def im2col_overhead(s: ConvSpec) -> int:
    """Eq. 2: the lowered Toeplitz matrix."""
    return s.i_n * s.o_h * s.o_w * s.k_h * s.k_w * s.i_c


def mec_overhead(s: ConvSpec) -> int:
    """Eq. 3: MEC's compact lowered matrix L."""
    return s.i_n * s.o_w * s.i_h * s.k_w * s.i_c


def mec_saving(s: ConvSpec) -> int:
    """Eq. 4 as the exact difference im2col_overhead - mec_overhead,
    which equals i_n * i_c * o_w * k_w * (o_h*k_h - i_h)."""
    return im2col_overhead(s) - mec_overhead(s)


def fft_overhead(s: ConvSpec, padding="VALID") -> int:
    """Kernels padded to input size + input/output spectra (complex => x2),
    sized on the post-padding spatial dims."""
    s = padded_spec(s, padding)
    w_f = s.i_w // 2 + 1
    ker = s.i_h * w_f * s.i_c * s.k_c * 2        # padded kernel spectra
    inp = s.i_n * s.i_h * w_f * s.i_c * 2        # input spectrum
    out = s.i_n * s.i_h * w_f * s.k_c * 2        # product spectrum
    return ker + inp + out


def winograd_overhead(s: ConvSpec) -> int:
    """F(2x2,3x3): transformed kernels U, tiles V, and products M."""
    t_h, t_w = -(-s.o_h // 2), -(-s.o_w // 2)
    u = 16 * s.i_c * s.k_c
    v = 16 * s.i_n * t_h * t_w * s.i_c
    m = 16 * s.i_n * t_h * t_w * s.k_c
    return u + v + m


def direct_overhead(s: ConvSpec) -> int:  # lint-ignore: accepted-kwarg-not-forwarded
    return 0          # no temporaries; s kept for ALL_OVERHEADS uniformity


def conv_flops(s: ConvSpec) -> int:
    """Mult-adds x2 — identical for direct/im2col/MEC (paper §3.2)."""
    return 2 * s.i_n * s.o_h * s.o_w * s.k_h * s.k_w * s.i_c * s.k_c


ALL_OVERHEADS = {
    "direct": direct_overhead,
    "im2col": im2col_overhead,
    "mec": mec_overhead,
    "fft": fft_overhead,
    "winograd": winograd_overhead,
}

# conv2d dispatch names -> the base overhead model above.  'lowered'
# materializes the same compact L as the reference; the fused kernel keeps
# the lowering on chip, so its device-memory overhead is the direct conv's.
_DISPATCH_BASE = {
    "mecA": "mec", "mecB": "mec", "mec_lowered": "mec",
    "mec_fused": "direct", "mec_fused2": "direct",
}


def algorithm_overhead(s: ConvSpec, algorithm: str,
                       padding="VALID") -> int:
    """Overhead in elements for any ``conv2d`` dispatch name; ``padding``
    resolves a pre-padding spec to the geometry actually allocated on."""
    return ALL_OVERHEADS[_DISPATCH_BASE.get(algorithm, algorithm)](
        padded_spec(s, padding))
