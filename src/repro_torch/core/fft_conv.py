"""FFT-based convolution (paper §2.2, the FFT.gpu baseline); counterpart
of ``repro.core.fft_conv``.

Every kernel is zero-padded to the input's spatial size (the memory
overhead the paper criticizes: ``k_c`` padded kernel spectra of the
input's size), multiplied in the frequency domain in complex64, and the
valid region is cropped.  Strides decimate the full correlation.  Plain
PyTorch (``torch.fft``), as the JAX function is plain jnp: no kernel of
this repository.

Memory: what the model counts (``core.memory.fft_overhead``) is the
kernel spectra, the input spectrum and the product spectrum, which must
all be live for the product.  Everything else is made in blocks of about
1/:data:`CHUNKS` of the planes, so that it costs a fraction of those
three: the padded kernels and each transform's own output (written into
the spectrum it belongs to), cuFFT's work area, and on the way back the
inverse transform's input copy and its full-plane output (cropped into
the result, which is allocated first, so that the auditor's "peak less
the output" counts every temporary).  The spectra are laid out
position-major, so the product is one batched GEMM per frequency with no
transposed copy.
"""
from __future__ import annotations

import torch

from repro_torch.core.convspec import spec_of

#: each transform runs on about 1/CHUNKS of its planes at a time
CHUNKS = 8


def _blocks(n_a: int, n_b: int):
    """(a0, a1, b0, b1) blocks of an n_a x n_b grid of planes, each about
    1/CHUNKS of them: whole rows of b where a row fits, else pieces of
    one row (few input channels, as on the RGB layers cv1-cv3, cv7)."""
    per = -(-n_a * n_b // CHUNKS)
    if per >= n_b:
        rows = per // n_b
        return [(a, min(a + rows, n_a), 0, n_b) for a in range(0, n_a, rows)]
    return [(a, a + 1, b, min(b + per, n_b))
            for a in range(n_a) for b in range(0, n_b, per)]


def fft_conv2d(inp: torch.Tensor, kernel: torch.Tensor,
               stride=1) -> torch.Tensor:
    """inp (n, h, w, c) pre-padded; kernel (k_h, k_w, i_c, k_c); VALID.
    Both operands are taken to f32 first; the output is in inp.dtype."""
    spec = spec_of(inp, kernel, stride)
    i_n, i_h, i_w, i_c, k_c = spec.i_n, spec.i_h, spec.i_w, spec.i_c, spec.k_c
    w_f = i_w // 2 + 1
    cplx = dict(dtype=torch.complex64, device=inp.device)
    out = torch.empty(spec.out_shape, dtype=torch.float32, device=inp.device)
    # Kernel spectra, (h, w_f, i_c, k_c), conjugated: the cross-correlation
    # theorem, corr = irfft(conj(F[k]) * F[i]).  rfft2's s= zero-pads each
    # block of kernels to the input's size.
    f_ker = torch.empty((i_h, w_f, i_c, k_c), **cplx)
    for c0, c1, o0, o1 in _blocks(i_c, k_c):
        k_blk = kernel[:, :, c0:c1, o0:o1].permute(2, 3, 0, 1).to(torch.float32)
        f_ker[:, :, c0:c1, o0:o1] = torch.fft.rfft2(
            k_blk, s=(i_h, i_w)).permute(2, 3, 0, 1)
    f_ker.conj_physical_()
    # Input spectrum, (h, w_f, n, i_c).
    f_inp = torch.empty((i_h, w_f, i_n, i_c), **cplx)
    for n0, n1, c0, c1 in _blocks(i_n, i_c):
        x_blk = inp[n0:n1, :, :, c0:c1].permute(0, 3, 1, 2).to(torch.float32)
        f_inp[:, :, n0:n1, c0:c1] = torch.fft.rfft2(x_blk).permute(2, 3, 0, 1)
    # Product spectrum, (h * w_f, n, k_c): per frequency, (n, i_c) @ (i_c, k_c).
    f_out = torch.bmm(f_inp.view(i_h * w_f, i_n, i_c),
                      f_ker.view(i_h * w_f, i_c, k_c))
    del f_inp, f_ker
    f_out = f_out.view(i_h, w_f, i_n, k_c)
    for n0, n1, o0, o1 in _blocks(i_n, k_c):
        full = torch.fft.irfft2(f_out[:, :, n0:n1, o0:o1].permute(2, 3, 0, 1),
                                s=(i_h, i_w))            # (n, oc, h, w)
        out[n0:n1, :, :, o0:o1] = full[
            :, :, :i_h - spec.k_h + 1:spec.s_h,
            :i_w - spec.k_w + 1:spec.s_w].permute(0, 2, 3, 1)
    return out.to(inp.dtype)
