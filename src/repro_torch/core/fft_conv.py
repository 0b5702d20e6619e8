"""FFT-based convolution (paper §2.2, the FFT.gpu baseline); counterpart
of ``repro.core.fft_conv``.

Every kernel is zero-padded to the input's spatial size (the memory
overhead the paper criticizes: ``k_c`` padded kernel spectra of the
input's size), multiplied in the frequency domain in complex64, and the
valid region is cropped.  Strides decimate the full correlation.  Plain
PyTorch (``torch.fft``), as the JAX function is plain jnp: no kernel of
this repository.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.convspec import spec_of


def fft_conv2d(inp: torch.Tensor, kernel: torch.Tensor,
               stride=1) -> torch.Tensor:
    """inp (n, h, w, c) pre-padded; kernel (k_h, k_w, i_c, k_c); VALID.
    Both operands are taken to f32 first; the output is in inp.dtype."""
    spec = spec_of(inp, kernel, stride)
    i_h, i_w = spec.i_h, spec.i_w
    # HWIO kernel padded to the input's size: F.pad lists O, I, W, H pads.
    k_pad = F.pad(kernel.to(torch.float32),
                  (0, 0, 0, 0, 0, i_w - spec.k_w, 0, i_h - spec.k_h))
    f_inp = torch.fft.rfft2(inp.to(torch.float32), dim=(1, 2))   # (n,h,wf,c)
    f_ker = torch.fft.rfft2(k_pad, dim=(0, 1))                   # (h,wf,c,kc)
    # Cross-correlation theorem: corr = irfft(conj(F[k]) * F[i]).
    f_out = torch.einsum("nhwc,hwco->nhwo", f_inp, f_ker.conj())
    full = torch.fft.irfft2(f_out, s=(i_h, i_w), dim=(1, 2))
    valid = full[:, :i_h - spec.k_h + 1:spec.s_h,
                 :i_w - spec.k_w + 1:spec.s_w, :]
    return valid.to(inp.dtype).contiguous()
