"""Hand-written Hopper kernel for the causal depthwise MEC conv1d (K5), and
its plain version.

``mec_conv1d`` launches ``conv1d_kernel`` of ``csrc/mec_conv1d.cu`` for a
CUDA tensor (``conv1d_any_kw_kernel`` for k_w above :data:`MAX_KW`), and
computes the same function with its plain PyTorch version for a CPU
tensor; any other device, mixed devices or another dtype than
f32/bf16/f16 raise.  There is no fallback from a CUDA tensor to the plain
version.  ``mec_conv1d.launches`` counts its launches.

Operands of two dtypes compute the JAX package's function, which
multiplies by the kernel in its own dtype: both are promoted to
``torch.promote_types`` of the two (a bf16 input with an f32 kernel runs
the f32 instance) and the output comes back in the input's dtype.

==============  =============================================  =====
wrapper         replaces (src/repro/kernels/mec_conv1d.py)     bound
==============  =============================================  =====
``mec_conv1d``  ``mec_conv1d_pallas`` / ``_conv1d_kernel``     bytes
==============  =============================================  =====

The design notes head ``csrc/mec_conv1d.cu``.  The kernel sums in IEEE
f32 over the k_w taps in order, rounding each product and each add, which
is the plain version's arithmetic: the two agree to the bit.  It moves
whole vectors of channels, as wide as :func:`vector_bytes` finds the
operands allow.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.mec import mec_conv1d_shift
from repro_torch.kernels import build
from repro_torch.kernels.mec_conv import _DTYPE_CODE, _on_cpu

#: the largest kernel width of the CUDA source's specialised instances (its
#: kMaxKw); above it one instance per dtype takes k_w at run time
MAX_KW = 8
#: the vector widths, in bytes, the CUDA source instantiates beside one
#: element, widest first
VECTOR_BYTES = (16, 8, 4)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("mec_conv1d")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mec_conv1d.argtypes = [ptr, ptr, ptr, i32] + [i64] * 7 + [ptr]
    lib.mec_conv1d.restype = i32
    lib.mec_conv1d_max_kw.argtypes = []
    lib.mec_conv1d_max_kw.restype = i32
    lib.mec_conv1d_error_string.argtypes = [i32]
    lib.mec_conv1d_error_string.restype = ctypes.c_char_p
    if lib.mec_conv1d_max_kw() != MAX_KW:
        raise RuntimeError(f"csrc/mec_conv1d.cu instantiates k_w <= "
                           f"{lib.mec_conv1d_max_kw()}, the wrapper assumes "
                           f"{MAX_KW}")
    return lib


def _promoted(x: torch.Tensor, kernel: torch.Tensor):
    common = torch.promote_types(x.dtype, kernel.dtype)
    return x.to(common), kernel.to(common)


def mec_conv1d_plain(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The kernel's function in PyTorch: the shift-add conv of
    ``core.mec.mec_conv1d_shift`` (causal) on both operands promoted to
    their common dtype, returned in x's dtype."""
    xp, kp = _promoted(x, kernel)
    return mec_conv1d_shift(xp, kp, causal=True).to(x.dtype)


def vector_bytes(x: torch.Tensor, kernel: torch.Tensor, out: torch.Tensor) -> int:
    """The widest vector K5 can move for these operands: 16, 8 or 4 bytes,
    else one element.  It must divide, in bytes, the addresses of x, the
    kernel and the output, x's batch and time strides, and c (the row
    stride of the kernel and the output).  At the zamba2-7b conv input (a
    slice from column 7168 of a 14576-wide bf16 row, c = 7296) that is 16."""
    es = x.element_size()
    need = (x.data_ptr(), kernel.data_ptr(), out.data_ptr(), x.stride(0) * es,
            x.stride(1) * es, x.shape[2] * es)
    for vb in VECTOR_BYTES:
        if all(v % vb == 0 for v in need):
            return vb
    return es


def mec_conv1d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv1d: x (n, t, c), kernel (k_w, c), any k_w >= 1,
    both promoted to their common dtype.  Returns (n, t, c) contiguous in
    x.dtype.  x may be strided along its batch and time axes (the kernel
    reads its strides); an x whose channels are not contiguous, or whose
    dtype is promoted, is copied first."""
    if x.dim() != 3 or kernel.dim() != 2 or kernel.shape[1] != x.shape[2]:
        raise ValueError(f"x {tuple(x.shape)} and kernel {tuple(kernel.shape)}"
                         f" are not (n, t, c) and (k_w, c)")
    n, t, c = x.shape
    k_w = kernel.shape[0]
    if min(n, t, c, k_w) < 1:
        raise ValueError(f"empty conv1d: x {tuple(x.shape)}, kernel "
                         f"{tuple(kernel.shape)}")
    out_dtype = x.dtype
    x, kernel = _promoted(x, kernel)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"K5 takes float32/bfloat16/float16, got {x.dtype}")
    if _on_cpu(x, kernel):
        return mec_conv1d_plain(x, kernel).to(out_dtype)
    if x.stride(2) != 1:
        x = x.contiguous()
    kernel = kernel.contiguous()
    out = torch.empty((n, t, c), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.mec_conv1d(x.data_ptr(), kernel.data_ptr(), out.data_ptr(),
                            _DTYPE_CODE[x.dtype], n, t, c, k_w, x.stride(0),
                            x.stride(1), vector_bytes(x, kernel, out), stream)
    if rc != 0:
        raise RuntimeError(f"mec_conv1d: CUDA error {rc} "
                           f"({lib.mec_conv1d_error_string(rc).decode()})")
    mec_conv1d.launches += 1
    return out.to(out_dtype)


mec_conv1d.launches = 0
