"""Hand-written Hopper kernels for MEC convolution, and their plain versions.

Each wrapper below launches one CUDA kernel of ``csrc/mec_conv.cu`` for a
CUDA tensor, and computes the same function with its plain PyTorch
version for a CPU tensor; any other device raises.  There is no fallback
from a CUDA tensor to the plain version.  Each wrapper counts its
launches in a plain int attribute, ``<wrapper>.launches``.

===================  ============================================  ==========
wrapper              replaces (src/repro/kernels/mec_conv.py)      bound
===================  ============================================  ==========
``mec_lower``        ``mec_lower_pallas`` / ``_lower_kernel``       bytes
``mec_conv_fused``   ``mec_conv_fused_pallas`` / ``_fused_kernel``   operations
``mec_conv_fused2``  ``mec_conv_fused2_pallas`` / ``_fused2_kernel`` operations
``mec_gemm``         ``mec_gemm_pallas`` / ``_gemm_kernel``         operations
``mec_weight_grad``  none: the MEC VJP's weight gradient (K6)       operations
===================  ============================================  ==========

The design notes (what bounds each kernel on the card and what its
design does about it) head ``csrc/mec_conv.cu`` and, for K6,
``csrc/mec_wgrad.cu``, built into the same library.  Every kernel
accumulates in f32 and writes the output in the input dtype, which fuses
the TPU wrappers' final casts.  An input and a kernel of two dtypes are
both promoted (``torch.promote_types``) before the kernel or its plain
version, as the TPU kernels multiply by the kernel in its own dtype: a
bf16 input with an f32 kernel runs the f32 instance, and the output comes
back in the input's dtype.  K1, K3 and K4 multiply on the tensor
cores, through one core: bf16/f16 products are exact in f32; f32 operands
are split into two TF32 halves and multiplied as three TF32 products
(hi*hi + hi*lo + lo*hi), which keeps the f32 contract.  K3 runs that core
on L read as an image (:func:`gemm_core`).  K2 and K5 move bytes.  K6
takes f32 operands (others are cast) through the same three-product
split.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List

import torch

from repro_torch import obs
from repro_torch.core import mec as core_mec
from repro_torch.core.convspec import normalize_stride, spec_of
from repro_torch.core.direct import accum_dtype
from repro_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: ``cudaErrorInvalidValue``: what the launchers return for a configuration
#: they do not take
_CUDA_ERROR_INVALID_VALUE = 1


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("mec_conv")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mec_lower.argtypes = [ptr, ptr, i32] + [i64] * 7 + [ptr]
    lib.mec_fused.argtypes = [ptr, ptr, ptr, i32] + [i64] * 12 + [ptr]
    lib.mec_fused2.argtypes = [ptr, ptr, ptr, i32] + [i64] * 13 + [ptr]
    lib.mec_gemm.argtypes = [ptr, ptr, ptr, i32] + [i64] * 10 + [ptr]
    lib.mec_wgrad.argtypes = [ptr] * 4 + [i64] * 12 + [ptr]
    lib.mec_wgrad_config.argtypes = [i64] * 11 + [ctypes.POINTER(i64)]
    lib.mec_fused2_tile.argtypes = [i64] * 6 + [ctypes.POINTER(i32)] * 2
    lib.mec_fused_config.argtypes = [i32, i32] + [i64] * 13 + [
        ctypes.POINTER(i64)]
    for fn in (lib.mec_lower, lib.mec_fused, lib.mec_fused2, lib.mec_gemm,
               lib.mec_fused2_tile, lib.mec_fused_config, lib.mec_wgrad,
               lib.mec_wgrad_config):
        fn.restype = i32
    lib.mec_error_string.argtypes = [i32]
    lib.mec_error_string.restype = ctypes.c_char_p
    return lib


def _on_cpu(*tensors: torch.Tensor, trace: bool = False) -> bool:
    """True for CPU operands (plain version); False for CUDA operands
    (kernel) and, with ``trace``, for meta operands (a trace of the kernel
    path, whose launch :func:`_launch` turns into one recorded op).
    Raises on mixed or other devices, and where the operands' promoted
    dtype has no kernel instance."""
    device = tensors[0].device
    for t in tensors[1:]:
        if t.device != device:
            raise ValueError(f"operands on different devices: {device} and "
                             f"{t.device}")
    if device.type == "cpu":
        return True
    if device.type != "cuda" and not (trace and device.type == "meta"):
        raise ValueError(f"MEC kernels run on cuda (or cpu, plain version); "
                         f"got {device}")
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in tensors))
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"MEC kernels take float32/bfloat16/float16, got "
                        f"{dtype}")
    return False


class LaunchRefused(RuntimeError):
    """The launcher does not take this configuration, by design (a dtype it
    has no instance for, a tile that does not fit shared memory, a grid past
    the card's limits).  A failure to build or load the kernels, or any other
    CUDA error, is a plain ``RuntimeError``."""


def _promote(inp: torch.Tensor, kernel: torch.Tensor):
    """Both operands in ``torch.promote_types`` of their dtypes (no copy
    when they agree)."""
    common = torch.promote_types(inp.dtype, kernel.dtype)
    return inp.to(common), kernel.to(common)


@torch.library.custom_op("repro_torch::kernel_call", mutates_args=("out",))
def _kernel_call(name: str, operands: List[torch.Tensor],
                 out: torch.Tensor) -> None:
    """A kernel launch as a trace sees it (``analysis.numcheck``): on meta
    tensors, where the launch computes nothing, the one op that names
    the kernel, its operands and its output.  No CUDA path calls it."""
    raise NotImplementedError("kernel_call stands for a launch on meta "
                              "tensors only")


@_kernel_call.register_fake
def _(name, operands, out):
    """Computes nothing: the launch's output is already allocated."""


def _launch(wrapper, fn_name: str, operands, out: torch.Tensor,
            *sizes) -> None:
    """Call C entry ``fn_name`` with the pointers of ``operands`` and
    ``out``, then ``sizes``, on ``out``'s device and its current stream;
    raise on the ``cudaError_t`` it returns, else add one to
    ``wrapper.launches``.  On meta tensors the launch is
    :func:`_kernel_call`, and nothing is counted."""
    if out.device.type == "meta":
        _kernel_call(fn_name, list(operands), out)
        return
    lib = _lib()
    ptrs = [t.data_ptr() for t in (*operands, out)]
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = getattr(lib, fn_name)(*ptrs, *sizes, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc} "
                           f"({lib.mec_error_string(rc).decode()})")
    wrapper.launches += 1


# ---------------------------------------------------------------------------
# K2: compact lowering  I (n, i_h, i_w, i_c) -> L (n, o_w, i_h, k_w*i_c)
# ---------------------------------------------------------------------------

def mec_lower_plain(inp: torch.Tensor, k_w: int, s_w: int) -> torch.Tensor:
    """L[n, w, h, j*i_c + c] = I[n, h, s_w*w + j, c]."""
    i_n, i_h, _, i_c = inp.shape
    # (n, o_w, i_h, k_w, i_c), materialized: a reshape alone would return
    # an overlapping view of I, not L.
    low = inp.unfold(2, k_w, s_w).permute(0, 2, 1, 4, 3).contiguous()
    return low.reshape(i_n, low.shape[1], i_h, k_w * i_c)


def mec_lower(inp: torch.Tensor, k_w: int, s_w: int) -> torch.Tensor:
    """Compact MEC lowering (paper Algorithm 2 lines 4-6) into L."""
    i_n, i_h, i_w, i_c = inp.shape
    if not (1 <= k_w <= i_w and s_w >= 1):
        raise ValueError(f"bad lowering k_w={k_w} s_w={s_w} for width {i_w}")
    if _on_cpu(inp, trace=True):
        return mec_lower_plain(inp, k_w, s_w)
    inp = inp.contiguous()
    o_w = (i_w - k_w) // s_w + 1
    low = torch.empty((i_n, o_w, i_h, k_w * i_c), dtype=inp.dtype,
                      device=inp.device)
    _launch(mec_lower, "mec_lower", (inp,), low, _DTYPE_CODE[inp.dtype],
            i_n, i_h, i_w, i_c, k_w, s_w, o_w)
    return low


mec_lower.launches = 0


# ---------------------------------------------------------------------------
# K1: fused conv, lowering on chip  I, K -> O
# ---------------------------------------------------------------------------

def mec_conv_fused_plain(inp: torch.Tensor, kernel: torch.Tensor,
                         stride=1) -> torch.Tensor:
    """O[n, h] = sum_r strip(I[n, h*s_h + r]) @ K[r], f32 accumulation,
    one cast to the input dtype."""
    spec = spec_of(inp, kernel, stride)
    out_dtype = inp.dtype
    inp, kernel = _promote(inp, kernel)
    acc = accum_dtype(inp.dtype)
    k_mat = kernel.reshape(spec.k_h, spec.k_w * spec.i_c, spec.k_c).to(acc)
    out = None
    for r in range(spec.k_h):
        rows = inp[:, r:r + spec.s_h * (spec.o_h - 1) + 1:spec.s_h]
        strip = rows.unfold(2, spec.k_w, spec.s_w).permute(0, 1, 2, 4, 3)
        strip = strip.reshape(spec.i_n, spec.o_h, spec.o_w, -1).to(acc)
        term = torch.matmul(strip, k_mat[r])
        out = term if out is None else out + term
    return out.to(out_dtype)


def mec_conv_fused(inp: torch.Tensor, kernel: torch.Tensor, stride=1,
                   w_blk: int = 64) -> torch.Tensor:
    """Fused MEC convolution: the lowering happens in shared memory, L
    never exists in device memory.  inp (n, i_h, i_w, i_c) pre-padded,
    kernel (k_h, k_w, i_c, k_c), w_blk output columns per CTA (clamped to
    o_w).  Returns (n, o_h, o_w, k_c) in inp.dtype."""
    spec = spec_of(inp, kernel, stride)
    if w_blk < 1:
        raise ValueError(f"w_blk must be >= 1, got {w_blk}")
    w_blk = min(w_blk, spec.o_w)
    if _on_cpu(inp, kernel, trace=True):
        return mec_conv_fused_plain(inp, kernel, (spec.s_h, spec.s_w))
    out_dtype = inp.dtype
    inp, kernel = _promote(inp, kernel)
    inp, kernel = inp.contiguous(), kernel.contiguous()
    out = torch.empty(spec.out_shape, dtype=inp.dtype, device=inp.device)
    _launch(mec_conv_fused, "mec_fused", (inp, kernel), out,
            _DTYPE_CODE[inp.dtype], spec.i_n, spec.i_h, spec.i_w, spec.i_c,
            spec.k_h, spec.k_w, spec.k_c, spec.s_h, spec.s_w, spec.o_h,
            spec.o_w, w_blk)
    return out.to(out_dtype)


mec_conv_fused.launches = 0


# ---------------------------------------------------------------------------
# K4: h-blocked fused conv, oh_blk output rows per CTA  I, K -> O
# ---------------------------------------------------------------------------

def mec_conv_fused2_plain(inp: torch.Tensor, kernel: torch.Tensor, stride=1,
                          oh_blk: int = 8) -> torch.Tensor:
    """The h-blocked decomposition: each block of oh_blk output rows is
    computed from its own rows_blk + halo input rows (oh_blk*s_h + k_h -
    s_h), O[n, h0 + d] = sum_r strip(X[n, d*s_h + r]) @ K[r] over the
    block's rows X; f32 accumulation, one cast to the input dtype."""
    spec = spec_of(inp, kernel, stride)
    if oh_blk < 1:
        raise ValueError(f"oh_blk must be >= 1, got {oh_blk}")
    out_dtype = inp.dtype
    inp, kernel = _promote(inp, kernel)
    acc = accum_dtype(inp.dtype)
    k_mat = kernel.reshape(spec.k_h, spec.k_w * spec.i_c, spec.k_c).to(acc)
    blocks = []
    for h0 in range(0, spec.o_h, oh_blk):
        rows = min(oh_blk, spec.o_h - h0)
        x = inp[:, h0 * spec.s_h:(h0 + rows - 1) * spec.s_h + spec.k_h]
        out = None
        for r in range(spec.k_h):
            sel = x[:, r:r + spec.s_h * (rows - 1) + 1:spec.s_h]
            strip = sel.unfold(2, spec.k_w, spec.s_w).permute(0, 1, 2, 4, 3)
            strip = strip.reshape(spec.i_n, rows, spec.o_w, -1).to(acc)
            term = torch.matmul(strip, k_mat[r])
            out = term if out is None else out + term
        blocks.append(out)
    return torch.cat(blocks, dim=1).to(out_dtype)


def mec_conv_fused2(inp: torch.Tensor, kernel: torch.Tensor, stride=1,
                    w_blk: int = 64, oh_blk: int = 8) -> torch.Tensor:
    """h-blocked fused MEC convolution: a CTA computes oh_blk output rows
    x w_blk output columns (each clamped to the output) and reads each of
    its input rows once per channel chunk.  inp (n, i_h, i_w, i_c)
    pre-padded, kernel (k_h, k_w, i_c, k_c).  Returns (n, o_h, o_w, k_c)
    in inp.dtype."""
    spec = spec_of(inp, kernel, stride)
    if w_blk < 1 or oh_blk < 1:
        raise ValueError(f"w_blk and oh_blk must be >= 1, got {w_blk}, "
                         f"{oh_blk}")
    w_blk, oh_blk = min(w_blk, spec.o_w), min(oh_blk, spec.o_h)
    if _on_cpu(inp, kernel, trace=True):
        return mec_conv_fused2_plain(inp, kernel, (spec.s_h, spec.s_w),
                                     oh_blk=oh_blk)
    out_dtype = inp.dtype
    inp, kernel = _promote(inp, kernel)
    inp, kernel = inp.contiguous(), kernel.contiguous()
    out = torch.empty(spec.out_shape, dtype=inp.dtype, device=inp.device)
    _launch(mec_conv_fused2, "mec_fused2", (inp, kernel), out,
            _DTYPE_CODE[inp.dtype], spec.i_n, spec.i_h, spec.i_w, spec.i_c,
            spec.k_h, spec.k_w, spec.k_c, spec.s_h, spec.s_w, spec.o_h,
            spec.o_w, w_blk, oh_blk)
    return out.to(out_dtype)


mec_conv_fused2.launches = 0


def fused2_tile(oh_blk: int, w_blk: int, k_h: int, k_w: int, s_h: int,
                s_w: int) -> tuple[int, int]:
    """The (rows, columns) sub-tile K4's launcher runs for an oh_blk x
    w_blk block on the current CUDA device, which ``ops.pick_oh_blk``
    sizes its blocks by; it launches nothing."""
    tr, tc = ctypes.c_int(), ctypes.c_int()
    rc = _lib().mec_fused2_tile(oh_blk, w_blk, k_h, k_w, s_h, s_w,
                                ctypes.byref(tr), ctypes.byref(tc))
    if rc != 0:
        raise RuntimeError(f"mec_fused2_tile: CUDA error {rc} "
                           f"({_lib().mec_error_string(rc).decode()})")
    return tr.value, tc.value


#: the fields of :func:`fused_config`, in the C entry's order
FUSED_CONFIG_FIELDS = ("tr", "tc", "mma_rows", "compact", "chunk", "chunks",
                       "split", "smem_bytes", "input_copy_bytes",
                       "kernel_copy_bytes")


def fused_config(kernel: int, dtype: torch.dtype, inp_shape, kernel_shape,
                 stride=1, w_blk: int = 64, oh_blk: int = 8) -> dict:
    """What K1 (``kernel=1``), K4 (``kernel=4``) or K3 (``kernel=3``, given
    the core's geometry of :func:`gemm_core`; :func:`gemm_config` passes
    it) runs for this geometry on the current CUDA device, with
    16-byte-aligned operands: the
    sub-tile (``tr`` x ``tc``), the MMA tile's rows, the reduction path
    (``compact``: over the k_w*i_c run; else channel chunks), the chunk
    and the number of chunks, the cluster ``split`` of the reduction, the
    shared memory and the copy widths.  It launches nothing.  Raises
    :class:`LaunchRefused` where the launcher would refuse the
    configuration, ``RuntimeError`` on any other failure."""
    i_n, i_h, i_w, i_c = inp_shape
    k_h, k_w, _, k_c = kernel_shape
    s_h, s_w = (stride, stride) if isinstance(stride, int) else stride
    o_h, o_w = (i_h - k_h) // s_h + 1, (i_w - k_w) // s_w + 1
    w_blk, oh_blk = min(w_blk, o_w), min(oh_blk, o_h)
    if dtype not in _DTYPE_CODE:
        raise LaunchRefused(f"mec_fused_config: no instance for {dtype}")
    vals = (ctypes.c_longlong * len(FUSED_CONFIG_FIELDS))()
    rc = _lib().mec_fused_config(kernel, _DTYPE_CODE[dtype], i_n, i_h, i_w,
                                 i_c, k_h, k_w, k_c, s_h, s_w, o_h, o_w, w_blk,
                                 oh_blk, vals)
    if rc == _CUDA_ERROR_INVALID_VALUE:
        raise LaunchRefused(f"mec_fused_config: configuration refused "
                            f"({_lib().mec_error_string(rc).decode()})")
    if rc != 0:
        raise RuntimeError(f"mec_fused_config: CUDA error {rc} "
                           f"({_lib().mec_error_string(rc).decode()})")
    return dict(zip(FUSED_CONFIG_FIELDS, vals))


# ---------------------------------------------------------------------------
# K3: shifted GEMM over L  L, K (k_h, k_w*i_c, k_c) -> O
# ---------------------------------------------------------------------------

def _gemm_geometry(low: torch.Tensor, kernel_mat: torch.Tensor, k_h: int,
                   s_h: int):
    i_n, o_w, i_h, kwic = low.shape
    if kernel_mat.dim() != 3 or kernel_mat.shape[:2] != (k_h, kwic):
        raise ValueError(f"kernel_mat {tuple(kernel_mat.shape)} is not "
                         f"(k_h={k_h}, k_w*i_c={kwic}, k_c)")
    if not (1 <= k_h <= i_h and s_h >= 1):
        raise ValueError(f"bad k_h={k_h} s_h={s_h} for height {i_h}")
    return i_n, o_w, i_h, kwic, kernel_mat.shape[2], (i_h - k_h) // s_h + 1


def gemm_core(low_shape, kernel_mat_shape, k_h: int, s_h: int,
              w_blk: int | None = None) -> dict:
    """K3 as the K1/K4 core runs it.  L (n, o_w, i_h, k_w*i_c), contiguous,
    is read as an NHWC image I' of height o_w, width i_h and k_w*i_c
    channels (``inp``), kernel_mat (k_h, k_w*i_c, k_c) as the HWIO kernel
    K' (1, k_h, k_w*i_c, k_c) (``kernel``), at ``stride`` (1, s_h):
    O[n, h, w, k] = conv(I', K')[n, w, h, k].  The core's output (n, o_w,
    o_h, k_c) goes to O with its two spatial axes swapped:
    ``out_strides`` are the elements between neighbours along the core's
    n, row (O's w) and column (O's h).  Blocks, in the core's terms:
    ``oh_blk`` rows (output columns w, the wrapper's ``w_blk``) and
    ``w_blk`` columns (output rows h) a CTA; K4's pickers choose both on
    this transposed geometry, ``w_blk`` given (clamped to o_w) where not
    None."""
    # ops imports this module for its wrappers; its pickers come at call time
    from repro_torch.kernels.ops import pick_fused_w_blk, pick_oh_blk
    i_n, o_w, i_h, kwic = low_shape
    k_c = kernel_mat_shape[2]
    o_h = (i_h - k_h) // s_h + 1
    h_blk = pick_fused_w_blk(o_h, k_c, i_n, o_w)
    rows = pick_oh_blk(o_w, o_h, h_blk, k_c, i_n) if w_blk is None else min(w_blk, o_w)
    return {"inp": (i_n, o_w, i_h, kwic), "kernel": (1, k_h, kwic, k_c),
            "stride": (1, s_h), "out_shape": (i_n, o_w, o_h, k_c),
            "out_strides": (o_h * o_w * k_c, k_c, o_w * k_c),
            "oh_blk": rows, "w_blk": h_blk}


def gemm_config(dtype: torch.dtype, low_shape, kernel_mat_shape, k_h: int,
                s_h: int, w_blk: int | None = None) -> dict:
    """What K3 runs (:func:`fused_config`'s fields) for L of ``low_shape``
    on the current CUDA device; it launches nothing."""
    core = gemm_core(low_shape, kernel_mat_shape, k_h, s_h, w_blk)
    return fused_config(3, dtype, core["inp"], core["kernel"], core["stride"],
                        core["w_blk"], core["oh_blk"])


def mec_gemm_plain(low: torch.Tensor, kernel_mat: torch.Tensor, k_h: int,
                   s_h: int) -> torch.Tensor:
    """O[n, h] = sum_r L[n, :, h*s_h + r, :] @ K[r], f32 accumulation, one
    cast to L's dtype."""
    _, _, _, _, _, o_h = _gemm_geometry(low, kernel_mat, k_h, s_h)
    out_dtype = low.dtype
    low, kernel_mat = _promote(low, kernel_mat)
    acc = accum_dtype(low.dtype)
    k_mat = kernel_mat.to(acc)
    out = None
    for r in range(k_h):
        rows = low[:, :, r:r + s_h * (o_h - 1) + 1:s_h]   # (n, o_w, o_h, kwic)
        term = torch.matmul(rows.to(acc), k_mat[r])
        out = term if out is None else out + term
    return out.permute(0, 2, 1, 3).to(out_dtype).contiguous()


def mec_gemm(low: torch.Tensor, kernel_mat: torch.Tensor, k_h: int, s_h: int,
             w_blk: int | None = None) -> torch.Tensor:
    """The o_h shifted GEMMs over a materialized L (paper-faithful path):
    low (n, o_w, i_h, k_w*i_c) from :func:`mec_lower`, kernel_mat
    (k_h, k_w*i_c, k_c), w_blk output columns per CTA (clamped to o_w;
    None: K4's picker on :func:`gemm_core`'s geometry).  Returns O (n, o_h,
    o_w, k_c) in low.dtype."""
    i_n, o_w, i_h, kwic, k_c, o_h = _gemm_geometry(low, kernel_mat, k_h, s_h)
    if w_blk is not None and w_blk < 1:
        raise ValueError(f"w_blk must be >= 1, got {w_blk}")
    if _on_cpu(low, kernel_mat, trace=True):
        return mec_gemm_plain(low, kernel_mat, k_h, s_h)
    core = gemm_core(low.shape, kernel_mat.shape, k_h, s_h, w_blk)
    out_dtype = low.dtype
    low, kernel_mat = _promote(low, kernel_mat)
    low, kernel_mat = low.contiguous(), kernel_mat.contiguous()
    out = torch.empty((i_n, o_h, o_w, k_c), dtype=low.dtype, device=low.device)
    _launch(mec_gemm, "mec_gemm", (low, kernel_mat), out,
            _DTYPE_CODE[low.dtype], i_n, o_w, i_h, kwic, k_h, k_c, s_h, o_h,
            core["oh_blk"], core["w_blk"])
    return out.to(out_dtype)


mec_gemm.launches = 0


# ---------------------------------------------------------------------------
# K6: MEC weight gradient  I, G -> dW (k_h, k_w, i_c, k_c)
# ---------------------------------------------------------------------------

def _wgrad_geometry(inp: torch.Tensor, g: torch.Tensor, k_h: int, k_w: int,
                    stride):
    """(s_h, s_w, o_h, o_w, k_c) of a weight gradient; raises on a
    cotangent that is not the conv's output shape."""
    s_h, s_w = normalize_stride(stride)
    i_n, i_h, i_w, _ = inp.shape
    if not (1 <= k_h <= i_h and 1 <= k_w <= i_w):
        raise ValueError(f"bad kernel {k_h}x{k_w} for input {i_h}x{i_w}")
    o_h, o_w = (i_h - k_h) // s_h + 1, (i_w - k_w) // s_w + 1
    if g.dim() != 4 or tuple(g.shape[:3]) != (i_n, o_h, o_w):
        raise ValueError(f"cotangent {tuple(g.shape)} is not the output "
                         f"({i_n}, {o_h}, {o_w}, k_c)")
    return s_h, s_w, o_h, o_w, g.shape[3]


def mec_weight_grad_plain(inp: torch.Tensor, g: torch.Tensor, k_h: int,
                          k_w: int, stride=1) -> torch.Tensor:
    """dW[r] = the stride-s_h view of the compact L (n, o_w, i_h, k_w,
    i_c) at rows h*s_h + r against the cotangent, one einsum per kernel
    row, in f32 (the MEC VJP's plain form, the JAX package's)."""
    s_h, s_w = normalize_stride(stride)
    low = core_mec.mec_lower(inp, k_w, s_w)     # (n, o_w, i_h, k_w, i_c)
    with obs.span("mec_vjp.dw.rows"):
        low = low.to(torch.float32)
        o_h = g.shape[1]
        g32 = g.to(torch.float32)
        rows = []
        for r in range(k_h):
            # (n, o_w, o_h, k_w, i_c)
            lr = low[:, :, r:r + s_h * (o_h - 1) + 1:s_h]
            rows.append(torch.einsum("nwhjc,nhwo->jco", lr, g32))
    with obs.span("mec_vjp.dw.stack"):
        return torch.stack(rows)           # (k_h, k_w, i_c, k_c)


#: the fields of :func:`wgrad_config`, in the C entry's order
WGRAD_CONFIG_FIELDS = ("cc", "ldc", "jb", "bn", "warps_m", "threads",
                       "smem_bytes", "ctas_per_sm", "splits", "tiles",
                       "workspace", "stages")


def wgrad_config(inp_shape, g_shape, k_h: int, k_w: int, stride=1) -> dict:
    """What K6 runs for this geometry on the current CUDA device, with
    16-byte-aligned operands: the channel chunk ``cc`` and its staged row
    stride ``ldc`` (floats), ``jb`` kernel columns by ``bn`` output
    channels a CTA (``jb * cc`` rows on ``warps_m`` warps), its threads and
    shared memory, the CTAs an SM holds, the ``splits`` of the positions
    over CTAs, the output ``tiles``, the ``workspace`` floats of the split
    partial sums (0 without a split) and the ``stages`` of 64 positions.
    It launches nothing.  Raises :class:`LaunchRefused` where the launcher
    would refuse the geometry, ``RuntimeError`` on any other failure."""
    i_n, i_h, i_w, i_c = inp_shape
    s_h, s_w = normalize_stride(stride)
    o_h, o_w = (i_h - k_h) // s_h + 1, (i_w - k_w) // s_w + 1
    vals = (ctypes.c_longlong * len(WGRAD_CONFIG_FIELDS))()
    lib = _lib()
    rc = lib.mec_wgrad_config(i_n, i_h, i_w, i_c, k_h, k_w, g_shape[3], s_h,
                              s_w, o_h, o_w, vals)
    if rc == _CUDA_ERROR_INVALID_VALUE:
        raise LaunchRefused(f"mec_wgrad_config: configuration refused "
                            f"({lib.mec_error_string(rc).decode()})")
    if rc != 0:
        raise RuntimeError(f"mec_wgrad_config: CUDA error {rc} "
                           f"({lib.mec_error_string(rc).decode()})")
    return dict(zip(WGRAD_CONFIG_FIELDS, vals))


def mec_weight_grad(inp: torch.Tensor, g: torch.Tensor, k_h: int, k_w: int,
                    stride=1) -> torch.Tensor:
    """The MEC conv's kernel gradient: inp (n, i_h, i_w, i_c) pre-padded,
    g (n, o_h, o_w, k_c) the output's cotangent.  Returns dW (k_h, k_w,
    i_c, k_c) in f32.  On CUDA tensors K6 reads the input rows in place
    (the lowering in shared memory, no L); operands not in f32 are cast
    first.  CPU tensors take :func:`mec_weight_grad_plain`."""
    s_h, s_w, o_h, o_w, k_c = _wgrad_geometry(inp, g, k_h, k_w, stride)
    if inp.device.type != "cpu":
        inp, g = inp.to(torch.float32), g.to(torch.float32)
    if _on_cpu(inp, g, trace=True):
        return mec_weight_grad_plain(inp, g, k_h, k_w, (s_h, s_w))
    inp, g = inp.contiguous(), g.contiguous()
    i_n, i_h, i_w, i_c = inp.shape
    out = torch.empty((k_h, k_w, i_c, k_c), dtype=torch.float32,
                      device=inp.device)
    words = 0 if out.device.type == "meta" else wgrad_config(
        inp.shape, g.shape, k_h, k_w, (s_h, s_w))["workspace"]
    ws = torch.empty((words,), dtype=torch.float32, device=inp.device)
    _launch(mec_weight_grad, "mec_wgrad", (inp, g, ws), out, words, i_n, i_h,
            i_w, i_c, k_h, k_w, k_c, s_h, s_w, o_h, o_w)
    return out


mec_weight_grad.launches = 0

#: every kernel wrapper of this module, for resetting and reading counts
KERNELS = (mec_conv_fused, mec_lower, mec_gemm, mec_conv_fused2,
           mec_weight_grad)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
