"""Public entry points for the MEC CUDA kernels (counterpart of
``repro.kernels.ops``) and the H100 block pickers."""
from __future__ import annotations

import torch

from repro_torch.core.convspec import normalize_stride
from repro_torch.kernels import mec_conv
from repro_torch.kernels.mec_conv import (mec_conv_fused, mec_conv_fused2,
                                          mec_gemm, mec_lower)
from repro_torch.kernels.mec_conv1d import mec_conv1d

#: H100 SXM: streaming multiprocessors
N_SMS = 132
#: output channels per CTA (csrc/mec_mma.cuh kBN)
CTA_CHANNELS = 64
#: K1/K3/K4: output positions of the largest MMA tile (mec_mma.cuh kMaxBM);
#: K4's launcher caps its sub-tile at this many (rows x columns)
CTA_POSITIONS = 128
#: K4: output rows per CTA sub-tile, the launcher's kFused2MaxRows
CTA_ROWS = 16
#: K1/K4: positions of the smallest MMA tile (one m16 tile)
MIN_POSITIONS = 16
#: K1: the picker halves a block only down to two m16 tiles
MIN_FUSED_COLUMNS = 32
#: K1/K4: the most CTAs of a cluster that split one tile's reduction
MAX_SPLIT = 4


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def pick_fused_w_blk(o_w: int, k_c: int, i_n: int, o_h: int) -> int:
    """Output columns per CTA for the tensor-core kernels K1 and K4 on the
    H100 (K3 takes it on its transposed geometry, where the columns are
    output rows h: ``mec_conv.gemm_core``).

    A K1 CTA computes one output row x ``w_blk`` columns x 64 channels on
    the tensor cores, in MMA tiles of 16, 32, 64 or 128 positions, with
    its f32 accumulators in registers.  Every CTA stages the kernel slab
    of its 64 channels for each of its steps from L2, whatever its tile,
    so L2 traffic falls as the tile grows: the block is the largest MMA
    tile (128 columns, never wider than o_w).  Parallelism comes next: the
    block is halved, down to 32 columns (two m16 tiles), only while even a
    cluster split of 4 (the launcher's, which fills SMs without narrowing
    the tile) leaves the grid (n * o_h * ceil(o_w / w_blk) * ceil(k_c /
    64) CTAs) short of one CTA per SM.
    """
    blk = max(1, min(o_w, CTA_POSITIONS))
    others = i_n * o_h * _ceil_div(k_c, CTA_CHANNELS)
    while (blk > MIN_FUSED_COLUMNS
           and MAX_SPLIT * others * _ceil_div(o_w, blk) < N_SMS):
        blk = max(MIN_FUSED_COLUMNS, _ceil_div(blk, 2))
    return blk


def pick_oh_blk(o_h: int, o_w: int, w_blk: int, k_c: int, i_n: int) -> int:
    """Output rows per CTA for the K4 kernel on the H100, given its
    ``w_blk`` output columns (from :func:`pick_fused_w_blk`).  K3 takes it
    on its transposed geometry, where the rows are output columns w
    (``mec_conv.gemm_core``).

    A K4 CTA computes a sub-tile of at most 128 output positions (rows x
    columns, the largest MMA tile) by 64 channels on the tensor cores;
    every step stages, for each row of the sub-tile, the input row it
    needs, and one kernel slab that all of them share.  So the block
    takes as many rows as fill 128 positions with ``w_blk`` columns (at
    most 16 rows): narrow layers (cv11: 12 columns, cv12: 5) fill the MMA
    tile that one output row leaves mostly empty, and the kernel slab is
    staged once for all of them.  Then parallelism: the rows are halved
    only while even a cluster split of 4 leaves the grid (n * ceil(o_h /
    oh_blk) * ceil(o_w / w_blk) * ceil(k_c / 64) CTAs) short of one CTA
    per SM, as long as the block keeps one m16 tile (16 positions).
    """
    w_blk = max(1, min(w_blk, o_w))
    blk = max(1, min(o_h, CTA_POSITIONS // w_blk, CTA_ROWS))
    others = i_n * _ceil_div(o_w, w_blk) * _ceil_div(k_c, CTA_CHANNELS)
    while (MAX_SPLIT * others * _ceil_div(o_h, blk) < N_SMS
           and _ceil_div(blk, 2) * w_blk >= MIN_POSITIONS and blk > 1):
        blk = _ceil_div(blk, 2)
    return blk


def _geometry(inp_shape, kernel_shape, stride):
    """(i_n, i_h, i_w, i_c, k_h, k_w, k_c, s_h, s_w, o_h, o_w)."""
    i_n, i_h, i_w, i_c = inp_shape
    k_h, k_w, _, k_c = kernel_shape
    s_h, s_w = normalize_stride(stride)
    return (i_n, i_h, i_w, i_c, k_h, k_w, k_c, s_h, s_w,
            (i_h - k_h) // s_h + 1, (i_w - k_w) // s_w + 1)


def default_w_blk(mode: str, inp_shape, kernel_shape, stride=1) -> int:
    """The block :func:`mec_conv2d_cuda` runs when given none: output
    columns per CTA, :func:`pick_fused_w_blk` for K1 (``mode="fused"``)
    and K4 (``"fused2"``), K3's own pick on its transposed geometry
    (``mec_conv.gemm_core``) for ``"lowered"``."""
    i_n, i_h, _, i_c, k_h, k_w, k_c, s_h, _, o_h, o_w = _geometry(
        inp_shape, kernel_shape, stride)
    if mode == "lowered":
        kwic = k_w * i_c
        return mec_conv.gemm_core((i_n, o_w, i_h, kwic), (k_h, kwic, k_c),
                                  k_h, s_h)["oh_blk"]
    if mode not in ("fused", "fused2"):
        raise ValueError(f"unknown mode {mode!r}")
    return pick_fused_w_blk(o_w, k_c, i_n, o_h)


def launch_config(mode: str, dtype: torch.dtype, inp_shape, kernel_shape,
                  stride=1, w_blk: int | None = None) -> dict:
    """What :func:`mec_conv2d_cuda` would launch for this geometry on the
    current CUDA device (``mec_conv.fused_config``'s fields for K1, K4 or
    K3), ``w_blk`` None for :func:`default_w_blk`; it launches nothing.
    Raises ``mec_conv.LaunchRefused`` where the launcher would refuse the
    configuration."""
    i_n, i_h, _, i_c, k_h, k_w, k_c, s_h, s_w, o_h, o_w = _geometry(
        inp_shape, kernel_shape, stride)
    if w_blk is None:
        w_blk = default_w_blk(mode, inp_shape, kernel_shape, stride)
    if mode == "lowered":
        kwic = k_w * i_c
        return mec_conv.gemm_config(dtype, (i_n, o_w, i_h, kwic),
                                    (k_h, kwic, k_c), k_h, s_h, w_blk)
    oh_blk = pick_oh_blk(o_h, o_w, w_blk, k_c, i_n)
    return mec_conv.fused_config(1 if mode == "fused" else 4, dtype,
                                 inp_shape, kernel_shape, (s_h, s_w), w_blk,
                                 oh_blk)


def mec_conv2d_cuda(inp: torch.Tensor, kernel: torch.Tensor, stride=1,
                    mode: str = "fused", w_blk: int | None = None
                    ) -> torch.Tensor:
    """MEC convolution with the hand-written kernels.

    mode='lowered' is the paper-faithful path (K2 builds L in device
    memory, Eq. 3 memory observable; K3 runs the shifted GEMMs); mode=
    'fused' is K1, the lowering fused into the GEMM; mode='fused2' is K4,
    the fused conv h-blocked over oh_blk output rows per CTA.  w_blk is
    output columns per CTA; when None, :func:`default_w_blk`; K4's output
    rows per CTA come from :func:`pick_oh_blk`.  CPU tensors run the
    kernels' plain versions.  Operands of two dtypes are promoted by the
    kernels' wrappers, and the output is in the input's dtype.
    """
    s_h, s_w = normalize_stride(stride)
    i_n, _, _, i_c, k_h, k_w, k_c, _, _, o_h, o_w = _geometry(
        inp.shape, kernel.shape, stride)
    if w_blk is None:
        w_blk = default_w_blk(mode, inp.shape, kernel.shape, stride)
    elif not 1 <= w_blk <= max(o_w, 1):
        raise ValueError(f"w_blk must be in [1, o_w={o_w}], got {w_blk}")
    if mode == "fused":
        return mec_conv_fused(inp, kernel, (s_h, s_w), w_blk=w_blk)
    if mode == "fused2":
        oh_blk = pick_oh_blk(o_h, o_w, w_blk, k_c, i_n)
        return mec_conv_fused2(inp, kernel, (s_h, s_w), w_blk=w_blk,
                               oh_blk=oh_blk)
    if mode == "lowered":
        low = mec_lower(inp, k_w, s_w)
        return mec_gemm(low, kernel.reshape(k_h, k_w * i_c, k_c), k_h, s_h,
                        w_blk=w_blk)
    raise ValueError(f"unknown mode {mode!r}")


def mec_conv1d_cuda(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Fused causal depthwise conv1d (Mamba2 / xLSTM blocks): K5 on CUDA
    tensors, its plain version on CPU tensors."""
    return mec_conv1d(x, kernel)
