"""MEC: Memory-efficient Convolution (Cho & Brand, ICML 2017) — eager torch.

Counterpart of ``repro.core.mec``: Algorithm 1 (VanillaMEC) and
Algorithm 2 (MEC with channels/mini-batch and Solutions A/B).  The
lowered tensor ``L (i_n, o_w, i_h, k_w, i_c)`` is materialized exactly as
in the paper (Eq. 3) and the o_h output rows are produced by *shifted*
reads of L at stride ``s_h * k_w * i_c`` (the BLAS ld-aliasing trick: each
window is a slice view of L, so no im2col-sized intermediate exists).

The hand-written CUDA kernels in ``repro_torch.kernels`` implement the
same algorithm on the GPU; this module is the algorithmic reference.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.convspec import normalize_stride, spec_of
from repro_torch.core.direct import accum_dtype

# Paper §3.3: platform-dependent threshold T for choosing Solution A vs B.
# ("we found T around 100 to be a good threshold for latest GPUs")
SOLUTION_T = 100

SOLUTIONS = ("A", "B", "auto")


def pick_solution(spec, threshold: int = SOLUTION_T) -> str:
    """Algorithm 2 line 8: Solution A iff o_w <= T and |O| <= |L|."""
    size_o = spec.i_n * spec.o_h * spec.o_w * spec.k_c
    size_l = spec.i_n * spec.o_w * spec.i_h * spec.k_w * spec.i_c
    return "A" if (spec.o_w <= threshold and size_o <= size_l) else "B"


def mec_lower(inp: torch.Tensor, k_w: int, s_w: int) -> torch.Tensor:
    """Compact lowering, Algorithm 2 lines 4-6.

    inp: (i_n, i_h, i_w, i_c)  ->  L: (i_n, o_w, i_h, k_w, i_c)
    L[n, w, h, :, :] = I[n, h, s_w*w : s_w*w + k_w, :]
    """
    # unfold: (i_n, i_h, o_w, i_c, k_w) -> (i_n, o_w, i_h, k_w, i_c)
    with obs.span("mec.lower"):
        return inp.unfold(2, k_w, s_w).permute(0, 2, 1, 4, 3).contiguous()


def _shifted_rows(l_mat: torch.Tensor, kernel_mat: torch.Tensor,
                  row_stride: int, window: int, rows: torch.Tensor) -> None:
    """rows[h] = L[..., h*row_stride : +window] @ K for every h, each
    row accumulated in f32 and narrowed to L's dtype (paper's o_h GEMMs
    over overlapping sub-matrix views).  ``rows`` is a view of the output
    whose leading axis is h: the GEMM writes a contiguous row (batch 1)
    in L's own dtype in place; any other row's product, one row-sized
    temporary, is copied into it.  Nothing output-sized is allocated
    besides the output itself.
    """
    acc = accum_dtype(l_mat.dtype)
    k32 = kernel_mat.to(acc)
    for h in range(rows.shape[0]):
        win = l_mat[..., h * row_stride:h * row_stride + window]
        if acc == l_mat.dtype and rows[h].is_contiguous():
            torch.matmul(win, k32, out=rows[h].view(*win.shape[:-1],
                                                     k32.shape[1]))
        else:
            prod = torch.matmul(win.to(acc), k32).to(l_mat.dtype)
            rows[h].copy_(prod.view(rows.shape[1:]))


def mec_conv2d(inp: torch.Tensor, kernel: torch.Tensor, stride=1,
               solution: str = "auto",
               threshold: int = SOLUTION_T) -> torch.Tensor:
    """O = I * K via MEC (Algorithm 2).

    inp: (i_n, i_h, i_w, i_c) pre-padded; kernel: (k_h, k_w, i_c, k_c).
    solution: 'A' | 'B' | 'auto' (paper line 8: A iff o_w <= T and |O| <= |L|).
    Returns (i_n, o_h, o_w, k_c) in n-h-w-c.
    """
    spec = spec_of(inp, kernel, stride)
    i_n, i_h, i_c = spec.i_n, spec.i_h, spec.i_c
    k_h, k_w, k_c = spec.k_h, spec.k_w, spec.k_c
    o_h, o_w = spec.o_h, spec.o_w

    if solution == "auto":
        solution = pick_solution(spec, threshold)
    if solution not in ("A", "B"):
        raise ValueError(f"unknown solution {solution!r}")

    low = mec_lower(inp, k_w, spec.s_w)  # (i_n, o_w, i_h, k_w, i_c)
    with obs.span("mec.rows"):
        kernel_mat = kernel.reshape(k_h * k_w * i_c, k_c).to(low.dtype)
        row_stride = spec.s_h * k_w * i_c
        window = k_h * k_w * i_c

        # The output, written in n-h-w-c; ``rows`` walks it row by row.
        out = torch.empty((i_n, o_h, o_w, k_c), dtype=low.dtype,
                          device=low.device)
        rows = out.permute(1, 0, 2, 3)         # (o_h, i_n, o_w, k_c)
        if solution == "A":
            # Lines 9-19: one GEMM per output row over the whole
            # mini-batch; the h-n-w-c intermediate (line 13) is the
            # output's h-major view.
            l_mat = low.reshape(i_n * o_w, i_h * k_w * i_c)
        else:
            # Lines 21-25: per-sample GEMMs.
            l_mat = low.reshape(i_n, o_w, i_h * k_w * i_c)
        _shifted_rows(l_mat, kernel_mat, row_stride, window, rows)
    return out


def vanilla_mec(inp: torch.Tensor, kernel: torch.Tensor,
                stride=1) -> torch.Tensor:
    """Algorithm 1: single channel, single sample.

    inp: (i_h, i_w); kernel: (k_h, k_w).  Returns (o_h, o_w).
    """
    i_h, _ = inp.shape
    k_h, k_w = kernel.shape
    s_h, s_w = normalize_stride(stride)
    o_h = (i_h - k_h) // s_h + 1

    # Lines 4-6: L[w, h, 0:k_w] = I[h, s_w*w : s_w*w + k_w]
    low = inp.unfold(1, k_w, s_w).permute(1, 0, 2)   # (o_w, i_h, k_w)
    l_mat = low.reshape(low.shape[0], i_h * k_w)
    kernel_mat = kernel.reshape(k_h * k_w, 1)

    # Lines 10-12: O[h] = L[0:o_w, s_h*k_w*h : +k_h*k_w] x K
    out = inp.new_empty((o_h, low.shape[0]))
    for h in range(o_h):
        out[h] = (l_mat[:, h * s_h * k_w:h * s_h * k_w + k_h * k_w]
                  @ kernel_mat)[:, 0]
    return out


def mec_conv1d_shift(inp: torch.Tensor, kernel: torch.Tensor,
                     causal: bool = True) -> torch.Tensor:
    """Fused-dataflow depthwise conv1d: k_w shifted scaled adds, no lowered
    tensor at all (what the fused conv1d kernel does on chip).

    inp (n, t, c), kernel (k_w, c).  out[n, s, c] = sum_j xp[n, s + j, c] *
    kernel[j, c], with xp the input left-padded by k_w - 1 zeros when
    causal; summed in f32 over j = 0 .. k_w - 1 in that order, one cast to
    the input dtype.  Without the causal pad the shifted slices are shorter
    than t for k_w > 1, and the call raises, as the JAX function does.
    """
    n, t, c = inp.shape
    k_w, kc = kernel.shape
    if kc != c:
        raise ValueError(f"kernel {tuple(kernel.shape)} does not match input "
                         f"{tuple(inp.shape)}")
    pad = k_w - 1 if causal else 0
    xp = torch.nn.functional.pad(inp, (0, 0, pad, 0)) if pad else inp
    if xp.shape[1] < t + k_w - 1:
        raise ValueError(f"non-causal shift conv1d needs k_w = 1, got {k_w}")
    acc = torch.zeros((n, t, c), dtype=torch.float32, device=inp.device)
    for j in range(k_w):
        acc = acc + xp[:, j:j + t, :].to(torch.float32) * kernel[j]
    return acc.to(inp.dtype)


def mec_conv1d_depthwise(inp: torch.Tensor, kernel: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Depthwise conv1d via the MEC column-strip lowering.

    inp (n, t, c), kernel (k_w, c).  In 1-D the compact L coincides with
    im2col (Eq. 4 with i_h == k_h == 1); this form materializes it, as the
    JAX function does: L holds n * t * k_w * c elements, built straight
    from the input (no padded copy), with the k_w taps innermost so that
    the contraction over them is one batched GEMM per channel over a view
    of L.  L[n, s, :, j] is the input at step s - (k_w - 1) + j, zero
    before step 0 when causal; without the causal pad, steps past the end
    repeat the last one (the JAX gather clamps its indices).  The product
    is the input dtype's GEMM (f32 accumulation), as the JAX einsum.
    """
    n, t, c = inp.shape
    k_w, kc = kernel.shape
    if kc != c:
        raise ValueError(f"kernel {tuple(kernel.shape)} does not match input "
                         f"{tuple(inp.shape)}")
    low = torch.zeros((n, t, c, k_w), dtype=inp.dtype, device=inp.device)
    for j in range(k_w):
        if causal:
            shift = k_w - 1 - j                 # L[:, s, :, j] = x[s - shift]
            if shift < t:
                low[:, shift:, :, j] = inp[:, :t - shift]
        else:                                   # L[:, s, :, j] = x[min(s+j, t-1)]
            low[:, :max(t - j, 0), :, j] = inp[:, j:]
            low[:, max(t - j, 0):, :, j] = inp[:, t - 1:]
    # (c, n*t, k_w) @ (c, k_w, 1): a view of L, no copy.
    out = torch.bmm(low.permute(2, 0, 1, 3).reshape(c, n * t, k_w),
                    kernel.to(inp.dtype).t().unsqueeze(-1))
    return out.reshape(c, n, t).permute(1, 2, 0)
