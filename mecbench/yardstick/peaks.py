"""The NVIDIA H100 SXM's published peaks (data sheet, dense rates without
sparsity, at the 700 W power limit).  Frozen: every roofline share and
MFU of the benchmark is taken against these numbers.
"""
from __future__ import annotations

#: tensor-core FLOP/s by the dtype a product is computed in.  float32
#: products run on the tensor cores as TF32 (three per multiply-add in the
#: port's f32 kernels, but the bound is the single-pass TF32 rate, so no
#: kernel that meets the f32 contract can read above it).
PEAK_FLOPS = {
    "bfloat16": 989e12,
    "float16": 989e12,
    "float32": 495e12,
}
#: HBM3 bytes per second
HBM_BYTES_PER_S = 3.35e12

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card can take for ``flops`` operations in
    ``dtype`` that move ``nbytes`` through HBM: the larger of the two."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
