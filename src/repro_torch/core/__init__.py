"""Core MEC algorithm, the baselines it is compared against, and the
``conv2d`` front-end that dispatches among them."""
from repro_torch.core.conv_api import (ALGORITHMS, MEC_ALGORITHMS, conv2d,
                                       conv2d_spec)
from repro_torch.core.convspec import ConvSpec, pad_same, spec_of
from repro_torch.core.direct import direct_conv2d
from repro_torch.core.im2col import im2col_conv2d, im2col_lower
from repro_torch.core.mec import mec_conv2d, mec_lower, vanilla_mec

__all__ = [
    "ALGORITHMS", "MEC_ALGORITHMS", "conv2d", "conv2d_spec",
    "ConvSpec", "pad_same", "spec_of",
    "mec_conv2d", "mec_lower", "vanilla_mec",
    "im2col_conv2d", "im2col_lower", "direct_conv2d",
]
