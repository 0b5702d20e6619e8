"""Hand-written CUDA kernels for MEC convolution on Hopper.

csrc/mec_conv.cu   — K1 fused conv, K2 compact lowering, K3 shifted GEMM,
                     K4 h-blocked fused conv
csrc/mec_wgrad.cu  — K6 MEC weight gradient (in mec_conv's library)
csrc/mec_conv1d.cu — K5 causal depthwise conv1d
build.py           — nvcc build on first use, ctypes loading
mec_conv.py        — one wrapper per conv2d kernel (K6: the conv's weight
                     gradient), its plain version, launch counts
mec_conv1d.py      — the K5 wrapper, its plain version, its launch count
ops.py             — mec_conv2d_cuda and mec_conv1d_cuda entry points and
                     the H100 block pickers
ref.py             — plain oracles
"""
from repro_torch.kernels.ops import mec_conv1d_cuda, mec_conv2d_cuda

__all__ = ["mec_conv1d_cuda", "mec_conv2d_cuda"]
