"""Hand-written CUDA kernels for MEC convolution on Hopper.

csrc/mec_conv.cu — K1 fused conv, K2 compact lowering, K3 shifted GEMM,
                   K4 h-blocked fused conv
build.py         — nvcc build on first use, ctypes loading
mec_conv.py      — one wrapper per kernel, its plain version, launch counts
ops.py           — mec_conv2d_cuda entry point and the H100 block picker
ref.py           — plain oracles
"""
from repro_torch.kernels.ops import mec_conv2d_cuda

__all__ = ["mec_conv2d_cuda"]
