"""conv2d algorithm choice (counterpart of the conv half of
``repro.launch.costmodel``): the paper's analytic memory overheads
(§3.4, ``core.memory``) with mult-add counts, uncalibrated.  The fitted
calibration layer comes with the planner (ROADMAP Queue 1 item 6)."""
from __future__ import annotations

import math
from typing import Dict

from repro_torch.core import memory


def conv2d_algorithm_costs(spec) -> Dict[str, Dict[str, float]]:
    """Per-eligible-algorithm {flops, overhead_elems} for one ConvSpec."""
    base = memory.conv_flops(spec)
    costs: Dict[str, Dict[str, float]] = {}
    for alg, overhead in memory.ALL_OVERHEADS.items():
        if alg == "winograd" and \
                (spec.k_h, spec.k_w, spec.s_h, spec.s_w) != (3, 3, 1, 1):
            continue
        flops = float(base)
        if alg == "winograd":
            flops = base * 4.0 / 9.0      # F(2x2,3x3): 16 mults per 36
        if alg == "fft":
            hw = spec.i_h * spec.i_w
            planes = spec.i_n * spec.i_c + spec.i_c * spec.k_c \
                + spec.i_n * spec.k_c
            flops = 5.0 * hw * math.log2(max(hw, 2)) * planes \
                + 8.0 * spec.i_n * hw * spec.i_c * spec.k_c
        costs[alg] = {"flops": flops,
                      "overhead_elems": float(overhead(spec))}
    return costs


def pick_conv2d_algorithm(spec, backend: str = "cuda") -> str:
    """Dispatch rule for conv2d(algorithm='auto').

    * 1x1 kernels: lowering is a no-op, direct wins outright.
    * CUDA backend: the fused kernel (no L in device memory at all), as
      the JAX package picks its fused Pallas kernel on the TPU.
    * elsewhere (CPU): MEC whenever its compact L actually saves memory
      over im2col (k_h > s_h row overlap, Eq. 4), else direct.
    """
    if spec.k_h == 1 and spec.k_w == 1:
        return "direct"
    if backend == "cuda":
        return "mec_fused"
    costs = conv2d_algorithm_costs(spec)
    mec_ovh = costs["mec"]["overhead_elems"]
    im2col_ovh = costs["im2col"]["overhead_elems"]
    return "mec" if mec_ovh < im2col_ovh else "direct"
