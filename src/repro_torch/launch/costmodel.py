"""conv2d algorithm choice (counterpart of the conv half of
``repro.launch.costmodel``): the paper's analytic memory overheads
(§3.4, ``core.memory``) with mult-add counts, and the fitted correction
layer (``repro_torch.plan.calibrate``) the planner consults."""
from __future__ import annotations

import math
from typing import Dict

from repro_torch.core import memory


def conv2d_algorithm_costs(spec, calibration=None) -> Dict[str, Dict[str, float]]:
    """Per-eligible-algorithm {flops, overhead_elems} for one ConvSpec.

    With a ``repro_torch.plan.calibrate.Calibration``, each entry also
    carries the fitted view: ``calibrated_overhead_elems`` (Eq. 2-3 scaled
    by the measured/predicted byte ratio), ``measured_us`` (this cell's own
    timed evidence, None without it) and ``time_us_est`` (the fitted Eq.
    2-4 time model, None for unfitted algorithms).  The default (None)
    keeps the paper's uncalibrated constants."""
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
    if calibration is not None:
        cell = calibration.cell_times(spec)
        constants = calibration.time_constants()
        for alg, entry in costs.items():
            entry["calibrated_overhead_elems"] = \
                entry["overhead_elems"] * calibration.mem_ratio_for(alg)
            entry["measured_us"] = cell.get(alg)
            entry["time_us_est"] = calibration.time_estimate(
                spec, alg, constants)
    return costs


def pick_conv2d_algorithm(spec, backend: str = "cuda",
                          calibration="ambient") -> str:
    """Dispatch rule for conv2d(algorithm='auto').

    * 1x1 kernels: lowering is a no-op, direct wins outright.
    * CUDA backend: the fused kernel (no L in device memory at all), as
      the JAX package picks its fused Pallas kernel on the TPU, before any
      calibration is consulted.
    * elsewhere (CPU): MEC whenever its compact L actually saves memory
      over im2col (k_h > s_h row overlap, Eq. 4), else direct.

    calibration: ``"ambient"`` consults the fitted store for ``backend``
    ($REPRO_TORCH_CALIBRATION or the fingerprinted file beside the plan
    cache) when one exists; None forces the paper's constants; or an
    explicit ``Calibration`` (ignored when fitted on another backend).  Two
    corrections apply: the Eq. 4 comparison runs on byte-ratio-scaled
    overheads, and where this exact cell has measured evidence covering
    the analytic pick and at least one rival, the pick defers to the
    measurements through ``pick_measured``'s noise margin.
    """
    if spec.k_h == 1 and spec.k_w == 1:
        return "direct"
    if backend == "cuda":
        return "mec_fused"
    from repro_torch.plan.calibrate import resolve_calibration
    calib = resolve_calibration(calibration, backend)
    costs = conv2d_algorithm_costs(spec, calibration=calib)
    mec_ovh = costs["mec"].get("calibrated_overhead_elems",
                               costs["mec"]["overhead_elems"])
    im2col_ovh = costs["im2col"].get("calibrated_overhead_elems",
                                     costs["im2col"]["overhead_elems"])
    analytic = "mec" if mec_ovh < im2col_ovh else "direct"
    if calib is not None:
        cell = calib.cell_times(spec)
        if analytic in cell and len(cell) >= 2:
            from repro_torch.plan.convplan import pick_measured
            return pick_measured(cell, analytic)
    return analytic
