"""The conv half of ``repro.launch.costmodel``: the conv2d algorithm
choice (the paper's analytic memory overheads, §3.4 ``core.memory``, with
mult-add counts, and the fitted correction layer
``repro_torch.plan.calibrate`` the planner consults) and the conv2d
partition choice (per-device Eq. 2-3 memory and the bytes the halo
exchange and the cotangent sums send, consulted by
``parallel.conv.sharded_conv2d(partition="auto")`` and the bench ``dist``
suite).  The LM-cost half waits (ROADMAP Queue 1 item 11)."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from repro_torch.core import memory


@dataclasses.dataclass(frozen=True)
class MeshShape:
    pod: int = 1
    data: int = 16
    model: int = 16

    @property
    def chips(self) -> int:
        return self.pod * self.data * self.model

    @property
    def dp(self) -> int:
        return self.pod * self.data


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


# ------------------------------------------------- conv2d partition choice
# Per-device terms follow the paper's Eq. 2-4 memory model applied to the
# *local* geometry each rank sees, plus the bytes that cross the wire
# (halo exchange forward, cotangent sums backward).

def _halo_rows(spec) -> int:
    # The executor's halo protocol owns this formula, so the gated
    # analytic halo bytes are the bytes the exchange sends.
    from repro_torch.parallel.conv import spatial_halo_rows
    return spatial_halo_rows(spec.k_h, spec.s_h)


def conv_partition_costs(spec, n_dev, dtype_bytes: int = 4,
                         calibration=None) -> Dict:
    """Per-partition per-device cost terms for an ``n_dev``-way split.

    ``n_dev`` as an int evaluates the three 1-D modes (keys ``"batch"``/
    ``"channel"``/``"spatial"``); a ``(n0, n1)`` tuple evaluates the
    composites (keys from ``parallel.conv.COMPOSITE_PARTITIONS``, component
    ``i`` split ``n_dev[i]``-ways).  Every mode is reported, ``viable``
    flagging whether the geometry divides:

    * ``per_device_overhead_elems``: MEC's compact L (Eq. 3) on the local
      geometry (``channel`` does not shrink L: it splits only the kernel
      and the output);
    * ``per_device_im2col_elems``: Eq. 2 on the same local geometry;
    * ``halo_bytes_per_device``: the spatial halo, ``k_h - s_h`` input
      rows of the local batch shard (0 without a spatial component);
    * ``comm_bytes_fwd/bwd_per_device``: spatial pays the halo each way,
      batch sums the kernel cotangent, channel the input cotangent;
      composites add their components' terms, each summed operand at the
      size the other component leaves local;
    * ``flops_per_device``.

    A ``repro_torch.plan.calibrate.Calibration`` scales the two memory
    predictions by the memaudit-fitted byte ratios; None keeps the gated
    analytic fields deterministic.
    """
    from repro_torch.parallel.conv import COMPOSITE_PARTITIONS

    halo = _halo_rows(spec)
    mec_ratio = 1.0 if calibration is None \
        else calibration.mem_ratio_for("mec")
    im2col_ratio = 1.0 if calibration is None \
        else calibration.mem_ratio_for("im2col")

    def ceil_div(a, b):
        return -(-a // b)

    def one_mode(parts, sizes):
        by = dict(zip(parts, sizes))
        n_b, n_s, n_c = by.get("batch", 1), by.get("spatial", 1), \
            by.get("channel", 1)
        i_n_loc = max(1, ceil_div(spec.i_n, n_b))
        k_c_loc = max(1, ceil_div(spec.k_c, n_c))
        lspec = dataclasses.replace(
            spec, i_n=i_n_loc,
            i_h=min(spec.i_h, ceil_div(spec.i_h, n_s) + halo),
            k_c=k_c_loc)
        halo_bytes = (i_n_loc * halo * spec.i_w * spec.i_c * dtype_bytes
                      if "spatial" in by else 0)
        fwd = halo_bytes
        bwd = halo_bytes
        if "batch" in by or "spatial" in by:
            # kernel cotangent summed over the input-splitting axes; the
            # operand is the (possibly channel-split) local kernel.
            bwd += spec.k_h * spec.k_w * spec.i_c * k_c_loc * dtype_bytes
        if "channel" in by:
            # input cotangent summed over the channel axis; the operand is
            # the (possibly batch/row-split) local input.
            bwd += i_n_loc * ceil_div(spec.i_h, max(n_s, 1)) \
                * spec.i_w * spec.i_c * dtype_bytes
        n_total = math.prod(max(n, 1) for n in sizes)
        return {
            "viable": bool(min(sizes) > 0
                           and _viable(spec, parts if len(parts) > 1
                                       else parts[0],
                                       tuple(sizes) if len(parts) > 1
                                       else sizes[0])),
            "n_dev": int(n_total),
            "n_dev_axes": [int(n) for n in sizes],
            "per_device_overhead_elems":
                float(memory.mec_overhead(lspec)) * mec_ratio,
            "per_device_im2col_elems":
                float(memory.im2col_overhead(lspec)) * im2col_ratio,
            "halo_bytes_per_device": float(halo_bytes),
            "comm_bytes_fwd_per_device": float(fwd),
            "comm_bytes_bwd_per_device": float(bwd),
            "flops_per_device": float(memory.conv_flops(spec) / n_total),
        }

    out: Dict = {}
    if isinstance(n_dev, int):
        for part in ("batch", "channel", "spatial"):
            out[part] = one_mode((part,), (n_dev,))
    else:
        sizes = tuple(int(n) for n in n_dev)
        if len(sizes) != 2:
            raise ValueError(f"composite n_dev must be a 2-tuple, got "
                             f"{n_dev!r}")
        for comp in COMPOSITE_PARTITIONS:
            out[comp] = one_mode(comp, sizes)
    return out


def _viable(spec, partition, n_dev) -> bool:
    from repro_torch.parallel.conv import partition_viable
    return partition_viable(spec, partition, n_dev)


def pick_conv_partition(spec, axis_sizes: Dict,
                        dtype_bytes: int = 4, calibration=None):
    """Cheapest viable partition for ``sharded_conv2d(partition='auto')``.

    axis_sizes maps a candidate (a partition name, or a composite tuple
    from ``parallel.conv.COMPOSITE_PARTITIONS``) to the size of the mesh
    axis (axes tuple, for composites) it would run over.  Returns the
    winning key, or None when no mode splits the geometry over more than
    one device.  Ranking: fewest fwd+bwd wire bytes per device; ties go to
    the lowest calibrated per-device Eq. 3 overhead when a calibration is
    given, then to ``batch``, ``spatial``, ``channel``, then to 1-D modes
    over composites.
    """
    from repro_torch.parallel.conv import COMPOSITE_PARTITIONS, PARTITIONS
    order = ("batch", "spatial", "channel") + COMPOSITE_PARTITIONS
    unknown = [k for k in axis_sizes
               if k not in PARTITIONS + COMPOSITE_PARTITIONS]
    if unknown:
        raise ValueError(
            f"unknown partition candidate(s) {unknown!r}; expected keys "
            f"from {PARTITIONS + COMPOSITE_PARTITIONS}")
    best, best_cost = None, None
    for part in order:
        n = axis_sizes.get(part)
        if n is None:
            continue
        if isinstance(part, str):
            if isinstance(n, (tuple, list)):
                raise ValueError(f"candidate {part!r} takes one axis "
                                 f"size, got {n!r}")
            n = int(n)
            if n <= 1 or not _viable(spec, part, n):
                continue
        else:
            if not isinstance(n, (tuple, list)) or len(n) != len(part):
                raise ValueError(f"candidate {part!r} takes {len(part)} "
                                 f"axis sizes, got {n!r}")
            n = tuple(int(v) for v in n)
            # A composite with a 1-way sub-axis is just its other
            # component, which is enumerated separately.
            if min(n) <= 1 or not _viable(spec, part, n):
                continue
        c = conv_partition_costs(spec, n, dtype_bytes,
                                 calibration=calibration)[part]
        cost = (c["comm_bytes_fwd_per_device"]
                + c["comm_bytes_bwd_per_device"],
                c["per_device_overhead_elems"] if calibration is not None
                else 0.0)
        if best_cost is None or cost < best_cost:
            best, best_cost = part, cost
    return best
