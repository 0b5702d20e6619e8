"""Analytic cost model (counterpart of ``repro.launch.costmodel``), in two
halves.

The LM half counts a whole train, prefill or decode step of a
``models.config.ModelConfig`` per chip of a :class:`MeshShape`: FLOPs,
device-memory bytes and collective bytes (operand-size convention), and
the model FLOPs (6·N·D) a roofline share divides by.  The formulas are the
JAX package's, in the same order, so the numbers are equal:

* matmul flops = 2*M*N*K; attention runs the full S^2 (the triangular
  kernel, ``attn_skip_masked``, half of it);
* train = fwd + remat-refwd + bwd(2x) = 4x block fwd flops; logits 3x
  (``remat_policy="dots"``: the recompute pass costs 0.15 of a forward
  and no collectives);
* device memory: every weight byte read once a pass, the optimizer reads
  and writes m, v and the master weights (f32), activations cross memory
  ~8x the hidden bytes a block a pass (a calibrated coefficient of the
  JAX package);
* collectives a chip: 2 hidden all-reduces a dense block a pass (1 with
  sequence parallelism, whose RS+AG move half the operand each), the
  expert all-to-alls, one gradient all-reduce over the data axes.

The conv half: the conv2d algorithm choice (the paper's analytic memory
overheads, §3.4 ``core.memory``, with mult-add counts, and the fitted
correction layer ``repro_torch.plan.calibrate`` the planner consults) and
the conv2d partition choice (per-device Eq. 2-3 memory and the bytes the
halo exchange and the cotangent sums send, consulted by
``parallel.conv.sharded_conv2d(partition="auto")`` and the bench ``dist``
suite)."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from repro_torch.core import memory

BF16 = 2
F32 = 4


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


def _attn_flops_fwd(cfg, b, s, s_kv=None, d_in=None) -> float:
    """Projections from ``d_in`` (default d_model) channels, and scores."""
    s_kv = s_kv or s
    hd, h, kv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    d = cfg.d_model
    proj = 2 * b * s * (d_in or d) * hd * (h + 2 * kv) + 2 * b * s * h * hd * d
    # qk^T + av; the triangular kernel (attn_skip_masked) visits only the
    # causal half of the chunk grid
    factor = 2 if getattr(cfg, "attn_skip_masked", False) else 4
    scores = factor * b * h * s * s_kv * hd
    return proj + scores


def _block_flops_fwd(cfg, b, s) -> Dict[str, float]:
    d = cfg.d_model
    out = {"attn": 0.0, "mlp": 0.0, "ssm": 0.0}
    fam = cfg.family
    if fam in ("dense", "vlm", "moe", "audio"):
        out["attn"] = _attn_flops_fwd(cfg, b, s)
        f = cfg.moe_d_ff if fam == "moe" else cfg.d_ff
        mult = cfg.top_k + cfg.n_shared_experts if fam == "moe" else 1
        out["mlp"] = 3 * 2 * b * s * d * f * mult
        if fam == "moe":
            out["mlp"] += 2 * b * s * d * cfg.n_experts     # router
    if fam == "hybrid":
        d_in = cfg.ssm_expand * d
        n = cfg.ssm_state
        gn = cfg.ssm_groups * n                 # B and C, each group's
        h = d_in // cfg.ssm_head_dim
        proj = 2 * b * s * d * (2 * d_in + 2 * gn + h) + 2 * b * s * d_in * d
        conv = 2 * b * s * cfg.conv_width * (d_in + 2 * gn)
        # SSD: intra-chunk quadratic + state updates
        chunk = cfg.ssm_chunk
        ssd = (2 * b * s * chunk * gn           # C B^T within chunk
               + 2 * b * s * chunk * h * cfg.ssm_head_dim
               + 4 * b * s * h * cfg.ssm_head_dim * n)
        out["ssm"] = proj + conv + ssd
    if fam == "ssm":
        d_in = 2 * d
        proj = 2 * b * s * d * 2 * d_in + 3 * 2 * b * s * d_in * d_in \
            + 2 * b * s * d_in * d
        quad = 4 * b * cfg.n_heads * s * s * (d_in // cfg.n_heads)
        out["ssm"] = proj + quad
    return out


def _layer_multiplier(cfg) -> float:
    return cfg.n_layers + (cfg.encoder_layers if cfg.family == "audio" else 0)


def flops_fwd(cfg, b, s) -> float:
    blk = _block_flops_fwd(cfg, b, s)
    per_layer = sum(blk.values())
    total = per_layer * cfg.n_layers
    if cfg.family == "audio":
        enc = _attn_flops_fwd(cfg, b, cfg.encoder_len) + \
            2 * 2 * b * cfg.encoder_len * cfg.d_model * cfg.d_ff
        total += enc * cfg.encoder_layers
        total += _attn_flops_fwd(cfg, b, s, cfg.encoder_len) * cfg.n_layers
    if cfg.family == "hybrid":
        d = cfg.d_model
        published = bool(cfg.hybrid_layer_ids)
        shared = (_attn_flops_fwd(cfg, b, s, d_in=2 * d if published else d)
                  + 3 * 2 * b * s * d * cfg.d_ff)
        if published:
            # the block reads [h, emb]; each hybrid layer's LoRA on the
            # gate-up, and its linear
            shared += (2 * b * s * cfg.adapter_rank * (d + 2 * cfg.d_ff)
                       + 2 * b * s * d * d)
        total += shared * cfg.shared_apps  # shared block applied n_apps times
    return total


def logits_flops(cfg, b, s) -> float:
    return 2 * b * s * cfg.d_model * cfg.vocab


def params_bytes(cfg, dtype_bytes=BF16) -> float:
    return cfg.param_count() * dtype_bytes


# --------------------------------------------------------------------- train
def train_cost(cfg, b: int, s: int, mesh: MeshShape) -> Dict:
    fwd = flops_fwd(cfg, b, s)
    lg = logits_flops(cfg, b, s)
    # remat_policy="dots": matmul outputs are saved, the recompute pass
    # re-runs only elementwise ops (~15% of fwd flops) and NO collectives
    remat = 0.0 if not cfg.remat else \
        (0.15 if cfg.remat_policy == "dots" else 1.0)
    flops = fwd * (3 + remat) + lg * 3
    # HBM: weights (3+remat passes) + optimizer (read m,v,p + write) + acts
    w = params_bytes(cfg) / mesh.chips
    opt = cfg.param_count() * (3 * F32 * 2) / mesh.chips     # m,v,master rw
    act = (8 * _layer_multiplier(cfg) * (b / mesh.dp) * s * cfg.d_model
           * BF16 * (3 + remat))
    # The conv1d's lowered L (k_w x its channels a block) is not charged,
    # as in the JAX package; K5, the fused dataflow, never builds it.
    hbm = w * (3 + remat) + opt + act
    # collectives per chip (operand-size convention)
    hid = (b / mesh.dp) * s * cfg.d_model * BF16
    passes = 2 + (1 if remat == 1.0 else 0)   # dots policy: no refwd colls
    tp_ar = _tp_ars_per_stack(cfg) * hid * passes
    ep = 0.0
    if cfg.family == "moe":
        # int8 dispatch: 1 byte/elem + one bf16 scale per row
        elem = (1 + 2.0 / cfg.d_model) if getattr(
            cfg, "moe_dispatch_int8", False) else BF16
        tok_bytes = (b / mesh.dp) * (s / mesh.model) * cfg.top_k \
            * cfg.d_model * elem * cfg.capacity_factor
        ep = 2 * cfg.n_layers * tok_bytes * passes
    # gradient all-reduce over DP: grads carry the param dtype (bf16);
    # int8-EF compression gathers 1 byte/elem instead (conservative 2x in
    # the operand-bytes convention; the real ring-AR wire saving is ~8x)
    grad_byte = 1 if getattr(cfg, "grad_compress_int8", False) else BF16
    dp_ar = cfg.param_count() / mesh.model * grad_byte if mesh.dp > 1 else 0.0
    coll = tp_ar + ep + dp_ar
    return {"flops": flops, "hbm_bytes_chip": hbm, "coll_bytes_chip": coll,
            "model_flops": 6 * cfg.param_count(active_only=True) * b * s}


def _tp_ars_per_stack(cfg) -> float:
    """Hidden-sized TP all-reduces per forward pass of the whole stack.

    Dense/attention block: 2 (attn out-proj + MLP down-proj row-parallel).
    With sequence-parallel residual segments (cfg.seq_parallel) the pair
    becomes RS+AG at half the operand bytes each -> counts as 1.
    Mamba2 block: 1 (out_proj).  xLSTM: 1 (down).  MoE block: 1 attn AR +
    SP gather/scatter around the a2a (~1).
    """
    sp = 0.5 if getattr(cfg, "seq_parallel", False) else 1.0
    if cfg.family in ("dense", "vlm"):
        return 2 * cfg.n_layers * sp
    if cfg.family == "moe":
        return (1 + 1) * cfg.n_layers * sp
    if cfg.family == "hybrid":
        return (1 * cfg.n_layers + 2 * cfg.shared_apps) * sp
    if cfg.family == "ssm":
        return 1 * cfg.n_layers
    if cfg.family == "audio":
        return 2 * (cfg.n_layers + cfg.encoder_layers) + cfg.n_layers
    return 2 * cfg.n_layers


# ------------------------------------------------------------------- prefill
def prefill_cost(cfg, b, s, mesh: MeshShape) -> Dict:
    fwd = flops_fwd(cfg, b, s)
    flops = fwd + 2 * b * cfg.d_model * cfg.vocab   # last-token logits
    w = params_bytes(cfg) / mesh.chips
    act = 8 * _layer_multiplier(cfg) * (b / mesh.dp) * s * cfg.d_model * BF16
    cache = (_layer_multiplier(cfg) * (b / mesh.dp) * s * 2
             * cfg.n_kv_heads * cfg.head_dim * BF16)
    hbm = w + act + cache
    hid = (b / mesh.dp) * s * cfg.d_model * BF16
    tp_ar = _tp_ars_per_stack(cfg) * hid
    ep = 0.0
    if cfg.family == "moe":
        ep = 2 * cfg.n_layers * (b / mesh.dp) * (s / mesh.model) \
            * cfg.top_k * cfg.d_model * BF16 * cfg.capacity_factor
    return {"flops": flops, "hbm_bytes_chip": hbm, "coll_bytes_chip": tp_ar + ep,
            "model_flops": 2 * cfg.param_count(active_only=True) * b * s}


# -------------------------------------------------------------------- decode
def decode_cost(cfg, b: int, s_cache: int, mesh: MeshShape) -> Dict:
    n_act = cfg.param_count(active_only=True)
    flops = 2 * n_act * b
    kv_layers = (cfg.n_layers if cfg.family in ("dense", "vlm", "moe", "audio")
                 else cfg.shared_apps if cfg.family == "hybrid" else 0)
    kv_elem = ((1 + 2.0 / cfg.head_dim)
               if getattr(cfg, "kv_cache_int8", False) else BF16)
    cache_bytes = (kv_layers * b * s_cache * 2 * cfg.n_kv_heads
                   * cfg.head_dim * kv_elem)
    flops += 2 * kv_layers * b * cfg.n_heads * s_cache * cfg.head_dim * 2
    # every live weight byte + the whole cache cross HBM once per token
    hbm = params_bytes(cfg) / mesh.chips + cache_bytes / mesh.chips
    if cfg.family == "moe":
        # only routed experts' weights are touched per token batch
        live = (cfg.param_count(active_only=True)
                + 3 * cfg.d_model * cfg.moe_d_ff
                * min(cfg.n_experts, b * cfg.top_k)) * BF16
        hbm = live / mesh.chips + cache_bytes / mesh.chips
    hid = max(b / mesh.dp, 1) * cfg.d_model * BF16
    tp_ar = _tp_ars_per_stack(cfg) * hid
    logits_ag = max(b / mesh.dp, 1) * cfg.vocab / mesh.model * F32
    return {"flops": flops,
            "hbm_bytes_chip": hbm,
            "coll_bytes_chip": tp_ar + logits_ag,
            "model_flops": 2 * n_act * b}


def cell_cost(cfg, kind: str, b: int, s: int, mesh: MeshShape) -> Dict:
    if kind == "train":
        return train_cost(cfg, b, s, mesh)
    if kind == "prefill":
        return prefill_cost(cfg, b, s, mesh)
    return decode_cost(cfg, b, s, mesh)


# ----------------------------------------------------- conv2d algorithm choice

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
