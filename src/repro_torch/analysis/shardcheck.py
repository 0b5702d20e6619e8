"""The collective contract of a partitioned conv, and its precision flow
(counterpart of ``repro.analysis.shardcheck``).

A partitioned convolution promises a predictable wire: the cost model
(``launch.costmodel.conv_partition_costs``) states which bytes cross it.
The spatial halo rides point-to-point sends (``collective-permute``), the
cotangent sums ride ``all-reduce``, and nothing else moves.
:func:`check_sharding` holds the port to that promise on real ranks.  It
runs ``parallel.conv.sharded_conv2d`` forward, then the gradient of a
``sum(out^2)`` probe, on the ranks of a mesh.  Each pass's collectives are
counted by ``launch.hlo_analysis.collective_bytes``, every rank's counts
are recorded, and the busiest rank's bytes per kind are compared with the
contract.  Under a declared precision the precision-flow pass
(``analysis.numcheck``) runs over the rank's body, traced on meta
tensors; with nothing declared it is trivially clean (the JAX package's
rule) and nothing is traced.

The contract is derived, never written per call site.
:func:`expected_collectives` is the JAX package's contract for GSPMD, the
same function of the cost model.  :func:`rank_contract` is the port's:
it differs from GSPMD's execution in two places, and names both.

* Each rank returns whole tensors, so the output leaves through an
  all-gather, and a split operand's gradient comes back the same way.
  Both are priced exactly by :func:`structural_gathers`.
* The port trims the spatial output locally after that gather, so there
  is no trim permute (:func:`trim_reshard` prices GSPMD's) and no
  direction is unmodelled.

Each rank sends its first halo rows to the rank before it forward, and
their cotangent to the rank after it backward.  So the busiest rank sends
one halo a pass, two over the gradient program when a middle rank exists
(three or more spatial ranks) and one with two: :func:`halo_sends`.

Every kind is exact.  The only slack is the JAX package's own: optional
bytes (with ``replicated_ways > 1``, the free-axis gradient combine), the
64-byte scalar allowance on the gradient all-reduces, and f32 width for
sub-f32 dtypes.

:func:`check_sharding` is collective.  Every rank of the world calls it
with the same arguments: it builds the cell's mesh over the first ranks,
and every rank takes part in gathering the counts.

Plans are duck-typed (``spec``/``dtype``/``algorithm``/``solution``/
``precision``/``partition``/``partition_axes``/``backend``): this module
never imports ``repro_torch.plan``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.numcheck import (ContractViolation,
                                           precision_flow_findings)
from repro_torch.launch.hlo_analysis import COLLECTIVE_KINDS

DIRECTIONS = ("fwd", "grad")

#: the grad all-reduce may exceed the predicted cotangent sums by this
#: much: the JAX package's probe loss adds one scalar partial-sum
#: reduction (the port's ranks hold the whole output and add none)
SCALAR_REDUCE_ALLOWANCE_BYTES = 64


class ShardCheckError(AssertionError):
    """A partitioned cell broke its collective or precision contract."""


@dataclasses.dataclass
class ShardCheck:
    """Verdict of one partitioned cell.

    ``record`` is the JSON-able evidence (expected, optional and observed
    bytes a direction, every rank's counts, the precision-flow tally).
    ``skipped`` carries the reason when the cell could not run here (not
    enough ranks, a geometry that does not split, a 1-way mesh): a skip
    is not a pass and not a failure.  ``outputs`` is this rank's
    (output, input gradient, kernel gradient) of the probe, None when
    skipped or outside the cell's mesh."""

    partition: str
    n_dev_axes: Tuple[int, ...]
    violations: List[ContractViolation]
    record: Dict
    skipped: Optional[str] = None
    outputs: Optional[tuple] = dataclasses.field(default=None, repr=False,
                                                 compare=False)

    @property
    def ok(self) -> bool:
        return not self.violations

    def render(self) -> str:
        head = (f"shardcheck {self.partition} x{list(self.n_dev_axes)}: "
                f"{self.record.get('verdict')}")
        lines = [head]
        if self.skipped:
            lines.append(f"  skipped: {self.skipped}")
        lines += [f"  {v.render()}" for v in self.violations]
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# the contract
# ---------------------------------------------------------------------------

def _sizes_of(parts, n_dev) -> Tuple[int, ...]:
    sizes = tuple(int(n) for n in n_dev) \
        if isinstance(n_dev, (tuple, list)) else (int(n_dev),)
    if len(sizes) != len(parts):
        raise ValueError(f"partition {parts!r} has {len(parts)} "
                         f"component(s) but n_dev {n_dev!r} has "
                         f"{len(sizes)}")
    return sizes


def trim_reshard(spec, parts, sizes,
                 dtype_bytes: int) -> Tuple[Optional[str], float]:
    """GSPMD's ``out[:, :o_h]`` trim reshard: ``(fwd_unmodeled_reason,
    optional_permute_bytes)``, the JAX package's function.

    A spatial split emits ``r = h_loc/s_h`` rows a device and trims the
    result to ``o_h``.  When ``o_h`` splits evenly over the ``n_s``
    spatial ways, GSPMD may shift ``f = r - ceil(o_h/n_s)`` rows to the
    successor device (optional permute bytes).  ``o_h % n_s != 0`` leaves
    the standalone forward unpriceable; ``n_s > 2`` with ``f > 0`` leaves
    both directions unpriceable (NaN).  The port's ranks trim locally and
    pay none of it (:func:`rank_contract`)."""
    if "spatial" not in parts:
        return None, 0.0
    n_s = sizes[parts.index("spatial")]
    if n_s <= 1:
        return None, 0.0
    r = (spec.i_h // n_s) // spec.s_h
    trimmed = n_s * r - spec.o_h
    if trimmed <= 0:
        return None, 0.0
    f = r - (-(-spec.o_h // n_s))  # per-device shift: r - ceil(o_h/n_s)
    if n_s > 2 and f > 0:
        return (f"{n_s}-way spatial trim shifts {f} row(s) per device "
                f"across multiple sources; the reshard lowering is not "
                f"a single uniform collective-permute"), math.nan
    slab = 0.0
    if f > 0:
        n_b = sizes[parts.index("batch")] if "batch" in parts else 1
        n_c = sizes[parts.index("channel")] if "channel" in parts else 1
        i_n_loc = max(1, -(-spec.i_n // n_b))
        k_c_loc = max(1, -(-spec.k_c // n_c))
        slab = float(i_n_loc * f * spec.o_w * k_c_loc * dtype_bytes)
    if spec.o_h % n_s:
        return (f"trimmed output (o_h={spec.o_h}) does not split evenly "
                f"over the {n_s}-way spatial axis; GSPMD lowers the "
                f"standalone-forward output boundary as gather+slice "
                f"(unpriced probe traffic) — the grad program verifies "
                f"both VJP directions instead"), slab
    return None, slab


def replica_combine_bytes(spec, parts, sizes, dtype_bytes: int) -> float:
    """A device's bytes of the gradient-combine all-reduce GSPMD may add
    when the mesh is larger than the partition (its free axes replicate
    the cell): the local shard of the one gradient without a modelled
    sum (the input gradient without a channel component, the kernel
    gradient for pure channel), else 0."""
    n = dict(zip(parts, sizes))
    if "channel" not in parts:
        x_loc = (-(-spec.i_n // n.get("batch", 1))) * \
            (spec.i_h // max(1, n.get("spatial", 1))) * spec.i_w * spec.i_c
        return float(x_loc * dtype_bytes)
    if parts == ("channel",):
        k_loc = spec.k_h * spec.k_w * spec.i_c * \
            (-(-spec.k_c // n["channel"]))
        return float(k_loc * dtype_bytes)
    return 0.0


def expected_collectives(spec, partition, n_dev, dtype_bytes: int,
                         direction: str, *, replicated_ways: int = 1
                         ) -> Tuple[Dict[str, float], Dict[str, float],
                                    Optional[str]]:
    """GSPMD's ``(required, optional, unmodeled_reason)`` for one
    direction, the JAX package's contract: the halo on the permute (twice
    over the gradient program), the cotangent sums on the all-reduce,
    zero of every other kind, derived from ``conv_partition_costs``; the
    trim permute optional (:func:`trim_reshard`); with ``replicated_ways
    > 1`` the free-axis combine optional.  ``direction='fwd'`` is the
    forward alone, ``'grad'`` the gradient program of the probe loss."""
    if direction not in DIRECTIONS:
        raise ValueError(f"unknown direction {direction!r}; expected one "
                         f"of {DIRECTIONS}")
    from repro_torch.launch.costmodel import conv_partition_costs
    from repro_torch.parallel.conv import normalize_partition
    parts = normalize_partition(partition)
    sizes = _sizes_of(parts, n_dev)
    entry = conv_partition_costs(
        spec, sizes if len(parts) > 1 else sizes[0], dtype_bytes)[
            parts if len(parts) > 1 else parts[0]]
    halo = float(entry["halo_bytes_per_device"])
    psum = float(entry["comm_bytes_bwd_per_device"]) - halo
    reason, trim = trim_reshard(spec, parts, sizes, dtype_bytes)
    unmodeled = reason if reason is not None and \
        (direction == "fwd" or math.isnan(trim)) else None
    if math.isnan(trim):
        trim = 0.0
    mult = 1.0 if direction == "fwd" else 2.0
    required = {k: 0.0 for k in COLLECTIVE_KINDS}
    optional = {k: 0.0 for k in COLLECTIVE_KINDS}
    required["collective-permute"] = mult * halo
    optional["collective-permute"] = mult * trim
    if direction == "grad":
        required["all-reduce"] = psum
        if replicated_ways > 1:
            optional["all-reduce"] = replica_combine_bytes(
                spec, parts, sizes, dtype_bytes)
    return required, optional, unmodeled


def structural_gathers(spec, partition, n_dev, dtype_bytes: int,
                       direction: str) -> float:
    """The port's all-gather operand bytes a rank, for one direction.

    Forward: the output leaves through one gather a component, channel,
    then spatial, then batch (``parallel.conv._run_partitioned``), each
    operand the part gathered so far.  The gradient program adds the
    gathers of the split operands' cotangents: the input's over spatial,
    then batch; the kernel's over channel."""
    from repro_torch.parallel.conv import normalize_partition
    parts = normalize_partition(partition)
    n = dict(zip(parts, _sizes_of(parts, n_dev)))
    n_b, n_s, n_c = n.get("batch", 1), n.get("spatial", 1), \
        n.get("channel", 1)
    i_n = spec.i_n // n_b
    h_loc = spec.i_h // n_s
    rows = h_loc // spec.s_h if "spatial" in n else spec.o_h
    k_c = spec.k_c // n_c
    total = 0
    for mode in ("channel", "spatial", "batch"):
        if mode not in n:
            continue
        total += i_n * rows * spec.o_w * k_c
        if mode == "channel":
            k_c = spec.k_c
        elif mode == "spatial":
            rows *= n_s
        else:
            i_n = spec.i_n
    if direction == "grad":
        if "spatial" in n:
            total += (spec.i_n // n_b) * h_loc * spec.i_w * spec.i_c
        if "batch" in n:
            total += (spec.i_n // n_b) * spec.i_h * spec.i_w * spec.i_c
        if "channel" in n:
            total += spec.k_h * spec.k_w * spec.i_c * (spec.k_c // n_c)
    return float(total * dtype_bytes)


def halo_sends(n_s: int, direction: str,
               index: Optional[int] = None) -> int:
    """Halo slabs the rank at spatial ``index`` of ``n_s`` sends in one
    direction: forward, every rank but the first; the gradient program
    adds the cotangent sent back by every rank but the last.  ``index``
    None: the busiest rank's."""
    if n_s <= 1:
        return 0
    if index is None:
        return 1 if direction == "fwd" else (2 if n_s > 2 else 1)
    sends = int(index > 0)
    if direction == "grad":
        sends += int(index < n_s - 1)
    return sends


def rank_contract(spec, partition, n_dev, dtype_bytes: int, direction: str,
                  *, spatial_index: Optional[int] = None,
                  replicated_ways: int = 1
                  ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """The port's ``(required, optional)`` for one direction of the rank
    at ``spatial_index`` (None: the busiest rank): the cotangent sums of
    :func:`expected_collectives` on the all-reduce, its optional
    free-axis combine, the halo slabs of :func:`halo_sends` on the
    permute, :func:`structural_gathers` on the all-gather, zero of every
    other kind."""
    from repro_torch.launch.costmodel import conv_partition_costs
    from repro_torch.parallel.conv import normalize_partition
    parts = normalize_partition(partition)
    sizes = _sizes_of(parts, n_dev)
    gspmd, gspmd_optional, _ = expected_collectives(
        spec, parts, sizes, dtype_bytes, direction,
        replicated_ways=replicated_ways)
    halo = conv_partition_costs(
        spec, sizes if len(parts) > 1 else sizes[0], dtype_bytes)[
            parts if len(parts) > 1 else parts[0]]["halo_bytes_per_device"]
    n_s = dict(zip(parts, sizes)).get("spatial", 1)
    required = {k: 0.0 for k in COLLECTIVE_KINDS}
    optional = {k: 0.0 for k in COLLECTIVE_KINDS}
    required["all-reduce"] = gspmd["all-reduce"]
    optional["all-reduce"] = gspmd_optional["all-reduce"]
    required["collective-permute"] = float(
        halo * halo_sends(n_s, direction, spatial_index))
    required["all-gather"] = structural_gathers(spec, parts, sizes,
                                                dtype_bytes, direction)
    return required, optional


def verify_collectives(observed: Dict, expected: Dict[str, float],
                       direction: str, label: str = "",
                       dtype_bytes: int = 4,
                       optional: Optional[Dict[str, float]] = None
                       ) -> List[ContractViolation]:
    """Compare counted bytes with the contract, exactly on every kind.

    The admissible totals a kind are the required bytes alone or with the
    optional ones, each also at f32 width for sub-f32 dtypes (a rank that
    widens before a reduction); the grad all-reduce may run over by the
    scalar allowance.  Messages name the breach, both byte counts and the
    mechanism that should have moved the bytes."""
    where = f"{label}: " if label else ""
    widths = (1.0,) if dtype_bytes >= 4 else (1.0, 4.0 / dtype_bytes)
    out: List[ContractViolation] = []
    for kind in COLLECTIVE_KINDS:
        got = float(observed.get(kind, 0))
        base = float(expected.get(kind, 0.0))
        opt = float((optional or {}).get(kind, 0.0))
        allowance = SCALAR_REDUCE_ALLOWANCE_BYTES \
            if kind == "all-reduce" and direction == "grad" else 0.0
        if any(total * w <= got <= total * w + allowance
               for total in {base, base + opt} for w in widths):
            continue
        if got < base:
            hint = ""
            if kind == "collective-permute":
                hint = (" — the spatial halo exchange (parallel.comm.Halo "
                        "in parallel.conv.sharded_conv2d"
                        + (", or its cotangent sent back"
                           if direction == "grad" else "")
                        + ") is missing or undersized")
            elif kind == "all-reduce":
                hint = (" — a backward sum (kernel cotangent over the "
                        "batch/spatial axes, input cotangent over the "
                        "channel axis) is missing")
            elif kind == "all-gather":
                hint = (" — the output (or a split operand's gradient) "
                        "did not come back to every rank whole")
            out.append(ContractViolation(
                "missing-collective", direction,
                f"{where}{kind} moved {got:.0f} bytes/device, contract "
                f"expects {base:.0f}{hint}"))
        elif base == 0.0:
            out.append(ContractViolation(
                "unexpected-collective", direction,
                f"{where}{kind} moved {got:.0f} bytes/device but the "
                f"contract expects none — traffic the cost model never "
                f"priced"))
        else:
            out.append(ContractViolation(
                "collective-bytes-mismatch", direction,
                f"{where}{kind} moved {got:.0f} bytes/device, contract "
                f"expects {base:.0f}"
                + (f"+{opt:.0f} optional" if opt else "")
                + f" (allowance {allowance:.0f})"))
    return out


# ---------------------------------------------------------------------------
# the checker
# ---------------------------------------------------------------------------

def _local_spec(spec, parts, sizes):
    """The geometry of the body each rank runs: its input shard with the
    halo rows appended, its kernel shard."""
    from repro_torch.parallel.conv import spatial_halo_rows
    n = dict(zip(parts, sizes))
    halo = spatial_halo_rows(spec.k_h, spec.s_h) if "spatial" in n else 0
    return dataclasses.replace(
        spec, i_n=spec.i_n // n.get("batch", 1),
        i_h=spec.i_h // n.get("spatial", 1) + halo,
        k_c=spec.k_c // n.get("channel", 1))


def _probe_operands(spec, dtype: str, device: str):
    """The probe's input and kernel, the same on every rank: drawn on the
    CPU from seed 0, then moved."""
    import torch
    gen = torch.Generator().manual_seed(0)
    td = getattr(torch, dtype)
    x = torch.randn((spec.i_n, spec.i_h, spec.i_w, spec.i_c),
                    generator=gen).to(device=device, dtype=td)
    k = (torch.randn((spec.k_h, spec.k_w, spec.i_c, spec.k_c), generator=gen)
         * (spec.k_h * spec.k_w * spec.i_c) ** -0.5).to(device=device,
                                                         dtype=td)
    return x, k


def _run_probe(spec, parts, axes, mesh, operands, algorithm, solution):
    """This rank's probe: (fwd counts, bwd counts, outputs)."""
    import torch
    from repro_torch.launch.hlo_analysis import collective_bytes
    from repro_torch.parallel.conv import sharded_conv2d
    x, k = (t.detach().clone().requires_grad_(True) for t in operands)
    part_arg = parts if len(parts) > 1 else parts[0]
    axis_arg = tuple(axes) if len(axes) > 1 else axes[0]
    with torch.enable_grad():
        with collective_bytes() as fwd:
            y = sharded_conv2d(x, k, stride=(spec.s_h, spec.s_w),
                               padding="VALID", algorithm=algorithm,
                               solution=solution, partition=part_arg,
                               axis=axis_arg, mesh=mesh)
        with collective_bytes() as bwd:
            (y.float() * y.float()).sum().backward()
    return fwd, bwd, (y.detach(), x.grad, k.grad)


def check_sharding(spec, partition, n_dev=None, *, dtype: str = "float32",
                   algorithm: str = "mec", solution: str = "auto",
                   precision: Optional[str] = None,
                   axes: Optional[Sequence[str]] = None, mesh=None,
                   directions: Sequence[str] = DIRECTIONS,
                   device: str = "cuda", operands=None) -> ShardCheck:
    """The contract check of one partitioned cell, on ranks.

    Runs the cell on ``mesh`` (its ``axes`` naming the partition's mesh
    axes) or on a host mesh of shape ``n_dev`` over the world's first
    ranks, forward and then the gradient of ``sum(out^2)``, on
    ``operands`` (input and kernel, the same on every rank) or seeded
    ones on ``device``.  Collective: every rank of the world calls it
    alike.  Skips (recorded, never dropped): a 1-way partition, a
    geometry that does not split, a world smaller than the cell."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.numerics import contract_for
    from repro_torch.analysis.numcheck import trace_signature
    from repro_torch.launch.mesh import axis_sizes, make_host_mesh
    from repro_torch.parallel.conv import (normalize_partition,
                                           partition_name, partition_viable)
    parts = normalize_partition(partition)
    if mesh is not None:
        if axes is None:
            raise ValueError("check_sharding(mesh=...) needs axes= naming "
                             "the mesh axes the partition runs over")
        axes = tuple(axes)
        sizes = tuple(axis_sizes(mesh)[a] for a in axes)
    else:
        if n_dev is None:
            raise ValueError("check_sharding needs n_dev= (axis sizes) "
                             "or an explicit mesh=")
        sizes = _sizes_of(parts, n_dev)
    if len(sizes) != len(parts):
        raise ValueError(f"partition {partition!r} has {len(parts)} "
                         f"component(s) but got {len(sizes)} axis size(s)")
    for d in directions:
        if d not in DIRECTIONS:
            raise ValueError(f"unknown direction {d!r}; expected one of "
                             f"{DIRECTIONS}")
    name = partition_name(parts)
    n_total = math.prod(sizes)
    dtype_bytes = getattr(torch, dtype).itemsize
    record: Dict = {
        "partition": name, "n_dev_axes": [int(n) for n in sizes],
        "dtype": dtype, "algorithm": algorithm, "solution": solution,
        "precision": precision, "directions": {}, "precision_flow": None,
        "verdict": "pass", "skipped_reason": None, "violations": [],
    }

    def skipped(reason: str) -> ShardCheck:
        record["verdict"] = "skipped"
        record["skipped_reason"] = reason
        return ShardCheck(name, sizes, [], record, skipped=reason)

    if n_total <= 1:
        return skipped("1-way partition: nothing crosses the interconnect")
    if not partition_viable(spec, parts, sizes if len(parts) > 1
                            else sizes[0]):
        return skipped(f"partition {name!r} cannot split {spec} "
                       f"{sizes}-ways (parallel.conv.partition_viable)")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if mesh is None:
        if n_total > world:
            return skipped(f"needs {n_total} ranks, the world has {world} "
                           f"(launch.mesh.spawn or torchrun with more)")
        mesh = make_host_mesh(shape=sizes)
        axes = tuple(mesh.mesh_dim_names)
    replicated = mesh.size() // n_total

    mine, outputs = None, None
    if mesh.get_coordinate() is not None:
        if operands is None:
            operands = _probe_operands(spec, dtype, device)
        fwd, bwd, outputs = _run_probe(spec, parts, axes, mesh, operands,
                                       algorithm, solution)
        index = None
        if "spatial" in parts:
            index = mesh.get_local_rank(axes[parts.index("spatial")])
        mine = {"rank": dist.get_rank(), "spatial_index": index,
                "fwd": {k: fwd[k] for k in COLLECTIVE_KINDS},
                "grad": {k: fwd[k] + bwd[k] for k in COLLECTIVE_KINDS}}
    ranks = [None] * world
    dist.all_gather_object(ranks, mine)
    ranks = [r for r in ranks if r is not None]
    record["ranks"] = ranks

    violations: List[ContractViolation] = []
    label = f"{name} x{list(sizes)} {algorithm}/{dtype}"
    for direction in directions:
        required, optional = rank_contract(
            spec, parts, sizes, dtype_bytes, direction,
            replicated_ways=replicated)
        busiest = {k: max(r[direction][k] for r in ranks)
                   for k in COLLECTIVE_KINDS}
        violations += verify_collectives(
            busiest, required, direction, label=label,
            dtype_bytes=dtype_bytes, optional=optional)
        record["directions"][direction] = {
            "expected": required, "optional": optional,
            "observed": busiest}
    if precision in (None, "DEFAULT"):
        # nothing declared: the pass is trivially clean, nothing traced
        tally = {"declared": precision, "dot_ops": None,
                 "unannotated_dot_ops": 0, "hlo_dots": None,
                 "hlo_unannotated": 0}
    else:
        lspec = _local_spec(spec, parts, sizes)
        tally, pviol = precision_flow_findings(
            [trace_signature(lspec, algorithm, dtype, direction, solution)
             for direction in directions], precision,
            getattr(contract_for(algorithm), "accum_dtype", "float32"))
        violations += pviol
    record["replicated_ways"] = replicated
    record["precision_flow"] = tally
    record["violations"] = [v.render() for v in violations]
    record["verdict"] = "pass" if not violations else "fail"
    return ShardCheck(name, sizes, violations, record, outputs=outputs)


# ---------------------------------------------------------------------------
# plan wiring (duck-typed; repro_torch.plan imports us, never the reverse)
# ---------------------------------------------------------------------------

def _ranked_mesh(mesh):
    """``mesh``, else the installed rules' mesh; None where that is no
    mesh of ranks (no rules, or an ``AbstractMesh``: nothing to run on)."""
    from repro_torch.launch.mesh import AbstractMesh
    if mesh is None:
        from repro_torch.parallel.axes import current_rules
        rules = current_rules()
        mesh = rules.mesh if rules is not None else None
    return None if isinstance(mesh, AbstractMesh) else mesh


def check_plan_contract(plan, mesh=None,
                        directions: Sequence[str] = ("grad",)
                        ) -> ShardCheck:
    """Contract-check one (duck-typed) ConvPlan on its backend's device.

    Partition-free plans trivially pass.  The mesh defaults to the
    installed ``parallel.axes`` rules' mesh, the one the plan's axes were
    resolved against; with no mesh carrying the plan's axes the check is
    recorded as skipped.  The default direction is ``grad`` alone: the
    gradient program runs the forward too.  Collective over the mesh's
    ranks, as :func:`check_sharding`."""
    partition = getattr(plan, "partition", None)
    if partition is None:
        rec = {"partition": None, "verdict": "skipped",
               "skipped_reason": "no partition"}
        return ShardCheck("none", (), [], rec, skipped="no partition")
    mesh = _ranked_mesh(mesh)
    axes = tuple(plan.partition_axes)
    if mesh is None or any(a not in mesh.mesh_dim_names for a in axes):
        rec = {"partition": "+".join(partition), "verdict": "skipped",
               "skipped_reason": "no installed mesh of ranks carrying the "
                                 f"plan's axes {axes!r}"}
        return ShardCheck("+".join(partition), (), [], rec,
                          skipped=rec["skipped_reason"])
    return check_sharding(
        plan.spec, partition, dtype=plan.dtype, algorithm=plan.algorithm,
        solution=plan.solution, precision=getattr(plan, "precision", None),
        axes=axes, mesh=mesh, directions=directions,
        device=getattr(plan, "backend", "cuda"))


# plan_conv2d calls the hook once a contract identity: layers resolving
# the same partitioned plan must not re-run the cell on the ranks.
_HOOK_CACHE: Dict[Tuple, Tuple[bool, str]] = {}
_HOOK_CACHE_MAX = 256


def assert_plan_contract(plan, mesh=None) -> None:
    """The ``plan_conv2d`` hook: raise :class:`ShardCheckError` when a
    partitioned plan breaks its collective or precision contract on the
    installed rules' ranks.  Skipped silently with no installed rules (or
    no mesh carrying the plan's axes): the planner stays usable on one
    process.  Memoised by contract identity (spec, dtype, algorithm,
    solution, precision, partition, axes, sizes, backend).

    Collective: every rank of the rules' mesh must plan the same cell
    together (as every rank of a distributed program does), because the
    check runs the cell on all of them; a hook reached on one rank alone
    waits for the others until the group's timeout."""
    partition = getattr(plan, "partition", None)
    if partition is None:
        return
    from repro_torch.launch.mesh import axis_sizes
    mesh = _ranked_mesh(mesh)
    axes = tuple(plan.partition_axes)
    if mesh is None or any(a not in mesh.mesh_dim_names for a in axes):
        return
    sizes = tuple(axis_sizes(mesh)[a] for a in axes)
    key = (plan.spec, plan.dtype, plan.algorithm, plan.solution,
           getattr(plan, "precision", None), tuple(partition), axes, sizes,
           getattr(plan, "backend", None))
    hit = _HOOK_CACHE.get(key)
    if hit is None:
        result = check_plan_contract(plan, mesh=mesh)
        if len(_HOOK_CACHE) >= _HOOK_CACHE_MAX:
            _HOOK_CACHE.clear()
        hit = _HOOK_CACHE[key] = (result.ok, result.render())
    if not hit[0]:
        raise ShardCheckError(hit[1])


# ---------------------------------------------------------------------------
# the suite (python -m repro_torch.analysis --suite shardcheck)
# ---------------------------------------------------------------------------

#: the most ranks the suite spawns: every committed dist-baseline mesh
SHARDCHECK_MAX_RANKS = 8


def suite_cells(dist_path=None, plans_path=None) -> List[Dict]:
    """The suite's cells: every partitioned record of the dist baseline,
    then every partitioned plan of the plans baseline under a 2-way axis
    a component (a plan records mesh axes, not sizes)."""
    import json
    import pathlib

    from repro_torch.analysis.memaudit import load_plans
    from repro_torch.bench.scenarios import ALGORITHM_VARIANTS
    from repro_torch.core.convspec import ConvSpec
    cells = []
    if dist_path is not None and pathlib.Path(dist_path).exists():
        for r in json.loads(pathlib.Path(dist_path).read_text())["results"]:
            if "partition" not in r:
                continue
            kw = ALGORITHM_VARIANTS.get(r["algorithm"],
                                        {"algorithm": r["algorithm"]})
            cells.append({
                "scenario": r["scenario"], "variant": r["algorithm"],
                "spec": ConvSpec(**r["run_spec"]),
                "partition": r["partition"],
                "sizes": tuple(r.get("n_dev_axes") or [r["n_dev"]]),
                "dtype": r["dtype"], "source": "dist-baseline",
                "algorithm": kw.get("algorithm", r["algorithm"]),
                "solution": kw.get("solution", "auto"), "precision": None})
    if plans_path is not None:
        for name, plan in load_plans(plans_path).items():
            if plan.partition is None:
                continue
            cells.append({
                "scenario": name, "variant": plan.algorithm,
                "spec": plan.spec, "partition": plan.partition,
                "sizes": (2,) * len(plan.partition), "dtype": plan.dtype,
                "source": "plans-baseline", "algorithm": plan.algorithm,
                "solution": plan.solution, "precision": plan.precision})
    return cells


def suite_rank(cells: Sequence[Dict], device: str) -> List[Dict]:
    """Every cell on this rank of the world (each on a host mesh over the
    first ranks); the records, the same on every rank."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    world = dist.get_world_size()
    meshes, results = {}, []
    for cell in cells:
        sizes = cell["sizes"]
        mesh = None
        if 1 < math.prod(sizes) <= world:
            if sizes not in meshes:
                meshes[sizes] = make_host_mesh(shape=sizes)
            mesh = meshes[sizes]
        chk = check_sharding(
            cell["spec"], cell["partition"], sizes, dtype=cell["dtype"],
            algorithm=cell["algorithm"], solution=cell["solution"],
            precision=cell["precision"], device=device, mesh=mesh,
            axes=None if mesh is None else mesh.mesh_dim_names)
        rec = dict(chk.record)
        rec.pop("solution", None)
        rec.update({"scenario": cell["scenario"],
                    "algorithm": cell["variant"], "dtype": cell["dtype"],
                    "spec": dataclasses.asdict(cell["spec"]),
                    "source": cell["source"],
                    "n_dev": int(math.prod(sizes))})
        results.append(rec)
    return results


def run_suite(device: str = "cuda", dist_path=None, plans_path=None,
              max_ranks: int = SHARDCHECK_MAX_RANKS) -> List[Dict]:
    """The suite's records: on the ranks of the running world, or (outside
    one) on as many fresh gloo ranks as the largest cell needs, at most
    ``max_ranks``, that share ``device``'s card."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import spawn
    cells = suite_cells(dist_path, plans_path)
    if dist.is_initialized():
        return suite_rank(cells, device)
    n = min(max_ranks, max([math.prod(c["sizes"]) for c in cells] + [2]))
    return spawn(suite_rank, n, args=(cells, device), backend="gloo",
                 device=device, timeout_s=300, join_timeout_s=3000)[0]
