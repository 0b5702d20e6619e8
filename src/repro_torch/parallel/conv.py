"""Distributed conv2d: the MEC conv split over ranks, with the spatial
halo exchange (counterpart of ``repro.parallel.conv``).

The paper's Solution B runs the o_h shifted GEMMs in parallel on one
device; this module is the same idea over a mesh.  One entry point,
:func:`sharded_conv2d`, partitions a convolution over one mesh axis or,
composite, over two, in one of three base modes:

``batch``    input split on ``i_n``; kernel replicated.  No forward
             communication; the kernel cotangent is summed over the axis.
``channel``  kernel split on ``k_c`` (output channels); input
             replicated.  No forward communication; the *input*
             cotangent is summed in the backward.
``spatial``  input split on ``i_h`` rows.  MEC's compact L (Eq. 3)
             lowers whole input rows, so a rank needs only the first
             ``k_h - s_h`` rows of the rank after it, the overlap the
             ``fused2`` kernel fetches as its halo; they are exchanged
             before the local conv, and their cotangent goes back.

Composite partitions (:data:`COMPOSITE_PARTITIONS`) pair two base modes
over two distinct mesh axes, so a ``data x model`` mesh fills up even
when no single dimension divides by the whole rank count.

Where JAX runs one program over global arrays, each rank here is a
process that holds the same whole tensors, the caller's view of the
global arrays.  A rank slices its shard, runs the single-device
``conv2d`` on it (its body: K1, K2+K3 or K4 on a CUDA tensor), and the
output leaves through an all-gather, so every rank returns the global
output; the gradients of input and kernel are the single-device conv's
on every rank.  The collectives and their backward rules are
``parallel.comm``'s.  The analytic bytes of the cost model
(``launch.costmodel.conv_partition_costs``) are what the halo exchange
and the cotangent sums send; gathering the output, and a sharded
operand's gradient, are what returning global tensors costs on top.

The pure algebra (partition names, viability, axis resolution,
placements and candidates) is the JAX package's, copied.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.core.conv_api import ALGORITHMS, apply_padding, conv2d
from repro_torch.core.convspec import ConvSpec, normalize_stride, spec_of
from repro_torch.core.mec import SOLUTIONS
from repro_torch.launch.mesh import axes_group, axis_names, axis_sizes
from repro_torch.parallel import comm
from repro_torch.parallel.axes import ShardingRules, current_rules

PARTITIONS = ("batch", "channel", "spatial")
# Canonical composite partitions: two base modes over two distinct mesh
# axes, in a fixed order so cost-model keys, bench record names and axis
# tuples line up.
COMPOSITE_PARTITIONS = (("batch", "spatial"), ("batch", "channel"),
                        ("spatial", "channel"))

Partition = Union[str, Tuple[str, ...]]


def normalize_partition(partition: Partition) -> Tuple[str, ...]:
    """Canonical component tuple of a partition argument: a base mode
    (``"spatial"``), a component tuple (``("batch", "spatial")``) or the
    serialised composite (``"batch+spatial"``)."""
    if isinstance(partition, str):
        parts = tuple(partition.split("+")) if "+" in partition \
            else (partition,)
    elif isinstance(partition, Sequence):
        parts = tuple(partition)
    else:
        raise ValueError(f"unknown partition {partition!r}")
    for p in parts:
        if p not in PARTITIONS:
            raise ValueError(
                f"unknown partition {partition!r}; components must be "
                f"from {PARTITIONS} (composites: {COMPOSITE_PARTITIONS})")
    if len(parts) == 1:
        return parts
    if parts not in COMPOSITE_PARTITIONS:
        raise ValueError(
            f"unknown composite partition {partition!r}; expected one of "
            f"{COMPOSITE_PARTITIONS} (canonical component order)")
    return parts


def partition_name(partition: Partition) -> str:
    """Serialised form: ``"spatial"`` / ``"batch+spatial"``."""
    return "+".join(normalize_partition(partition))


def spatial_halo_rows(k_h: int, s_h: int) -> int:
    """Input rows a rank needs from the rank after it: the window of the
    last local output row overhangs by ``k_h - s_h`` rows (0 when the
    stride covers the kernel)."""
    return max(0, k_h - s_h)


def _component_viable(spec: ConvSpec, mode: str, n_dev: int) -> bool:
    if n_dev < 1:
        return False
    if mode == "batch":
        return spec.i_n % n_dev == 0
    if mode == "channel":
        return spec.k_c % n_dev == 0
    if spec.i_h % n_dev:
        return False
    h_loc = spec.i_h // n_dev
    return h_loc % spec.s_h == 0 and \
        spatial_halo_rows(spec.k_h, spec.s_h) <= h_loc


def partition_viable(spec: ConvSpec, partition: Partition,
                     n_dev: Union[int, Tuple[int, ...]]) -> bool:
    """Can ``spec`` be split ``n_dev``-ways along ``partition``?

    ``spatial`` also needs the local row count to be a stride multiple
    (every rank emits as many output rows) and the halo to fit in the
    next rank (one hop).  Composites take a tuple of sub-axis sizes and
    are viable componentwise on the global spec.
    """
    parts = normalize_partition(partition)
    sizes = (n_dev,) if isinstance(n_dev, int) else tuple(n_dev)
    if len(sizes) != len(parts):
        raise ValueError(
            f"partition {partition!r} has {len(parts)} component(s) but "
            f"n_dev {n_dev!r} has {len(sizes)}")
    return all(_component_viable(spec, p, n) for p, n in zip(parts, sizes))


def _component_axis(mode: str, mesh, rules: Optional[ShardingRules],
                    used: Tuple[str, ...]) -> str:
    names = axis_names(mesh)
    if mode == "batch":
        prefer = tuple(rules.dp_axes) if rules else ()
        prefer += ("data", "pod")
    else:  # channel / spatial live on the tensor-parallel axis
        prefer = (rules.tp_axis,) if rules and rules.tp_axis else ()
        prefer += ("model",)
    for a in prefer:
        if a in names and a not in used:
            return a
    free = tuple(a for a in names if a not in used)
    if len(free) == 1:
        return free[0]
    raise ValueError(
        f"cannot infer a mesh axis for partition component {mode!r} on "
        f"mesh axes {names} (already claimed: {used}); pass axis= "
        "explicitly")


def default_axis(partition: Partition, mesh,
                 rules: Optional[ShardingRules] = None
                 ) -> Union[str, Tuple[str, ...]]:
    """Mesh axis (axis tuple, for composites) a partition runs over when
    the caller names none; composite components resolve in order, each
    skipping axes an earlier one claimed."""
    parts = normalize_partition(partition)
    axes: Tuple[str, ...] = ()
    for mode in parts:
        axes += (_component_axis(mode, mesh, rules, axes),)
    return axes[0] if len(parts) == 1 else axes


def _resolve_axes(parts: Tuple[str, ...], axis, mesh,
                  rules: Optional[ShardingRules]) -> Tuple[str, ...]:
    """Explicit-or-default mesh axes, one per component, validated."""
    if axis is None:
        resolved = default_axis(parts if len(parts) > 1 else parts[0],
                                mesh, rules)
        return resolved if isinstance(resolved, tuple) else (resolved,)
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    if len(axes) != len(parts):
        raise ValueError(
            f"partition {parts!r} needs {len(parts)} mesh axis(es), got "
            f"axis={axis!r}")
    for a in axes:
        if a not in axis_names(mesh):
            raise ValueError(f"axis {a!r} not in mesh axes "
                             f"{axis_names(mesh)}")
    if len(set(axes)) != len(axes):
        raise ValueError(f"composite partition axes must be distinct, got "
                         f"{axes!r}")
    return axes


def _partition_specs(axis_of: dict) -> Tuple[Tuple, Tuple, Tuple]:
    """(input, kernel, output) placements from a mode -> axis map."""
    return ((axis_of.get("batch"), axis_of.get("spatial")),
            (None, None, None, axis_of.get("channel")),
            (axis_of.get("batch"), axis_of.get("spatial"), None,
             axis_of.get("channel")))


def conv_partition_specs(partition: Partition,
                         axis: Union[str, Tuple[str, ...]]
                         ) -> Tuple[Tuple, Tuple, Tuple]:
    """(input, kernel, output) placements of one partition: the dims each
    operand is split on, ``axis`` paired with the components in order."""
    parts = normalize_partition(partition)
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    if len(axes) != len(parts):
        raise ValueError(f"partition {partition!r} needs {len(parts)} "
                         f"axis(es), got {axis!r}")
    return _partition_specs(dict(zip(parts, axes)))


def enumerate_partition_candidates(
        mesh, rules: Optional[ShardingRules] = None,
        axis: Union[str, Tuple[str, ...], None] = None):
    """Every partition mode that can resolve mesh axes here:
    ``{mode: (axes_tuple, n_dev)}``, ``n_dev`` an int for 1-D modes and a
    per-sub-axis tuple for composites.  Geometry is not filtered here
    (``pick_conv_partition`` does that).  Shared by
    ``sharded_conv2d(partition="auto")`` and the planner, so a plan
    records the candidate set the executor would enumerate."""
    sizes = axis_sizes(mesh)
    candidates = {}
    if axis is None or isinstance(axis, str):
        for part in PARTITIONS:
            try:
                axes = _resolve_axes((part,), axis, mesh, rules)
            except ValueError:
                continue  # no resolvable axis -> mode not a candidate
            candidates[part] = (axes, int(sizes[axes[0]]))
    if axis is None or not isinstance(axis, str):
        for comp in COMPOSITE_PARTITIONS:
            try:
                axes = _resolve_axes(comp, axis, mesh, rules)
            except ValueError:
                continue
            candidates[comp] = (axes, tuple(int(sizes[a]) for a in axes))
    return candidates


def _validate_call(algorithm: str, solution: str) -> None:
    if algorithm.lower() not in ALGORITHMS:
        raise ValueError(
            f"unknown algorithm {algorithm!r}; expected one of "
            f"{ALGORITHMS}")
    if solution not in SOLUTIONS:
        raise ValueError(
            f"unknown MEC solution {solution!r}; expected one of "
            f"{SOLUTIONS}")


def _single_device(x, kernel, stride, algorithm, solution):
    # x is already padded; partition="none" keeps the call from
    # re-entering the sharded path under installed rules.
    return conv2d(x, kernel, stride=stride, padding="VALID",
                  algorithm=algorithm, solution=solution, partition="none")


def _run_partitioned(x: torch.Tensor, kernel: torch.Tensor, spec: ConvSpec,
                     stride: Tuple[int, int], axis_of: dict, mesh,
                     algorithm: str, solution: str) -> torch.Tensor:
    """This rank's share of the conv, returned as the global output."""
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} holds no coordinate in "
                         f"the mesh {axis_sizes(mesh)}")
    sizes = axis_sizes(mesh)
    n = {m: sizes[a] for m, a in axis_of.items()}
    at = {m: mesh.get_local_rank(a) for m, a in axis_of.items()}
    group = {m: mesh.get_group(a) for m, a in axis_of.items()}
    halo = spatial_halo_rows(spec.k_h, stride[0])

    xb, kb = x, kernel
    for mode, dim in (("batch", 0), ("spatial", 1)):
        if mode in axis_of:
            xb = comm.Shard.apply(xb, dim, at[mode], n[mode], group[mode])
    if "channel" in axis_of:
        kb = comm.Shard.apply(kb, 3, at["channel"], n["channel"],
                              group["channel"])
        # The input is replicated over the channel axis: its cotangent
        # (this rank's input shard, before the halo) is summed there.
        xb = comm.Replicated.apply(xb, group["channel"])
    splits_input = tuple(axis_of[m] for m in ("batch", "spatial")
                         if m in axis_of)
    if splits_input:
        # The kernel (this rank's channel shard) is replicated over the
        # axes that split the input: one sum over all of them.
        kb = comm.Replicated.apply(kb, axes_group(mesh, splits_input))
    if "spatial" in axis_of and halo:
        xb = comm.Halo.apply(xb, halo, at["spatial"], n["spatial"],
                             group["spatial"])
    out = _single_device(xb, kb, stride, algorithm, solution)
    if "spatial" in axis_of:
        h_loc = spec.i_h // n["spatial"]
        if out.shape[1] != h_loc // stride[0]:
            raise AssertionError((tuple(out.shape), h_loc, stride))
    for mode, dim in (("channel", 3), ("spatial", 1), ("batch", 0)):
        if mode in axis_of:
            out = comm.Gathered.apply(out, dim, at[mode], n[mode],
                                      group[mode])
    if "spatial" in axis_of:
        # n_spatial * (h_loc / s_h) rows were produced; the trailing ones
        # (windows that ran into the zero halo) are not outputs.
        out = out[:, :spec.o_h]
    return out


def sharded_conv2d(inp: torch.Tensor, kernel: torch.Tensor, *, stride=1,
                   padding="VALID", algorithm: str = "auto",
                   solution: str = "auto", partition: Partition = "auto",
                   axis: Union[str, Tuple[str, ...], None] = None,
                   mesh=None, rules: Optional[ShardingRules] = None
                   ) -> torch.Tensor:
    """Distributed 2-D convolution, NHWC x HWIO -> NHWC, called by every
    rank of ``mesh`` with the same whole tensors; returns the whole output
    on every rank.

    partition: 'batch' | 'channel' | 'spatial' | a composite tuple from
    :data:`COMPOSITE_PARTITIONS` | 'auto'.  'auto' asks the cost model for
    the cheapest viable split (1-D and composite candidates) and runs the
    single-device ``conv2d`` when none is, or when there is no mesh.  An
    explicit partition that cannot split the geometry raises.  axis names
    the mesh axis (a tuple, paired in order, for composites).  mesh and
    rules default to the installed ``parallel.axes`` rules; rules whose
    ranks each hold their own batch (``local_batch``) cannot lend their
    mesh and raise.
    """
    _validate_call(algorithm, solution)
    if rules is None:
        rules = current_rules()
    if mesh is None and rules is not None:
        if rules.local_batch:
            raise ValueError(
                "sharded_conv2d needs the same whole tensors on every rank; "
                "under local_batch rules (a data-parallel step) each rank "
                "holds its own batch: pass partition='none' or a mesh")
        mesh = rules.mesh
    if isinstance(axis, (tuple, list)):
        axis = axis[0] if len(axis) == 1 else tuple(axis)
    if axis is not None and mesh is not None:
        # An explicit axis must be valid even under partition="auto": a
        # typo raises instead of losing all parallelism.
        names = (axis,) if isinstance(axis, str) else axis
        for a in names:
            if a not in axis_names(mesh):
                raise ValueError(
                    f"axis {a!r} not in mesh axes {axis_names(mesh)}")
        if len(set(names)) != len(names):
            raise ValueError(f"partition axes must be distinct, got "
                             f"{axis!r}")
        if len(names) > 2:
            raise ValueError(f"at most 2 partition axes supported, got "
                             f"{axis!r}")

    s_h, s_w = normalize_stride(stride)
    k_h, k_w = kernel.shape[0], kernel.shape[1]
    x = apply_padding(inp, k_h, k_w, s_h, s_w, padding)
    spec = spec_of(x, kernel, (s_h, s_w))

    if partition != "auto":
        # Validate the partition even when there is no mesh to run it on.
        parts = normalize_partition(partition)
    if mesh is None:
        return _single_device(x, kernel, (s_h, s_w), algorithm, solution)

    if partition == "auto":
        # Lazy import: the launch layer is consulted at call time.
        from repro_torch.launch.costmodel import pick_conv_partition
        candidates = enumerate_partition_candidates(mesh, rules, axis)
        picked = pick_conv_partition(
            spec, {p: n for p, (_, n) in candidates.items()},
            dtype_bytes=x.element_size())
        if picked is None:
            return _single_device(x, kernel, (s_h, s_w), algorithm,
                                  solution)
        parts = normalize_partition(picked)
        axes, n_dev = candidates[picked]
    else:
        axes = _resolve_axes(parts, axis, mesh, rules)
        sizes = axis_sizes(mesh)
        n_dev = tuple(int(sizes[a]) for a in axes)
        n_dev = n_dev[0] if len(parts) == 1 else n_dev
        if not partition_viable(spec, parts, n_dev):
            raise ValueError(
                f"partition {partition!r} cannot split {spec} over "
                f"{n_dev} devices (axes {axes!r}); see "
                "parallel.conv.partition_viable")
    return _run_partitioned(x, kernel, spec, (s_h, s_w),
                            dict(zip(parts, axes)), mesh, algorithm,
                            solution)
