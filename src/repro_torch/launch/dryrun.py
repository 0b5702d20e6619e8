"""Dry run over a fake process group (counterpart of
``repro.launch.dryrun``): one step of every (architecture x input shape)
cell at full size on the production mesh, without a card or a peer.

The process joins a world of 256 ranks (``--multi-pod``: 512) as rank 0,
with the ``"fake"`` backend for CPU and meta tensors
(``torch.testing._internal.distributed.fake_pg.FakeStore``): every
collective returns at once and moves nothing.
It builds ``launch.mesh.make_production_mesh`` and runs one train step
(ZeRO-1, ``training.steps.make_zero1_train_step``), prefill or decode
step under ``default_rules``, on fake tensors of the ``meta`` device
(``FakeTensorMode``): the parameters are the rank's tensor-parallel
slices, the moments its ZeRO-1 slices, the batch its data-parallel rows.
K1-K6 are traced as ``repro_torch::kernel_call`` on the path the card
takes.  Each cell records, per device:

* ``flops``: ``launch.hlo_analysis.flops_bytes`` (``FlopCounterMode``,
  the kernels' own arithmetic included); ``bytes_accessed`` is 0.0 (no
  op-level byte count);
* ``collectives``: the operand bytes by kind this rank hands
  ``torch.distributed`` (``hlo_analysis.collective_bytes``);
* ``memory``: the live fake storages
  (``torch.distributed._tools.mem_tracker.MemTracker``):
  ``argument_bytes`` (the step's inputs), ``output_bytes`` (what the
  step leaves alive beyond them), ``peak_bytes`` (the most alive during
  the step) and ``temp_bytes`` (peak less arguments and outputs);
* ``param_bytes`` and ``moment_bytes`` of the rank;
* the roofline terms at the card's data-sheet constants, and the model
  FLOPs, with the JAX package's record keys.

These are counts on fake tensors for a mesh of H100s; nothing is
measured.  The conv cells (:data:`CONV_CELLS`) run ``sharded_conv2d``
forward and the gradient of ``sum(out^2)`` on rank 0 and on a middle
rank of the partition's axes (a fake process group takes any rank), and
assert the collective contract exactly (``analysis.shardcheck``), each
rank against its own and the busiest against the busiest's, with the
mesh's unused axes as ``replicated_ways``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --conv all

Records go to ``results/dryrun_torch/`` (git-ignored), one JSON a cell;
``benchmarks.roofline --results`` reads them.  Run it in a process of its
own: the fake group replaces any other.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs.archs import ARCHS
from repro_torch.configs.shapes import SHAPES, cell_applicable, input_specs
from repro_torch.core.convspec import ConvSpec
from repro_torch.launch.costmodel import conv_partition_costs
from repro_torch.launch.hlo_analysis import (COLLECTIVE_KINDS,
                                             collective_bytes, flops_bytes,
                                             roofline_terms)
from repro_torch.launch.mesh import axis_sizes, make_production_mesh
from repro_torch.models.lm import LM
from repro_torch.optim.adamw import AdamWConfig, tree_leaves
from repro_torch.parallel import tensor
from repro_torch.parallel.axes import default_rules, use_rules
from repro_torch.parallel.conv import (default_axis, normalize_partition,
                                       partition_name, sharded_conv2d)
from repro_torch.training import steps

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / \
    "dryrun_torch"

# One cell a partition mode, sized so the 16-way production axes divide
# it (specs pre-padded, VALID); the JAX package's cells.
CONV_CELLS = {
    "conv_channel": {"spec": ConvSpec(8, 56, 56, 64, 3, 3, 256, 1, 1),
                     "partition": "channel"},
    "conv_spatial": {"spec": ConvSpec(8, 224, 224, 3, 7, 7, 64, 2, 2),
                     "partition": "spatial"},
    "conv_batch_spatial": {
        "spec": ConvSpec(32, 224, 224, 3, 7, 7, 64, 2, 2),
        "partition": ("batch", "spatial")},
}


#: the fake backend, for the host's tensors and for meta ones (the
#: kernels' trace)
FAKE_BACKEND = "cpu:fake,meta:fake"


def fake_world(world_size: int, rank: int = 0) -> None:
    """Join a fake process group of ``world_size`` ranks as ``rank``
    (replacing any group this process is in)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size and \
                dist.get_rank() == rank and \
                dist.get_backend() == FAKE_BACKEND:
            return
        dist.destroy_process_group()
    dist.init_process_group(FAKE_BACKEND, store=FakeStore(), rank=rank,
                            world_size=world_size)


def _storage_bytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        s = t.untyped_storage()
        if id(s) not in seen:
            seen.add(id(s))
            total += s.nbytes()
    return total


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def measure(step, args) -> dict:
    """Run ``step(*args)`` once on fake tensors: ``(out, per-device
    counts)``: flops, collectives, memory."""
    from torch.distributed._tools.mem_tracker import MemTracker
    arg_leaves = _leaves(args)
    tracker = MemTracker()
    tracker.track_external(*arg_leaves)
    out = {}
    with tracker, collective_bytes() as coll:
        cost = flops_bytes(lambda: out.setdefault("value", step(*args)))
        alive = tracker.get_tracker_snapshot()
    peak = max(v["Total"] for v in tracker.get_tracker_snapshot(
        "peak").values())
    argument = _storage_bytes(arg_leaves)
    now = max(v["Total"] for v in alive.values())
    output = max(0, now - argument)
    return out["value"], {
        "flops": cost["flops"], "bytes_accessed": cost["bytes_accessed"],
        "collectives": dict(coll),
        "memory": {"argument_bytes": argument, "output_bytes": output,
                   "temp_bytes": max(0, peak - argument - output),
                   "peak_bytes": peak}}


def _local_rows(n: int, dp: int) -> int:
    """A data rank's rows: its share where the axis divides the batch, the
    whole batch where it does not (the JAX package's batch sharding drops
    an axis that does not divide)."""
    return n // dp if n % dp == 0 else n


def build_cell(arch: str, shape: str, mesh, rules, cfg=None):
    """``(step, args, cfg, cell, extra)`` of one LM cell on fake tensors
    (call inside ``FakeTensorMode``): the rank's parameters, moments and
    batch on ``meta``; ``extra`` holds the rank's parameter and moment
    bytes."""
    cfg = cfg or ARCHS[arch]
    cell = SHAPES[shape]
    model = LM(cfg)
    sizes = axis_sizes(mesh)
    dp = math.prod(sizes[a] for a in rules.dp_axes)
    # the whole tree (fake: no storage), then the rank's slices, as
    # params_from_jax cuts a whole tree
    params = tensor.shard_params(
        model.init(torch.Generator(), device="meta"), mesh, cfg,
        tensor.model_rank(mesh))
    extra = {"param_bytes": sum(t.nbytes for t in tree_leaves(params)),
             "moment_bytes": 0}
    if cell.kind == "decode":
        b = _local_rows(cell.global_batch, dp)
        from repro_torch.models import serve
        with use_rules(rules):
            cache = serve.init_decode_cache(model, b, cell.seq_len,
                                            device="meta")
        tokens = torch.zeros((b, 1), dtype=torch.int32, device="meta")
        return (steps.make_decode_step(model, rules),
                (params, cache, tokens), cfg, cell, extra)
    batch = {}
    for name, spec in input_specs(cfg, cell).items():
        shape_ = (_local_rows(spec.shape[0], dp),) + tuple(spec.shape[1:])
        batch[name] = torch.zeros(shape_, dtype=spec.dtype, device="meta")
    if cell.kind == "prefill":
        return (steps.make_prefill_step(model, cell.seq_len, rules),
                (params, batch), cfg, cell, extra)
    opt = steps.init_opt_state(params, model=model, rules=rules)
    extra["moment_bytes"] = steps._moment_bytes(opt)
    step = steps.make_zero1_train_step(model, AdamWConfig(total_steps=1000),
                                       rules)
    return step, (params, opt, batch), cfg, cell, extra


def _model_flops(cfg, cell) -> float:
    n = cfg.param_count(active_only=True)
    if cell.kind == "decode":
        return 2 * n * cell.global_batch
    if cell.kind == "prefill":
        return 2 * n * cell.seq_len * cell.global_batch
    return 6 * n * cell.seq_len * cell.global_batch


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: pathlib.Path,
             overrides=None, tag_suffix: str = "") -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    n_chips = 512 if multi_pod else 256
    fake_world(n_chips)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = default_rules(mesh)
    cfg = ARCHS[arch].with_(**overrides) if overrides else None
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True), torch.no_grad():
        step, args, cfg, cell, extra = build_cell(arch, shape, mesh, rules,
                                                  cfg=cfg)
        t_build = time.time() - t0
        _, per_device = measure(step, args)
    t_step = time.time() - t0 - t_build
    coll = per_device["collectives"]
    terms = roofline_terms(per_device["flops"], per_device["bytes_accessed"],
                           float(coll["total"]), n_chips=1)
    model_flops = _model_flops(cfg, cell)
    result = {
        "arch": arch, "shape": shape, "kind": cell.kind,
        "mesh": "2x16x16" if multi_pod else "16x16", "n_chips": n_chips,
        "build_s": round(t_build, 1), "step_s": round(t_step, 1),
        "per_device": dict(per_device, **extra),
        "roofline": terms,
        "model_flops_global": model_flops,
        "model_flops_per_chip": model_flops / n_chips,
        "useful_flop_ratio": (model_flops / n_chips)
        / max(per_device["flops"], 1.0),
    }
    if overrides:
        result["overrides"] = {k: str(v) for k, v in overrides.items()}
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{arch}__{shape}__{'multipod' if multi_pod else 'pod'}{tag_suffix}"
    (out_dir / f"{tag}.json").write_text(json.dumps(result, indent=2))
    print(f"[dryrun] {tag}: step={t_step:.0f}s "
          f"flops/dev={per_device['flops']:.3e} "
          f"coll/dev={coll['total']:.3e}B dominant={terms['dominant']}")
    return result


def _conv_probe(spec, partition, axis, mesh):
    """Rank's forward and backward counts of one conv cell (fake)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        x = torch.zeros((spec.i_n, spec.i_h, spec.i_w, spec.i_c),
                        device="meta", requires_grad=True)
        k = torch.zeros((spec.k_h, spec.k_w, spec.i_c, spec.k_c),
                        device="meta", requires_grad=True)
        state = {}

        def fwd():
            state["y"] = sharded_conv2d(
                x, k, stride=(spec.s_h, spec.s_w), padding="VALID",
                algorithm="mec_fused", partition=partition, axis=axis,
                mesh=mesh)

        with collective_bytes() as c_fwd:
            f_fwd = flops_bytes(fwd)["flops"]
        y = state["y"]
        with collective_bytes() as c_bwd:
            f_bwd = flops_bytes(lambda: (y * y).sum().backward())["flops"]
    return ({k_: c_fwd[k_] for k_ in COLLECTIVE_KINDS},
            {k_: c_bwd[k_] for k_ in COLLECTIVE_KINDS}, f_fwd + f_bwd)


def run_conv_cell(name: str, multi_pod: bool, out_dir: pathlib.Path) -> dict:
    """One sharded conv cell (forward and gradient) on the production mesh:
    rank 0 and a middle rank of the partition's axes each held to their
    own contract, the busiest rank to the busiest's, exactly."""
    from repro_torch.analysis.shardcheck import (halo_sends, rank_contract,
                                                 verify_collectives)
    cell = CONV_CELLS[name]
    spec, partition = cell["spec"], cell["partition"]
    parts = normalize_partition(partition)
    n_chips = 512 if multi_pod else 256
    fake_world(n_chips)
    mesh = make_production_mesh(multi_pod=multi_pod)
    axis = default_axis(partition, mesh, default_rules(mesh))
    axes = (axis,) if isinstance(axis, str) else axis
    sizes = axis_sizes(mesh)
    n_axes = tuple(sizes[a] for a in axes)
    replicated = n_chips // math.prod(n_axes)
    names = tuple(sizes)
    # the middle rank: coordinate 1 on every axis the partition uses
    middle = sum(math.prod(list(sizes.values())[i + 1:])
                 for i, a in enumerate(names) if a in axes)
    t0 = time.time()
    ranks, violations, flops = [], [], 0.0
    for rank in (0, middle):
        fake_world(n_chips, rank)
        mesh = make_production_mesh(multi_pod=multi_pod)
        index = (mesh.get_local_rank(axes[parts.index("spatial")])
                 if "spatial" in parts else None)
        c_fwd, c_bwd, flops = _conv_probe(spec, partition, axis, mesh)
        grad = {k: c_fwd[k] + c_bwd[k] for k in COLLECTIVE_KINDS}
        for direction, got in (("fwd", c_fwd), ("grad", grad)):
            required, optional = rank_contract(
                spec, parts, n_axes, 4, direction, spatial_index=index,
                replicated_ways=replicated)
            violations += verify_collectives(
                got, required, direction, label=f"{name} rank {rank}",
                optional=optional)
        ranks.append({"rank": rank, "spatial_index": index, "fwd": c_fwd,
                      "grad": grad})
    fake_world(n_chips)
    n_s = dict(zip(parts, n_axes)).get("spatial", 1)
    directions = {}
    for direction in ("fwd", "grad"):
        required, optional = rank_contract(spec, parts, n_axes, 4, direction,
                                           replicated_ways=replicated)
        busiest = {k: max(r[direction][k] for r in ranks)
                   for k in COLLECTIVE_KINDS}
        violations += verify_collectives(busiest, required, direction,
                                         label=f"{name} busiest",
                                         optional=optional)
        directions[direction] = {"expected": required, "optional": optional,
                                 "observed": busiest}
    shardcheck = {"verdict": "pass" if not violations else "fail",
                  "skipped_reason": None, "replicated_ways": replicated,
                  "halo_sends_busiest": halo_sends(n_s, "grad"),
                  "directions": directions, "ranks": ranks,
                  "violations": [v.render() for v in violations]}
    assert not violations, (
        f"{name}: the ranks' collectives break the shardcheck contract:\n  "
        + "\n  ".join(v.render() for v in violations))
    analytic = conv_partition_costs(
        spec, n_axes if len(parts) > 1 else n_axes[0])[
            parts if len(parts) > 1 else parts[0]]
    result = {
        "cell": name, "kind": "conv_grad", "algorithm": "mec_fused",
        "partition": partition_name(partition), "axis": list(axes),
        "n_axis": list(n_axes), "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": n_chips, "spec": dataclasses.asdict(spec),
        "step_s": round(time.time() - t0, 1),
        "per_device": {"flops": flops, "collectives": directions["grad"][
            "observed"]},
        "analytic": analytic, "shardcheck": shardcheck,
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{name}__{'multipod' if multi_pod else 'pod'}"
    (out_dir / f"{tag}.json").write_text(json.dumps(result, indent=2))
    print(f"[dryrun] {tag}: contract exact on ranks 0 and {middle}; "
          f"halo/dev={analytic['halo_bytes_per_device']:.3e}B")
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--conv", default=None,
                    help="a sharded_conv2d cell instead of an LM cell: one "
                         f"of {sorted(CONV_CELLS)} or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=str(RESULTS))
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    if args.conv:
        names = sorted(CONV_CELLS) if args.conv == "all" else [args.conv]
        failures = []
        for name in names:
            for mp in meshes:
                tag = f"{name}__{'multipod' if mp else 'pod'}"
                try:
                    run_conv_cell(name, mp, out_dir)
                except Exception as e:
                    failures.append(tag)
                    print(f"[dryrun] {tag}: FAILED {e}")
                    traceback.print_exc()
        if failures:
            raise SystemExit(f"{len(failures)} conv dry-run cells failed: "
                             + ", ".join(failures))
        print(f"[dryrun] all {len(names) * len(meshes)} conv cells OK")
        return

    archs = list(ARCHS) if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    cells = [(a, s, mp) for a in archs for s in shapes
             if cell_applicable(a, s) for mp in meshes]
    failures = []
    for arch, shape, mp in cells:
        tag = f"{arch}__{shape}__{'multipod' if mp else 'pod'}"
        if args.skip_existing and (out_dir / f"{tag}.json").exists():
            print(f"[dryrun] {tag}: cached")
            continue
        try:
            run_cell(arch, shape, mp, out_dir)
        except Exception as e:
            failures.append(tag)
            print(f"[dryrun] {tag}: FAILED {e}")
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run cells failed: "
                         + ", ".join(failures))
    print(f"[dryrun] all {len(cells)} cells OK")


if __name__ == "__main__":
    main()
