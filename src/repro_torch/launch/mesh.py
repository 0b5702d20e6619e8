"""Meshes and the processes behind them (counterpart of
``repro.launch.mesh``).

JAX sees every device from one process; PyTorch runs one process a rank.
So besides the two mesh builders this module holds the process plumbing
the JAX package has no counterpart of:

* :func:`init_world` joins the process group that ``torchrun`` describes
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``) and
  puts the rank on ``cuda:(LOCAL_RANK % device_count)``.
* :func:`spawn` starts ``world_size`` ranks of a function in fresh
  processes (the ``spawn`` start method: CUDA cannot be re-initialised
  after ``fork``), joined through a ``FileStore`` in a temporary
  directory, so parallel test workers never race for a port.  Every wait
  has a limit: the group's ``timeout`` and the join's.

The backend is a choice, never a fallback.  NCCL takes one card a rank
and refuses two ranks on one device ("Duplicate GPU detected"), so ranks
that share one card run under ``gloo``; :func:`init_world` raises for an
``nccl`` world larger than the cards it sees.

:func:`make_host_mesh` and :func:`make_production_mesh` build a
``torch.distributed.device_mesh.DeviceMesh`` over the initialised world.
:class:`AbstractMesh` is a mesh's shape and axis names with no processes
(the JAX package's ``AbstractMesh``), for specs and cost questions about
meshes larger than the world, such as the production (16, 16).
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")

#: seconds a collective may wait for a peer before the group fails it
DEFAULT_TIMEOUT_S = 60.0


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names, with no processes behind it."""

    shape_tuple: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.shape_tuple) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape_tuple} needs "
                             f"{len(self.shape_tuple)} axis names, got "
                             f"{self.axis_names}")


def axis_names(mesh) -> Tuple[str, ...]:
    """The axis names of a DeviceMesh or an AbstractMesh."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in mesh order (the JAX ``mesh.shape``)."""
    shape = mesh.shape_tuple if isinstance(mesh, AbstractMesh) \
        else tuple(mesh.shape)
    return dict(zip(axis_names(mesh), (int(n) for n in shape)))


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_type() -> str:
    """The DeviceMesh device type of this rank: ``cuda`` once the rank was
    put on a card (:func:`init_world`), else ``cpu``."""
    return "cuda" if torch.cuda.is_available() and \
        torch.cuda.is_initialized() else "cpu"


def _device_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("a DeviceMesh needs an initialised process group: "
                           "call launch.mesh.init_world (or run under "
                           "launch.mesh.spawn / torchrun) first")
    n = math.prod(shape)
    mesh = DeviceMesh(_device_type(), torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)
    if len(shape) > 1 and n < dist.get_world_size():
        # The group over all of a smaller mesh's axes (axes_group), made
        # now, while every rank of the world takes part.
        mesh.all_axes_group = dist.new_group(ranks=list(range(n)))
    return mesh


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) ``("data", "model")``, or (2, 16, 16) with ``"pod"``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = _world_size()
    if have < n:
        raise ValueError(
            f"need {n} devices for mesh {shape}, have {have} (run "
            f"{n} ranks: torchrun --nproc-per-node ...)")
    return _device_mesh(shape, axes)


def make_host_mesh(shape=None, axes=None):
    """Small mesh over the initialised world (tests, examples).

    shape=None uses every rank on a 1-D "data" axis.  An explicit shape
    without axes gets generated axis names ("ax0", "ax1", ...).  A shape
    smaller than the world takes the first ranks; the others hold no
    coordinate in it.
    """
    world = _world_size()
    if shape is None:
        shape = (world,)
        axes = axes or ("data",)
    shape = tuple(int(n) for n in shape)
    if axes is None:
        axes = tuple(f"ax{i}" for i in range(len(shape)))
    axes = tuple(axes)
    if len(axes) != len(shape):
        raise ValueError(f"mesh shape {shape} needs {len(shape)} axis "
                         f"names, got {axes}")
    n = math.prod(shape)
    if n > world:
        raise ValueError(f"need {n} devices for host mesh {shape}, "
                         f"have {world}")
    return _device_mesh(shape, axes)


def axes_group(mesh, axes: Sequence[str]):
    """The process group over the mesh axes ``axes``: one axis's own
    group; for every axis of a mesh, the world (a mesh that spans it) or
    the group its builder made over its ranks; for some axes of a mesh
    that spans the world, the group of those axes flattened (made by
    every rank, as a step builder runs on all of them: ("pod", "data") of
    the multipod mesh)."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    spans = mesh.size() == dist.get_world_size()
    if set(axes) == set(axis_names(mesh)):
        if spans:
            return dist.group.WORLD
        if hasattr(mesh, "all_axes_group"):
            return mesh.all_axes_group
    elif spans and set(axes) < set(axis_names(mesh)):
        # the mesh's rank bookkeeping is host data, also where a dry run
        # builds its step under FakeTensorMode
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        with unset_fake_temporarily():
            return mesh[axes]._flatten().get_group()
    raise ValueError(
        f"a group over mesh axes {axes} needs a mesh that spans the world "
        f"(or all of a smaller mesh's axes); mesh axes "
        f"{axis_names(mesh)}, {mesh.size()} of {dist.get_world_size()} "
        f"ranks")


# ---------------------------------------------------------------- processes

def _check_backend(backend: str, device: str, world_size: int) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if backend != "nccl":
        return
    if torch.device(device).type != "cuda":
        raise ValueError("backend 'nccl' runs on CUDA devices only; pass "
                         "--backend gloo for ranks on the CPU")
    cards = torch.cuda.device_count()
    if world_size > cards:
        raise ValueError(
            f"backend 'nccl' needs one card a rank: {world_size} ranks, "
            f"{cards} card(s) (NCCL refuses two ranks on one device); pass "
            "--backend gloo to run ranks that share a card")


def _rank_device(device: str, local_rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for and no CUDA card is "
                           "available; pass --device cpu")
    dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def default_backend(device: str) -> str:
    """The launchers' ``--backend`` default: ``nccl`` on the card (one card
    a rank), ``gloo`` on the CPU.  Ranks that share a card pass gloo."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_world(backend: str = "gloo", device: str = "cuda",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group ``torchrun`` describes in the environment;
    returns this rank's device.  Without ``WORLD_SIZE`` it is a world of
    one (no process group)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    _check_backend(backend, device, world)
    dev = _rank_device(device, local_rank)
    if world > 1 and not dist.is_initialized():
        dist.init_process_group(
            backend, timeout=datetime.timedelta(seconds=timeout_s),
            device_id=dev if backend == "nccl" else None)
    return dev


def _spawn_entry(rank: int, world_size: int, backend: str, device: str,
                 store_path: str, timeout_s: float, fn: Callable,
                 args: tuple, results) -> None:
    """One rank: join the group through the FileStore, run ``fn(*args)``,
    send back ``(rank, ok, result or traceback)``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_RANK=str(rank))
    # The ranks share the host's cores, as torchrun's OMP_NUM_THREADS
    # default keeps them from oversubscribing it.
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    try:
        dev = _rank_device(device, rank)
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s),
            device_id=dev if backend == "nccl" else None)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def spawn(fn: Callable, world_size: int, *, args: Sequence[Any] = (),
          backend: str = "gloo", device: str = "cpu",
          store_dir: Optional[str] = None,
          timeout_s: float = DEFAULT_TIMEOUT_S,
          join_timeout_s: float = 300.0) -> List[Any]:
    """Run ``fn(*args)`` on ``world_size`` fresh ranks; returns the ranks'
    results in rank order.  ``fn`` must be importable (a module-level
    function) and its result picklable.  A rank that raises, or a run
    that outlasts ``join_timeout_s``, stops every rank and raises here
    with the failing rank's traceback."""
    import torch.multiprocessing as mp
    _check_backend(backend, device, world_size)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        store_path = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_spawn_entry, daemon=True,
                             args=(r, world_size, backend, device,
                                   store_path, timeout_s, fn, tuple(args),
                                   results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        got: Dict[int, Any] = {}
        failure = None
        deadline = time.monotonic() + join_timeout_s
        try:
            while len(got) < world_size and failure is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    failure = (f"spawn: {world_size - len(got)} rank(s) "
                               f"still running after {join_timeout_s} s")
                    break
                try:
                    rank, ok, out = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        failure = (f"spawn: rank {dead[0]} died with exit "
                                   f"code {procs[dead[0]].exitcode}")
                    continue
                if ok:
                    got[rank] = out
                else:
                    failure = f"spawn: rank {rank} raised:\n{out}"
            if failure is not None:
                # A rank's error resets its peers' collectives: gather
                # what the others report for a moment, so the message
                # names the rank that failed first as well.
                until = time.monotonic() + 2.0
                while time.monotonic() < until:
                    try:
                        rank, ok, out = results.get(timeout=0.2)
                    except queue_mod.Empty:
                        continue
                    if not ok:
                        failure += f"\nspawn: rank {rank} raised:\n{out}"
        finally:
            for p in procs:
                p.join(timeout=5.0 if failure is None else 0.5)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5.0)
            results.close()
    if failure is not None:
        raise RuntimeError(failure)
    return [got[r] for r in range(world_size)]
