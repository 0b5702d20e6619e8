"""Fault-tolerant checkpointing (counterpart of ``repro.ckpt.manager``),
with the JAX package's on-disk layout, so either package restores the
other's checkpoints.

* **Atomic**: leaves are written into ``step_N.tmp/`` and the directory is
  renamed to ``step_N/`` (``step_%08d``) only after an fsync'd
  ``manifest.json`` (step; per tree, per leaf: file, shape, dtype name) - a
  crash mid-save never corrupts the latest checkpoint.
* **Async**: ``save_async`` copies the tensors to host memory before it
  returns, then writes on a background thread; training continues.
  ``wait()`` joins before the next save (bounded in flight = 1).
* **Exact resume**: the data-pipeline state dict rides along.
* **Retention**: keep the newest ``keep`` checkpoints.

One ``.npy`` a leaf, named by its path in the tree (``a/b`` ->
``a__b.npy``; dict keys sorted, list items by index, ``None`` leaves
skipped, as ``jax.tree_util`` flattens).  numpy has no bfloat16 or float8:
those leaves are stored as a same-width unsigned integer view, made and
read back through torch, with the dtype's name in the manifest.

Under tensor parallelism (``shardings``: per tree, a tree of
``parallel.tensor.Sharding``, from ``tensor.shardings``) a save gathers
each split leaf over its "model" group, so the files hold the whole
arrays, the JAX package's layout, and only the world's rank 0 writes;
a restore loads the whole arrays and keeps the rank's pieces.  So a
checkpoint saved on one layout restores onto any other (the JAX
package's elastic ``restore(..., shardings=)``), world 1 included.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

# dtypes numpy cannot serialise: the torch dtype, the signed integer view
# of its width (torch and numpy) and the unsigned view stored on disk
_EXOTIC = {
    "bfloat16": (torch.bfloat16, torch.int16, np.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.int8, np.int8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.int8, np.int8, np.uint8),
}
_TORCH_NAMES = {entry[0]: name for name, entry in _EXOTIC.items()}


def _to_host(leaf):
    """(numpy array, dtype name) of a tensor or array, on the host."""
    if isinstance(leaf, torch.Tensor):
        # a copy even of a CPU tensor: the caller may write it next
        t = leaf.detach().to("cpu", memory_format=torch.contiguous_format,
                             copy=True)
        name = _TORCH_NAMES.get(t.dtype)
        if name is not None:
            _, signed, _, unsigned = _EXOTIC[name]
            return t.view(signed).numpy().view(unsigned), name
        arr = t.numpy()
        return arr, arr.dtype.name
    arr = np.asarray(leaf)
    return arr, arr.dtype.name


def _saved_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """The stored array as a CPU tensor of its saved dtype."""
    arr = np.array(arr, order="C")       # writable and contiguous, any ndim
    if dtype_name in _EXOTIC:
        dt, _, signed, _ = _EXOTIC[dtype_name]
        return torch.from_numpy(arr.view(signed)).view(dt)
    return torch.from_numpy(arr)


def _as_like(t: torch.Tensor, dtype_name: str, like):
    """The stored tensor as the like leaf's kind: a tensor of its dtype and
    shape on its device, or a numpy array."""
    if isinstance(like, torch.Tensor):
        if t.dtype != like.dtype or tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf {dtype_name}{tuple(t.shape)} "
                             f"does not match {like.dtype}"
                             f"{tuple(like.shape)}")
        return t.to(like.device)
    return t.numpy()


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _unflatten(like, loaded: Dict[str, Any], prefix: str = ""):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(v, loaded, f"{prefix}{k}/")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, loaded, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    return loaded[prefix[:-1]]


def _host_copy(trees: Dict[str, Any]) -> Dict[str, Dict[str, tuple]]:
    return {name: {key: _to_host(leaf)
                   for key, leaf in _flatten(tree).items()}
            for name, tree in trees.items()}


def _whole(trees: Dict[str, Any], shardings) -> Dict[str, Any]:
    """``trees`` with every leaf that has a Sharding gathered whole."""
    if not shardings:
        return trees
    out = {}
    for name, tree in trees.items():
        sh = _flatten(shardings.get(name))
        flat = {key: sh[key].gather(leaf) if key in sh else leaf
                for key, leaf in _flatten(tree).items()}
        out[name] = _unflatten(tree, flat)
    return out


def _writes() -> bool:
    """Whether this process writes: the world's rank 0 (or no world)."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- save --
    def save(self, step: int, trees: Dict[str, Any],
             shardings: Optional[Dict[str, Any]] = None) -> None:
        """Synchronous atomic save. trees: name -> tree.  With
        ``shardings`` every rank calls it (the split leaves are gathered)
        and rank 0 writes."""
        trees = _whole(trees, shardings)
        if shardings is None or _writes():
            self._write(step, _host_copy(trees))

    def save_async(self, step: int, trees: Dict[str, Any],
                   shardings: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        trees = _whole(trees, shardings)
        if shardings is not None and not _writes():
            return
        # copy to host memory before returning control to the step loop
        host = _host_copy(trees)
        self._thread = threading.Thread(target=self._write,
                                        args=(step, host), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host) -> None:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "trees": {}}
        for name, flat in host.items():
            tdir = tmp / name
            tdir.mkdir()
            entries = {}
            for key, (arr, dtype_name) in flat.items():
                fname = key.replace("/", "__") + ".npy"
                np.save(tdir / fname, arr)
                entries[key] = {"file": fname, "shape": list(arr.shape),
                                "dtype": dtype_name}
            manifest["trees"][name] = entries
        mpath = tmp / "manifest.json"
        mpath.write_text(json.dumps(manifest))
        fd = os.open(mpath, os.O_RDONLY)
        os.fsync(fd)
        os.close(fd)
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        for step in self.all_steps()[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{step:08d}", ignore_errors=True)

    # ---------------------------------------------------------- restore --
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Dict[str, Any],
                shardings: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Trees with the structure of ``like``: each tensor leaf back as a
        tensor of its like leaf's dtype and shape on its device, each numpy
        leaf as numpy.  ``shardings`` (per tree, a tree of
        ``parallel.tensor.Sharding`` over the current mesh; trees or leaves
        without one are whole): each such leaf is the rank's pieces of the
        stored whole array."""
        cdir = self.dir / f"step_{step:08d}"
        manifest = json.loads((cdir / "manifest.json").read_text())
        out = {}
        for name, tree in like.items():
            entries = manifest["trees"][name]
            sh = _flatten(shardings.get(name)) if shardings else {}
            loaded = {}
            for key, leaf in _flatten(tree).items():
                dtype_name = entries[key]["dtype"]
                t = _saved_tensor(np.load(cdir / name / entries[key]["file"]),
                                  dtype_name)
                if key in sh:
                    t = sh[key].take(t)
                loaded[key] = _as_like(t, dtype_name, leaf)
            out[name] = _unflatten(tree, loaded)
        return out
