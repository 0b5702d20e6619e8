"""Persistent plan cache (counterpart of ``repro.plan.cache``): a process
LRU in front of one on-disk JSON file, so a decision survives the
process.

Layout: one JSON file per *environment fingerprint* under the cache
directory (``$REPRO_TORCH_PLAN_CACHE_DIR``, else ``$XDG_CACHE_HOME/
repro_torch/plans``, else ``~/.cache/repro_torch/plans``; the JAX
package's variable and directory are its own, so the two packages never
read each other's file), named ``<fingerprint-hash>.json``.  The
fingerprint hashes the plan schema version, torch's version, CUDA's
version and the name of the card (``cpu`` without one): any of them
changing switches to a fresh file, which is the invalidation rule.
Inside the file, plans are keyed by ``spec|dtype|backend``.

Disk I/O is best effort: an unreadable, corrupt or unwritable file
degrades to the memory tier, never to an error, and each such failure is
counted in ``PlanCache.io_errors``.  ``hits`` and ``misses`` count the
lookups (``plan_conv2d(mode="cached")``'s: a hit that does not satisfy
its request is a miss), ``disk_loads`` the file's reads.
Writes are atomic (a temporary file, then ``os.replace``).
"""
from __future__ import annotations

import collections
import hashlib
import json
import os
import pathlib
import tempfile
import threading
from typing import Optional

from repro_torch.plan.convplan import PLAN_VERSION, ConvPlan

CACHE_DIR_ENV = "REPRO_TORCH_PLAN_CACHE_DIR"
CACHE_FILE_VERSION = 1

_DEFAULT_MAX_ENTRIES = 4096


def device_kind() -> str:
    """The name of the card plans are made on, ``cpu`` without one."""
    import torch
    try:
        return torch.cuda.get_device_name(0) if torch.cuda.is_available() \
            else "cpu"
    except Exception:
        return "unknown"


def environment_fingerprint() -> str:
    """Short stable hash of everything that invalidates cached plans."""
    import torch
    raw = (f"plan{PLAN_VERSION}|torch{torch.__version__}|"
           f"cuda{torch.version.cuda}|{device_kind()}")
    return hashlib.sha256(raw.encode()).hexdigest()[:16]


def plan_cache_dir() -> pathlib.Path:
    env = os.environ.get(CACHE_DIR_ENV)
    if env:
        return pathlib.Path(env)
    xdg = os.environ.get("XDG_CACHE_HOME")
    base = pathlib.Path(xdg) if xdg else pathlib.Path.home() / ".cache"
    return base / "repro_torch" / "plans"


def write_json_atomic(path: pathlib.Path, doc) -> None:
    """Write ``doc`` to ``path`` through a temporary file in its directory
    and ``os.replace``; raises OSError."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), prefix=path.name,
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pathlib.Path(tmp).unlink(missing_ok=True)
        raise


class PlanCache:
    """LRU of :class:`ConvPlan` backed by one fingerprinted JSON file.

    ``path=None`` resolves the default per-environment file lazily, at
    first use, so building a cache touches neither torch.cuda nor the
    file system."""

    def __init__(self, path: Optional[pathlib.Path] = None,
                 max_entries: int = _DEFAULT_MAX_ENTRIES):
        self._path: Optional[pathlib.Path] = \
            pathlib.Path(path) if path is not None else None
        self._mem: "collections.OrderedDict[str, ConvPlan]" = \
            collections.OrderedDict()
        self._max_entries = max_entries
        self._disk_loaded = False
        self._lock = threading.Lock()
        # Swallowed disk failures (unreadable, corrupt, read-only): silent
        # per call, counted here for whoever reports on the cache.
        self.io_errors = 0
        self.hits = self.misses = self.disk_loads = 0

    def path(self) -> pathlib.Path:
        if self._path is None:
            self._path = plan_cache_dir() / f"{environment_fingerprint()}.json"
        return self._path

    def _load_disk_locked(self) -> None:
        if self._disk_loaded:
            return
        self._disk_loaded = True
        try:
            text = self.path().read_text()
        except FileNotFoundError:
            return            # a cache that is not there yet is fine
        except OSError:
            self.io_errors += 1
            return
        self.disk_loads += 1
        try:
            doc = json.loads(text)
        except ValueError:
            self.io_errors += 1  # corrupt file: degrade, but count it
            return
        if not isinstance(doc, dict) or \
                doc.get("plan_cache_version") != CACHE_FILE_VERSION:
            return
        for key, plan_doc in doc.get("plans", {}).items():
            if key in self._mem:
                continue  # memory (newer) wins over disk
            try:
                self._mem[key] = ConvPlan.from_dict(plan_doc)
            except (ValueError, KeyError, TypeError, AttributeError,
                    NotImplementedError):
                continue  # one stale entry never poisons the rest
        self._trim_locked()

    def _trim_locked(self) -> None:
        while len(self._mem) > self._max_entries:
            self._mem.popitem(last=False)

    def _flush_locked(self) -> None:
        doc = {"plan_cache_version": CACHE_FILE_VERSION,
               "plans": {k: p.to_dict() for k, p in self._mem.items()}}
        try:
            write_json_atomic(self.path(), doc)
        except OSError:
            self.io_errors += 1  # read-only environment: memory only now

    def get(self, key: str) -> Optional[ConvPlan]:
        """The plan under ``key`` or None, counted as a hit or a miss."""
        with self._lock:
            if key not in self._mem:
                self._load_disk_locked()
            plan = self._mem.get(key)
            if plan is not None:
                self._mem.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
            return plan

    def count_refused(self) -> None:
        """Count the last hit, which its caller could not use, as a miss."""
        with self._lock:
            self.hits -= 1
            self.misses += 1

    def put(self, key: str, plan: ConvPlan) -> None:
        with self._lock:
            self._load_disk_locked()  # merge before rewrite, not clobber
            self._mem[key] = plan
            self._mem.move_to_end(key)
            self._trim_locked()
            self._flush_locked()

    def __len__(self) -> int:
        with self._lock:
            return len(self._mem)


_global_cache: Optional[PlanCache] = None
_global_lock = threading.Lock()


def global_plan_cache() -> PlanCache:
    """The process-level cache ``plan_conv2d(mode="cached")`` and the
    ``conv2d`` auto path share."""
    global _global_cache
    with _global_lock:
        if _global_cache is None:
            _global_cache = PlanCache()
        return _global_cache


def reset_global_plan_cache() -> None:
    """Forget the process-level cache object (point
    $REPRO_TORCH_PLAN_CACHE_DIR elsewhere, then reset)."""
    global _global_cache
    with _global_lock:
        _global_cache = None
