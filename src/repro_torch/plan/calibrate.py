"""Fitted costmodel calibration, the half the planner consults
(counterpart of ``repro.plan.calibrate``).

The paper's analytic model (Eqs. 2-4) ranks lowerings by memory
overhead, but the right pick depends on the machine.  This module keeps
the planner's own measurements and turns them into corrections the
costmodel consults, for one backend ("cpu" or "cuda") and one device:

* **time samples**: every trial ``plan_conv2d(mode="measured")`` times,
  keyed ``spec|dtype|algorithm|solution|w_blk``;
* **memory samples**: measured/predicted temporary-byte ratios, keyed
  ``spec|dtype|algorithm`` (``add_memory``; what reads memory reports
  into it waits for ROADMAP Queue 1 item 7).

:meth:`Calibration.fit` gives ``time_cells`` (per cell, the best median
us per algorithm: where a cell's evidence covers the analytic pick and a
rival, ``pick_conv2d_algorithm`` defers to it through ``pick_measured``'s
noise margin), ``time_constants`` (per algorithm, least squares of ``us ~
c0 + c_flops*flops + c_overhead*overhead_elems``), ``mem_ratio`` (per
algorithm, the geometric mean measured/Eq. 2-3 byte ratio) and
``decisions`` (per cell, the paper rule's pick against the calibrated
one).

Persistence mirrors ``repro_torch.plan.cache.PlanCache``: one JSON file
per backend and environment fingerprint beside the plan cache
(``calibration-<backend>-<fingerprint>.json``), best-effort I/O counted
in ``CalibrationStore.io_errors``, atomic writes.  A torch process may
plan for the CPU and the card alike, so where the JAX package reads the
process's one backend, every lookup here names its backend.
``$REPRO_TORCH_CALIBRATION`` points the ambient lookup at an explicit
file instead, matched on backend and device rather than the whole
fingerprint.  Reading bench and memaudit reports into a calibration
(``ingest_autotune``, ``ingest_memaudit``, ``check_calibration``, the
``python -m repro.plan calibrate`` CLI) waits for item 7.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.convspec import ConvSpec
from repro_torch.plan.cache import (device_kind, environment_fingerprint,
                                    plan_cache_dir, write_json_atomic)
from repro_torch.plan.convplan import spec_key

CALIBRATION_FILE_VERSION = 1
CALIBRATION_ENV = "REPRO_TORCH_CALIBRATION"

# Keep the last N samples per (spec, dtype, algorithm, solution, w_blk)
# key: enough to median away scheduler noise, bounded so a long tuning
# loop cannot grow the file without limit.
MAX_SAMPLES_PER_KEY = 32


def calibration_path(backend: str = "cuda") -> pathlib.Path:
    """The fingerprinted store file of ``backend`` beside the plan cache."""
    return (plan_cache_dir()
            / f"calibration-{backend}-{environment_fingerprint()}.json")


def time_sample_key(spec: ConvSpec, dtype: str, algorithm: str,
                    solution: str = "auto",
                    w_blk: Optional[int] = None) -> str:
    blk = "-" if w_blk is None else str(int(w_blk))
    return f"{spec_key(spec)}|{dtype}|{algorithm}|{solution}|{blk}"


def mem_sample_key(spec: ConvSpec, dtype: str, algorithm: str) -> str:
    return f"{spec_key(spec)}|{dtype}|{algorithm}"


def parse_spec_key(key: str) -> ConvSpec:
    """Inverse of ``repro_torch.plan.spec_key`` (sample keys embed it)."""
    dims, kpart, spart = key.split("-")
    i_n, i_h, i_w, i_c = (int(v) for v in dims.split("x"))
    k_h, k_w, k_c = (int(v) for v in kpart[1:].split("x"))
    s_h, s_w = (int(v) for v in spart[1:].split("x"))
    return ConvSpec(i_n, i_h, i_w, i_c, k_h, k_w, k_c, s_h, s_w)


def _geomean(values: List[float]) -> float:
    return math.exp(sum(math.log(max(v, 1e-12)) for v in values)
                    / len(values))


def _features(spec: ConvSpec, algorithm: str) -> Tuple[float, float]:
    """(flops, overhead_elems) of the Eq. 2-4 time model for one trial:
    the overhead of ``core.memory.algorithm_overhead`` (the fused kernels
    predict the direct conv's zero overhead), the flops of the base
    algorithm in ``conv2d_algorithm_costs`` (every MEC variant computes
    the same mult-adds)."""
    from repro_torch.core import memory
    from repro_torch.launch.costmodel import conv2d_algorithm_costs
    overhead = float(memory.algorithm_overhead(spec, algorithm))
    costs = conv2d_algorithm_costs(spec)
    base = algorithm if algorithm in costs else \
        ("mec" if algorithm.startswith("mec") else algorithm)
    flops = float(costs[base]["flops"]) if base in costs \
        else float(memory.conv_flops(spec))
    return flops, overhead


def _device_kind(backend: str) -> str:
    return device_kind() if backend == "cuda" else "cpu"


@dataclasses.dataclass
class Calibration:
    """Accumulated measurements and the fits derived from them, for one
    (backend, device kind).  A calibration only applies to picks made for
    ``self.backend``."""

    backend: str
    device_kind: str
    fingerprint: str
    time_samples: Dict[str, List[float]] = dataclasses.field(
        default_factory=dict)
    mem_samples: Dict[str, List[float]] = dataclasses.field(
        default_factory=dict)

    @classmethod
    def for_current_env(cls, backend: str = "cuda") -> "Calibration":
        return cls(backend=backend, device_kind=_device_kind(backend),
                   fingerprint=environment_fingerprint())

    def is_empty(self) -> bool:
        return not self.time_samples and not self.mem_samples

    # ------------------------------------------------------------ recording

    def add_time(self, spec: ConvSpec, dtype: str, algorithm: str,
                 us: float, solution: str = "auto",
                 w_blk: Optional[int] = None) -> None:
        key = time_sample_key(spec, dtype, algorithm, solution, w_blk)
        samples = self.time_samples.setdefault(key, [])
        samples.append(float(us))
        del samples[:-MAX_SAMPLES_PER_KEY]

    def add_memory(self, spec: ConvSpec, dtype: str, algorithm: str,
                   ratio: float) -> None:
        key = mem_sample_key(spec, dtype, algorithm)
        samples = self.mem_samples.setdefault(key, [])
        samples.append(float(ratio))
        del samples[:-MAX_SAMPLES_PER_KEY]

    def merge(self, other: "Calibration") -> None:
        for mine_all, theirs in ((self.time_samples, other.time_samples),
                                 (self.mem_samples, other.mem_samples)):
            for key, samples in theirs.items():
                mine = mine_all.setdefault(key, [])
                mine.extend(samples)
                del mine[:-MAX_SAMPLES_PER_KEY]

    # -------------------------------------------------------------- fitting

    def time_cells(self) -> Dict[str, Dict[str, float]]:
        """spec-key -> algorithm -> best (min over solution/w_blk/dtype
        variants) median us: the cell-level evidence picks consult."""
        cells: Dict[str, Dict[str, float]] = {}
        for key, samples in self.time_samples.items():
            if not samples:
                continue
            spec_part, _dtype, alg, _sol, _blk = key.split("|")
            med = float(np.median(samples))
            algs = cells.setdefault(spec_part, {})
            algs[alg] = min(algs.get(alg, med), med)
        return cells

    def cell_times(self, spec: ConvSpec) -> Dict[str, float]:
        return self.time_cells().get(spec_key(spec), {})

    def mem_ratios(self) -> Dict[str, Dict[str, float]]:
        """algorithm -> {ratio (geomean), n} of measured/predicted bytes."""
        by_alg: Dict[str, List[float]] = {}
        for key, samples in self.mem_samples.items():
            by_alg.setdefault(key.split("|")[2], []).extend(samples)
        return {alg: {"ratio": _geomean(samples), "n": len(samples)}
                for alg, samples in sorted(by_alg.items()) if samples}

    def mem_ratio_for(self, algorithm: str) -> float:
        """Fitted byte ratio for one algorithm; 1.0 (the paper's implicit
        constant) when unfitted."""
        entry = self.mem_ratios().get(algorithm)
        return float(entry["ratio"]) if entry else 1.0

    def time_constants(self) -> Dict[str, Dict[str, float]]:
        """Per-algorithm least-squares constants of the Eq. 2-4 time model
        ``us ~ c0 + c_flops*flops + c_overhead*overhead_elems``, used for
        ``time_us_est``; picks never extrapolate through these."""
        by_alg: Dict[str, List[Tuple[float, float, float]]] = {}
        for cell, algs in self.time_cells().items():
            spec = parse_spec_key(cell)
            for alg, us in algs.items():
                flops, overhead = _features(spec, alg)
                by_alg.setdefault(alg, []).append((flops, overhead, us))
        out: Dict[str, Dict[str, float]] = {}
        for alg, rows in sorted(by_alg.items()):
            a = np.array([[1.0, f, o] for f, o, _ in rows])
            b = np.array([us for _, _, us in rows])
            coef, *_ = np.linalg.lstsq(a, b, rcond=None)
            out[alg] = {"c0": float(coef[0]), "c_flops": float(coef[1]),
                        "c_overhead": float(coef[2]), "n": len(rows)}
        return out

    def time_estimate(self, spec: ConvSpec, algorithm: str,
                      constants: Optional[Dict] = None) -> Optional[float]:
        constants = self.time_constants() if constants is None else constants
        c = constants.get(algorithm)
        if c is None:
            return None
        flops, overhead = _features(spec, algorithm)
        return c["c0"] + c["c_flops"] * flops + c["c_overhead"] * overhead

    def decisions(self) -> Dict[str, Dict[str, str]]:
        """Per evidence cell: the paper rule's pick and the calibrated
        pick."""
        from repro_torch.launch.costmodel import pick_conv2d_algorithm
        out: Dict[str, Dict[str, str]] = {}
        for cell in sorted(self.time_cells()):
            spec = parse_spec_key(cell)
            out[cell] = {
                "uncalibrated": pick_conv2d_algorithm(
                    spec, self.backend, calibration=None),
                "calibrated": pick_conv2d_algorithm(
                    spec, self.backend, calibration=self),
            }
        return out

    def fit(self) -> Dict:
        return {
            "time_cells": self.time_cells(),
            "time_constants": self.time_constants(),
            "mem_ratio": self.mem_ratios(),
            "decisions": self.decisions(),
        }

    # -------------------------------------------------------- serialization

    def to_dict(self, with_fit: bool = True) -> Dict:
        import torch
        doc = {
            "calibration_file_version": CALIBRATION_FILE_VERSION,
            "fingerprint": self.fingerprint,
            "backend": self.backend,
            "device_kind": self.device_kind,
            "torch": torch.__version__,
            "time_samples": {k: list(v) for k, v
                             in sorted(self.time_samples.items())},
            "mem_samples": {k: list(v) for k, v
                            in sorted(self.mem_samples.items())},
        }
        if with_fit:
            doc["fitted"] = self.fit()
        return doc

    @classmethod
    def from_dict(cls, doc: Dict) -> "Calibration":
        version = doc.get("calibration_file_version")
        if version != CALIBRATION_FILE_VERSION:
            raise ValueError(f"calibration_file_version {version!r} is not "
                             f"{CALIBRATION_FILE_VERSION}")
        return cls(
            backend=doc["backend"],
            device_kind=doc.get("device_kind", "unknown"),
            fingerprint=doc.get("fingerprint", ""),
            time_samples={str(k): [float(x) for x in v]
                          for k, v in doc.get("time_samples", {}).items()},
            mem_samples={str(k): [float(x) for x in v]
                         for k, v in doc.get("mem_samples", {}).items()},
        )


def resolve_calibration(calibration, backend: str) -> Optional[Calibration]:
    """``"ambient"`` | None | Calibration -> the Calibration a pick for
    ``backend`` may consult (None when absent or fitted on another
    backend)."""
    if calibration is None:
        return None
    if isinstance(calibration, str):
        if calibration != "ambient":
            raise ValueError(f"calibration is 'ambient', None or a "
                             f"Calibration, got {calibration!r}")
        calibration = current_calibration(backend)
        if calibration is None:
            return None
    return calibration if calibration.backend == backend else None


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------

class CalibrationStore:
    """Best-effort accumulation into the fingerprinted store file of one
    backend.  ``add_time``/``add_memory`` buffer in memory; ``flush()``
    merges the buffer into what is on disk (load, merge, atomic rewrite),
    so concurrent tuning runs append rather than clobber.  Disk failures
    degrade silently and count in ``io_errors``."""

    def __init__(self, path: Optional[pathlib.Path] = None,
                 backend: str = "cuda"):
        self._explicit_path = pathlib.Path(path) if path is not None else None
        self.backend = backend
        self.pending = Calibration.for_current_env(backend)
        self.io_errors = 0

    def path(self) -> pathlib.Path:
        if self._explicit_path is not None:
            return self._explicit_path
        return calibration_path(self.backend)

    def add_time(self, spec: ConvSpec, dtype: str, algorithm: str,
                 us: float, solution: str = "auto",
                 w_blk: Optional[int] = None) -> None:
        self.pending.add_time(spec, dtype, algorithm, us, solution, w_blk)

    def add_memory(self, spec: ConvSpec, dtype: str, algorithm: str,
                   ratio: float) -> None:
        self.pending.add_memory(spec, dtype, algorithm, ratio)

    def load(self) -> Calibration:
        """The on-disk calibration, or a fresh empty one.  A file of
        another environment or backend is ignored, the PlanCache rule."""
        fresh = Calibration.for_current_env(self.backend)
        try:
            text = self.path().read_text()
        except FileNotFoundError:
            return fresh
        except OSError:
            self.io_errors += 1
            return fresh
        try:
            calib = Calibration.from_dict(json.loads(text))
        except (ValueError, KeyError, TypeError, AttributeError):
            self.io_errors += 1       # corrupt file: degrade, but count it
            return fresh
        if (calib.fingerprint, calib.backend) != \
                (fresh.fingerprint, fresh.backend):
            return fresh
        return calib

    def flush(self) -> None:
        if self.pending.is_empty():
            return
        disk = self.load()
        disk.merge(self.pending)
        self.pending = Calibration.for_current_env(self.backend)
        path = self.path()
        try:
            write_json_atomic(path, disk.to_dict())
        except OSError:
            self.io_errors += 1       # read-only environment: drop silently
        _load_cache.pop((str(path), self.backend), None)


# Ambient lookup cache: (path, backend) -> (stat signature, Calibration or
# None).  Keyed by path, so repointing the environment variables takes
# effect at once.
_load_cache: Dict[Tuple[str, str], Tuple[Optional[Tuple[int, int]],
                                         Optional[Calibration]]] = {}


def _load_file(path: pathlib.Path, backend: str,
               strict_fingerprint: bool) -> Optional[Calibration]:
    try:
        st = path.stat()
        sig = (st.st_mtime_ns, st.st_size)
    except OSError:
        sig = None
    cached = _load_cache.get((str(path), backend))
    if cached is not None and cached[0] == sig:
        return cached[1]
    calib: Optional[Calibration] = None
    if sig is not None:
        try:
            calib = Calibration.from_dict(json.loads(path.read_text()))
        except (OSError, ValueError, KeyError, TypeError, AttributeError):
            calib = None              # silent degradation to uncalibrated
    if calib is not None:
        if calib.backend != backend:
            calib = None
        elif strict_fingerprint:
            if calib.fingerprint != environment_fingerprint():
                calib = None
        elif calib.device_kind != _device_kind(backend):
            calib = None              # an explicit file from another device
    _load_cache[(str(path), backend)] = (sig, calib)
    return calib


def reset_calibration_cache() -> None:
    """Forget memoized file loads."""
    _load_cache.clear()


def current_calibration(backend: str = "cuda") -> Optional[Calibration]:
    """The ambient calibration for ``backend``: $REPRO_TORCH_CALIBRATION
    (an explicit file, matched on backend and device) if set, else the
    fingerprinted store beside the plan cache.  None (the paper's
    constants) when absent, corrupt, empty or of another environment."""
    env = os.environ.get(CALIBRATION_ENV)
    if env:
        calib = _load_file(pathlib.Path(env), backend,
                           strict_fingerprint=False)
    else:
        calib = _load_file(calibration_path(backend), backend,
                           strict_fingerprint=True)
    if calib is None or calib.is_empty():
        return None
    return calib


def calibration_info(backend: str = "cuda") -> Dict:
    """Provenance for reports: is a calibration active for ``backend``,
    and where did it come from?"""
    env = os.environ.get(CALIBRATION_ENV)
    calib = current_calibration(backend)
    return {
        "active": calib is not None,
        "source": (f"env:{env}" if env else
                   (f"store:{calibration_path(backend)}" if calib is not None
                    else None)),
        "backend": None if calib is None else calib.backend,
        "cells": 0 if calib is None else len(calib.time_cells()),
    }
