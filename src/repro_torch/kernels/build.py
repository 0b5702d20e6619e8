"""Build the hand-written CUDA kernels under ``csrc/`` and load them.

Each library ``<name>`` of :data:`LIBRARIES` is compiled from its
``csrc/*.cu`` sources, each with a plain C interface, by one ``nvcc`` for
Hopper (``sm_90a``) into ``build/kernels/lib<name>-<hash>.so`` at the
repository root, on first use; the hash covers the sources and the
flags, so an edited source rebuilds and an unchanged one is reused.  The
library is loaded with ``ctypes``.  There is no fallback: a missing
``nvcc`` or a failed build raises.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
# <repo>/build/kernels: src/repro_torch/kernels/build.py -> parents[3].
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              # register/shared-memory/spill report per kernel, kept in the log
              "-Xptxas", "-v")


#: the kernel libraries and the ``csrc/`` sources each is built from: K1-K4
#: (``mec_conv.cu``) with K6, the MEC weight gradient (``mec_wgrad.cu``, a
#: translation unit of its own); K5
LIBRARIES = {"mec_conv": ("mec_conv.cu", "mec_wgrad.cu"),
             "mec_conv1d": ("mec_conv1d.cu",)}


def sources() -> list:
    """Names of the kernel libraries."""
    return sorted(LIBRARIES)


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, CUDA_PATH, /usr/local/cuda, PATH): "
            "the repro_torch CUDA kernels are built from source on first use")
    return found


def library_path(name: str) -> Path:
    if name not in LIBRARIES:
        raise FileNotFoundError(f"no kernel library {name!r}")
    srcs = [CSRC / f for f in LIBRARIES[name]]
    digest = hashlib.sha256()
    for path in srcs + sorted(CSRC.glob("*.cuh")):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named sources (default: all) that are not built yet,
    one ``nvcc`` each, all started together.  Returns, per name, the
    library path, whether it was compiled now, the seconds taken and the
    compiler's output.  Raises if any build fails.  ``build.compiles`` and
    ``build.seconds`` sum the compiles of the process and their seconds."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    started = {}
    results = {}
    t0 = time.perf_counter()
    for name in names:
        lib = library_path(name)
        if lib.is_file():
            log = lib.with_suffix(".log")
            results[name] = {"path": str(lib), "compiled": False, "seconds": 0.0,
                             "log": log.read_text() if log.is_file() else ""}
            continue
        nvcc = nvcc or nvcc_path()
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               *(str(CSRC / f) for f in LIBRARIES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, lib, tmp, cmd)
    failures = []
    for name, (proc, lib, tmp, cmd) in started.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{' '.join(cmd)}\nexit {proc.returncode}\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)     # atomic: a concurrent build sees all or nothing
        results[name] = {"path": str(lib), "compiled": True,
                         "seconds": seconds, "log": log}
        build.compiles += 1
        build.seconds += seconds
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n\n".join(failures))
    return results


build.compiles = 0
build.seconds = 0.0


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, compiling it first if needed.  The
    caller declares ``argtypes``/``restype`` of what it calls."""
    return ctypes.CDLL(build([name])[name]["path"])
