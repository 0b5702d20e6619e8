#!/usr/bin/env python3
"""K5's device time on the L2-cold timer, for source trees and variants.

    python3 tools/conv1d_probe.py [--variants tt16,...] [ROOT ...]

Run from the repository root on a machine with a CUDA card and nvcc.
Each ROOT is a checkout of this repository (default: this one, unless
variants are given); each variant is a copy of this tree's
``src/repro_torch`` under ``build/conv1d_probe/<variant>/`` with textual
edits to ``csrc/mec_conv1d.cu``:

  tt8      8 time steps a thread, not 16
  c64      CTAs of 64 threads, not 128
  stcs     streaming (evict-first) stores of the output
  copy     no arithmetic: the output is the input at the same step (wrong
           by design, so not checked), the same loads and stores

Every tree's ``mec_conv1d.cu`` is built first, all at once.  Then, in the
order given (ROOTs, then variants), one worker process a tree imports
that tree's ``repro_torch`` and runs ``chip_smoke.conv1d_timing`` of this
tree on it: K5 checked against its plain version at the zamba2-7b conv
input (4, 512, 7296, k_w = 4, bf16, a column slice of the in_proj output),
then K5, the plain version, cuDNN's depthwise conv1d and two copies of
the same bytes, each on the L2-cold timer (``chip_smoke.cold_ms``).  To compare two trees
on one card, give them in turns: ``parent . . parent``.  Prints the
nvidia-smi line, then one JSON line a worker.  Imports torch and the port
only.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "conv1d_probe"
VARIANTS = {
    "tt8": [("constexpr int kTimeTile = 16;", "constexpr int kTimeTile = 8;")],
    "c64": [("constexpr int kThreads = 128;", "constexpr int kThreads = 64;")],
    "stcs": [("    *reinterpret_cast<R*>(outr + s * c) = o.raw;",
              "    __stcs(reinterpret_cast<R*>(outr + s * c), o.raw);")],
    "copy": [("        acc = __fadd_rn(acc, __fmul_rn(to_f32<T>(win[j].e[e]), "
              "to_f32<T>(w[j].e[e])));",
              "        acc = to_f32<T>(win[KW - 1].e[e]);")],
}


# variants whose output is wrong by design
UNCHECKED = {"copy"}


def make_variant(name: str) -> Path:
    """A tree whose src/repro_torch is this one's with the variant's edits
    to csrc/mec_conv1d.cu (each must match once)."""
    tree = OUT / name
    if tree.exists():
        shutil.rmtree(tree)
    shutil.copytree(ROOT / "src" / "repro_torch", tree / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = tree / "src" / "repro_torch" / "kernels" / "csrc" / "mec_conv1d.cu"
    text = path.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} not found once")
        text = text.replace(old, new)
    path.write_text(text)
    return tree


def build_all(trees) -> None:
    """Build each tree's mec_conv1d library, all at once."""
    procs = []
    for tree in dict.fromkeys(trees):
        env = {**os.environ, "PYTHONPATH": str(tree / "src")}
        procs.append(subprocess.Popen(
            [sys.executable, "-c",
             "from repro_torch.kernels import build; build.build(['mec_conv1d'])"],
            env=env, cwd=tree))
    for proc in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"a build failed: {proc.args}")


def worker(tree: Path) -> None:
    import torch
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    import repro_torch
    from repro_torch.kernels import mec_conv1d as C
    if not Path(repro_torch.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"repro_torch imported from {repro_torch.__file__}")
    if not torch.cuda.is_available():
        raise SystemExit("conv1d_probe: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    peak_flops, peak_bw, *_ = chip_smoke.peaks_for(torch.cuda.get_device_name(0))
    C._lib()
    gen = torch.Generator(device=chip_smoke.DEVICE).manual_seed(0)
    row = chip_smoke.conv1d_timing(C, gen, 4, peak_flops, peak_bw,
                                   check_plain=tree.name not in UNCHECKED)
    print(json.dumps({"tree": str(tree), **row}), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("roots", nargs="*")
    parser.add_argument("--variants", default="")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        worker(Path(args.worker).resolve())
        return 0
    variants = [v for v in args.variants.split(",") if v]
    trees = [Path(r).resolve() for r in args.roots or ([] if variants else ["."])]
    trees += [make_variant(v) for v in variants]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
        flush=True)
    build_all(trees)
    for tree in trees:
        subprocess.run([sys.executable, __file__, "--worker", str(tree)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
