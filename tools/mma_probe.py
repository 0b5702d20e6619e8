#!/usr/bin/env python3
"""Where K1's, K3's and K4's time goes on the card: time kernels built
from variants of their source, each with one part of the work taken out.

    python3 tools/mma_probe.py [--variants base,no_mma,...]
                               [--layers cv4,cv11] [--dtypes float32,bfloat16]

Run from the repository root on a machine with a CUDA card and nvcc.
Each variant is a copy of ``src/repro_torch/kernels/csrc`` with textual
edits, compiled by nvcc (all variants at once) into
``build/probe/<variant>/``.  Only ``base`` and ``strides`` compute the
convolution; the others time a mutilated kernel and their outputs are
meaningless:

  base        the kernels as they are
  no_mma      no tensor-core products (fragments, copies, syncs remain)
  no_stage    no global-to-shared copies after the ring's first fill
  frags_only  neither: fragment loads, syncs, prologue and epilogue
  one_step    each CTA runs one reduction step: the fixed cost a tile
  warp64x32   16-bit types at 128 rows as 4 warps of 64 x 32, not 8 of
              32 x 32
  strides     the output address from three output strides in the
              parameters (n, row, column), not NHWC or its h/w swap

For each Table-3 layer at batch 16 and each dtype it prints one JSON line
per variant with K1's, K3's and K4's device time a call (``torch.profiler``,
kernel self time over 10 calls; K3 on the layer's L from ``mec_lower``, at
the blocks ``mec_gemm`` picks) and, for ``base``, cuDNN's.  Imports torch
and the port only.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build, mec_conv as K, ops  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "probe"
# Table 3 (ResNet-101): name -> (i_h, i_w, i_c, k_h, k_w, k_c, stride)
LAYERS = {"cv4": (224, 224, 64, 7, 7, 64, 2), "cv9": (56, 56, 64, 3, 3, 64, 1),
          "cv10": (28, 28, 128, 3, 3, 128, 1), "cv11": (14, 14, 256, 3, 3, 256, 1),
          "cv12": (7, 7, 512, 3, 3, 512, 1)}
BATCH = 16
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_NO_MMA = [
    ("mec_mma.cuh", "            mma_3xtf32<MT, NT>(part, cur);",
     "            if (p.k_c < 0) mma_3xtf32<MT, NT>(part, cur);"),
    ("mec_mma.cuh",
     "                mma_16816<T>(acc[mt][nt], cur.a[mt], cur.b[nt][0], cur.b[nt][1]);",
     "                if (p.k_c < 0)\n"
     "                  mma_16816<T>(acc[mt][nt], cur.a[mt], cur.b[nt][0], cur.b[nt][1]);"),
]
_NO_STAGE = [
    ("mec_mma.cuh", "  const int r = step / p.nchunk;\n",
     "  if (step >= kStages) return;\n  const int r = step / p.nchunk;\n"),
]
VARIANTS = {
    "base": [],
    "no_mma": _NO_MMA,
    "no_stage": _NO_STAGE,
    "frags_only": _NO_MMA + _NO_STAGE,
    "one_step": [
        ("mec_mma.cuh", "  const int s_end = (rank + 1) * steps / p.split;",
         "  const int s_end = min(s_beg + 1, (rank + 1) * steps / p.split);"),
    ],
    "warp64x32": [
        ("mec_conv.cu", "int mma_threads(int bm) { return bm == 128 ? 256 : 128; }",
         "int mma_threads(int bm, int elem) { return bm == 128 && elem == 4 ? 256 : 128; }"),
        ("mec_conv.cu", "  const int threads = mma_threads(L->bm);",
         "  const int threads = mma_threads(L->bm, elem);"),
        ("mec_conv.cu", "    default: return launch_mma_tile<T, 2, 4, 4, 2>(kind, L, stream);",
         "    default:\n"
         "      if (sizeof(T) == 2) return launch_mma_tile<T, 4, 4, 2, 2>(kind, L, stream);\n"
         "      return launch_mma_tile<T, 2, 4, 4, 2>(kind, L, stream);"),
    ],
    "strides": [
        ("mec_mma.cuh", "  int swap_hw;", "  int swap_hw;\n  int64_t out_sn, out_sh, out_sw;"),
        ("mec_conv.cu", "  p.swap_hw = kind == kK3;",
         "  p.swap_hw = kind == kK3;\n"
         "  p.out_sn = (int64_t)o_h * o_w * k_c;\n"
         "  p.out_sh = kind == kK3 ? k_c : (int64_t)o_w * k_c;\n"
         "  p.out_sw = kind == kK3 ? (int64_t)o_h * k_c : k_c;"),
        ("mec_mma.cuh",
         "            T* o = out + (p.swap_hw ? (n * p.o_w + w) * (int64_t)p.o_h + h\n"
         "                                    : (n * p.o_h + h) * (int64_t)p.o_w + w) * p.k_c;",
         "            T* o = out + n * p.out_sn + h * p.out_sh + w * p.out_sw;"),
    ],
}


def make_variant(name: str) -> Path:
    """Copy the sources and apply the variant's edits; each must match."""
    src = OUT / name / "csrc"
    if src.exists():
        shutil.rmtree(src)
    shutil.copytree(CSRC, src)
    for fname, old, new in VARIANTS[name]:
        path = src / fname
        text = path.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: edit target not found once in {fname}: "
                               f"{old.strip()[:60]!r}")
        path.write_text(text.replace(old, new))
    return src


def build_all(names) -> dict:
    """nvcc every variant's mec_conv.cu at once; returns name -> library."""
    nvcc = build.nvcc_path()
    procs = {}
    for name in names:
        src = make_variant(name)
        lib = OUT / name / "libmec_conv.so"
        cmd = [nvcc, *build.NVCC_FLAGS, "-o", str(lib),
               *(str(src / f) for f in build.LIBRARIES["mec_conv"])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        libs[name] = lib
    return libs


_BIND = K._lib.__wrapped__     # loads "mec_conv" and declares argtypes


def use_library(path: Path) -> None:
    """Point the wrappers at one variant's library (argtypes as usual)."""
    load = build.load
    build.load = lambda name: ctypes.CDLL(str(path))
    try:
        lib = _BIND()
    finally:
        build.load = load
    K._lib = lambda: lib


def device_ms(fn, calls: int = 10) -> float:
    """Device time of one call: kernel self time from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
                for e in prof.key_averages())
    return total / calls / 1e3


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variants", default=",".join(VARIANTS))
    parser.add_argument("--layers", default=",".join(LAYERS))
    parser.add_argument("--dtypes", default=",".join(DTYPES))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mma_probe: no CUDA device")
    names = args.variants.split(",")
    libs = build_all(names)
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    gen = torch.Generator("cuda").manual_seed(0)
    for layer in args.layers.split(","):
        ih, iw, ic, kh, kw, kc, s = LAYERS[layer]
        o_h, o_w = (ih - kh) // s + 1, (iw - kw) // s + 1
        w_blk = ops.pick_fused_w_blk(o_w, kc, BATCH, o_h)
        oh_blk = ops.pick_oh_blk(o_h, o_w, w_blk, kc, BATCH)
        for dname in args.dtypes.split(","):
            dtype = DTYPES[dname]
            x = torch.randn((BATCH, ih, iw, ic), generator=gen, device="cuda").to(dtype)
            k = (torch.randn((kh, kw, ic, kc), generator=gen, device="cuda")
                 * (kh * kw * ic) ** -0.5).to(dtype)
            low, kmat = K.mec_lower_plain(x, kw, s), k.reshape(kh, kw * ic, kc)
            for name in names:
                use_library(libs[name])
                row = {"variant": name, "layer": layer, "batch": BATCH, "dtype": dname,
                       "K1_ms": device_ms(lambda: K.mec_conv_fused(x, k, s, w_blk=w_blk)),
                       "K4_ms": device_ms(lambda: K.mec_conv_fused2(
                           x, k, s, w_blk=w_blk, oh_blk=oh_blk)),
                       "K3_ms": device_ms(lambda: K.mec_gemm(low, kmat, kh, s))}
                if name == "base":
                    x_nchw = x.permute(0, 3, 1, 2)
                    k_oihw = k.permute(3, 2, 0, 1).contiguous(
                        memory_format=torch.channels_last)
                    row["cudnn_ms"] = device_ms(lambda: F.conv2d(x_nchw, k_oihw, stride=s))
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
