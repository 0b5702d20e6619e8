#!/usr/bin/env python3
"""Drive the PyTorch port of MEC convolution on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with a CUDA card (written for
an H100).  Phases, each printed as JSON lines; any failed check raises and
the script exits non-zero without its last line:

1. device  - refuse to run without CUDA; the card's name and power limit.
2. build   - compile the CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. kernels - hold K1 (fused conv), K2 (compact lowering), K3 (shifted
             GEMM) and K4 (h-blocked fused conv) against their plain
             PyTorch versions and an f64 oracle on the kernel test sweep,
             the geometries of fault F1 and one with k_h < s_h, and all
             twelve Table-2 layers at full width, batch 1, in f32, bf16
             and f16; K4's launcher runs the pickers' block as one
             sub-tile.  Then K5 (causal depthwise conv1d) against its plain
             version (to the bit) and an f64 oracle: the kernel test cases and fault
             F2's k_w = 1 in f32, bf16 and f16; the zamba2-7b conv input
             (4, 512, 7296, k_w = 4), a column slice of the in_proj
             output, in all three; and the long_500k input (1, 524288,
             7296) in bf16, past 2^31 elements, on its first and last
             4096 steps; K5's runtime-k_w path (k_w > 8, fault F5) at
             k_w = 9, 16 and 33, to the bit.  Then mixed operand dtypes
             (fault F4: bf16 x f32, f32 x bf16, f16 x bf16): K1, K4,
             K2+K3 and K5 equal to the bit to their f32 runs on the
             promoted operands, cast to the input's dtype.
4. slice   - the inference path: the 34 convolutions of the ResNet-101
             Table-3 stack at batch 16 through ``conv2d(algorithm="auto")``
             (K1), then each of its five layers through ``mec_lowered``
             (K2+K3), with the launch counts read around each run and every
             output checked against the plain version and the f64 oracle;
             then the device memory each path allocates against paper
             Eq. 3 (``mec_lowered`` holds the compact L beside O, K1 and K4
             only O).
4b. plan   - the planner: ``tune_measured`` (the measured policy of
             ``plan_conv2d(mode="measured")``) races every algorithm on
             each of the five Table-3 layers at batch 16, in f32 and bf16,
             and tunes the winner's knob; no kernel may be skipped.  Each
             plan round-trips through its JSON and a fresh plan cache on
             one file.  The 34-conv stack then runs through
             ``conv2d(plan=)``: outputs against the f64 oracle within
             their plan's contract, launches per kernel equal to the
             convs planned for it, and the stack timed beside ``auto``
             (K1), all-``direct`` and cuDNN (per-call events around the
             stack, and its device time alone).  The calibration store
             holds the trials, fits, and leaves ``auto`` on CUDA at K1;
             the trainer runs with ``--algorithm auto`` (its plans
             resolved once, acc > 0.8).  Plan cache and calibration live
             in a temporary directory made for the run.
4c. bench  - the benchmark subsystem: ``repro_torch.bench.harness``
             ``run_suite`` times the Table-2 suite (cv1-cv12, every
             algorithm), the Table-3 suite (with its weights and the
             ``auto`` crosscheck) and the dtype suite (cv9 in f32 and
             bf16) at the paper's full widths, each cell on the device
             timer; every cell must be timed and K1-K4 must launch.
             ``run_autotune`` over Table 3 (no candidate skipped);
             ``analysis.memaudit`` over the smoke and Table-2 plans built on
             the card, each geometry under every algorithm, every cell
             gated: the kernel paths within the Eq. 3 rule of the slice
             phase, the plain algorithms within the JAX package's bands
             (fault F6; ``direct`` on its own bytes, cuDNN's apart), the
             plain MEC and the lowered path below im2col wherever Eq. 4
             predicts a saving; a calibration fitted from the two documents
             passes ``check_calibration``; each suite equals its untimed
             re-run on the exact fields (``bench.check.compare``).
4d. analysis - the static launch check against the launcher on every
             geometry the script launches (f32 and bf16; fields equal,
             or both refusing, and at least one geometry both refuse);
             ``--suite numcheck`` on the card (every algorithm x dtype x
             direction at the probe spec; K1-K4 on the Table-3 layers at
             batch 16 in f32 and bf16 against an f64 oracle on the card),
             no violation; the lint, clean with an empty baseline.
4e. examples - ``repro_torch.examples.quickstart`` and
             ``repro_torch.benchmarks.run`` at the paper's sizes: Fig.
             4(a)-(e), Table 3's memory and runtime ratios beside the
             paper's 3.2x and 1.2x, the traffic model.
5. train   - the training path: (a) each of the five Table-3 layers at
             batch 16 through ``conv2d(algorithm="mec_fused2")`` (K4)
             forward and the MEC VJP backward, loss sum(out^2), output and
             both gradients against f64 autograd through ``F.conv2d``;
             then the 34-conv stack forward and backward, timed, with the
             launch counts read around it; (b) the CNN trainer
             ``repro_torch.examples.train_cnn`` at its defaults through
             ``mec_fused2``: accuracy above 0.8, 3 K4 launches a step.
6. serve   - zamba2-7b at full width and depth, bf16, seeded random
             weights, ``conv_impl="fused"``, through
             ``repro_torch.launch.serve.serve``: batch 4, prompt 512, 32
             greedy tokens; 81 K5 launches (one per Mamba2 layer) and no
             K1-K4; finite logits; prefill seconds, decode tokens/s and
             peak memory.  The same prompt and weights through
             ``conv_impl="lowered"`` (plain L): last-token logits within
             2e-2 of the fused path.  A prefill of 384 tokens plus 128
             decode steps against a prefill of all 512: rel <= 2e-2.  K5
             on layer 0's real conv input against its plain version, with
             16-byte vectors.
             Memory: one K5 call allocates its output and nothing else,
             the lowered conv1d L plus the output.
6b. serve_conv - plan-driven conv serving (``repro_torch.serving``): the
             whisper mel frontend at whisper-tiny's width (80 mels -> 384,
             f32) as two ConvServices over the classes 4x1000x1, 4x2000x1
             and 4x3000x1, warmed through the plan cache (K1 on the card,
             each class executor a captured CUDA graph), then a fixed
             stream of 24 mels mixing n in {1, 2, 4} and T in {700 ..
             3000}; the patch embed at llava-next-34b's width (3 -> 7168,
             patch 4, classes 4x224x224 and 4x336x336, prefix 2880).  Every
             answer equals the eager ``conv2d(plan=)`` of its padded class
             input to the bit and the f64 oracle within the f32 contract;
             no warm-up warning and no plan-cache I/O error; launches read
             around the warm-up and the stream.  Per class the warm and
             ``auto`` p50/p99; every candidate of the measured race on the
             two whisper layers at 4x3000x1, beside K1's plain version and
             bound.  Then the bench ``serve`` suite, which must pass
             ``bench.check`` against ``benchmarks/baselines/serve.json`` on
             the exact fields.
6c. serve_whisper - ``python -m repro_torch.launch.serve --arch
             whisper-tiny --warm-plans``, then the same through ``serve()``:
             published widths, full depth (4 + 4 layers), bf16, seeded
             random weights, batch 4, mel 3000 frames through the warmed
             frontend (4 K1 launches: eager and captured per layer), prompt
             32, 32 greedy tokens; decode against a prefill of the extended
             sequence (gated in f32 at 2e-2, reported in bf16); one
             prefill traced for device time and idle share.
7. timing  - each conv2d kernel at each Table-3 layer, batch 1 and 16,
             with CUDA events (median of 15 after 3 warm-up calls),
             beside its plain version, one library call and its bound.
             K1's, K3's and K4's bound is that of their own arithmetic on
             the tensor cores (three TF32 products a multiply-add), with
             the CUDA cores' f32 bound beside it; they also get the launch
             configuration they ran (tile, reduction path, chunk, cluster
             split), a check that two runs give equal bits, and, at batch
             16, their bf16 time beside their library call's in bf16,
             each output first checked against the f64 oracle and the
             plain version.  K5 at the zamba2-7b shape on the L2-cold
             timer (``cold_ms``), beside its plain version, cuDNN, two
             copies of the same bytes and its bound, and again at k_w = 16
             (its runtime-k_w path).
8. profile - one zamba2-7b prefill and four decode steps traced with
             ``torch.profiler``: device time by kernel, launches, and the
             device's busy share of the host-clock window.

The last lines are the nvidia-smi line, the ``{"kernels": [...]}`` line
and ``{"ok": true, "device": {...}}``.  Imports torch and the port only.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent

# The kernel test sweep (tests/test_kernels.py SWEEP), run at batch 2.
SWEEP = [
    (7, 7, 1, 3, 3, 1, 1),
    (12, 14, 3, 5, 3, 8, 2),
    (9, 9, 4, 3, 3, 6, 1),
    (11, 13, 2, 4, 5, 3, (2, 3)),
    (16, 16, 8, 7, 7, 16, 2),
    (8, 8, 3, 1, 1, 4, 1),
    (24, 24, 6, 5, 5, 16, 1),
    (227 // 4, 227 // 4, 3, 11, 11, 8, 4),
]
# Fault F1's three geometries (the TPU's fused2 kernel reads a halo view
# shorter than the halo) and k_h < s_h, at batch 2.
EDGE_GEOMS = {
    "f1_7x7": (7, 7, 3, 7, 7, 5, 1),
    "f1_6x6": (6, 6, 3, 5, 5, 5, 1),
    "f1_9x9": (9, 9, 3, 7, 7, 5, 1),
    "kh_lt_sh": (8, 8, 3, 2, 2, 5, 3),
}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
# K5: (t, c, k_w) of tests/test_kernels.py test_mec_conv1d_kernel, then
# fault F2's k_w = 1, at batch 2; that test's tolerance (rtol = atol).
CONV1D_CASES = [(10, 5, 4), (1024, 256, 4), (33, 7, 3), (512, 64, 2),
                (5, 3, 4), (10, 5, 1), (1024, 8, 1)]
CONV1D_TOL = {"float32": 2e-4, "bfloat16": 4e-2, "float16": 4e-2}
# K5's runtime-k_w path (k_w above the specialised 8, fault F5): (t, c, k_w)
CONV1D_ANY_KW = [(1024, 256, 9), (100, 130, 16), (512, 64, 33)]
ANY_KW_TIMED = 16
# fault F4: (input dtype, kernel dtype), and the conv2d geometry they run on
MIXED = [("bfloat16", "float32"), ("float32", "bfloat16"),
         ("float16", "bfloat16")]
MIXED_GEOM = (14, 14, 256, 3, 3, 256, 1)
# the plan phase: measured races and the planned stack, in these dtypes
PLAN_DTYPES = ("float32", "bfloat16")
PLAN_ITERS, PLAN_WARMUP = 10, 2
# the kernel paths no measured race may skip
PLAN_KERNEL_ALGOS = ("mec_fused", "mec_fused2", "mec_lowered")
# the bench phase: suites timed at full width (each with its arguments),
# the autotune comparison's base suite, and the timed calls a cell (after
# its warm-up calls); the memaudit audits its default smoke + table2 plans
BENCH_SUITES = (("table2", {}), ("resnet101", {"crosscheck": True}),
                ("dtype", {}))
BENCH_AUTOTUNE = "resnet101"
BENCH_ITERS, BENCH_WARMUP = 10, 2
# the analysis phase's drift guard: a geometry no launcher takes (a 33 x 33
# kernel, whose kernel slab's smallest ring exceeds the opt-in), beside
# every geometry the script launches
LAUNCH_REFUSED = (40, 120, 32, 33, 33, 64, 1)
# zamba2-7b served: batch, prompt, generated tokens; the Mamba2 conv input
# is columns 7168 .. 14463 (d_in .. 2 d_in + 2 N) of a 14576-wide row.
SERVE_ARCH = "zamba2-7b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 512, 32
DECODE_FROM = 384            # decode against prefill: 384 + 128 steps
LOGITS_TOL = 2e-2            # tests/test_archs.py test_decode_matches_prefill
IN_PROJ, CONV_LO, CONV_HI = 14576, 7168, 14464
# configs/shapes.py long_500k: zamba2-7b at t = 524288
LONG_T, LONG_WINDOW = 524288, 4096
# plan-driven conv serving (phase 6b): the whisper mel frontend at
# whisper-tiny's width as two ConvServices over three time classes, a
# fixed stream of mixed (n, T) requests; the llava-next-34b patch embed
# (3 -> 7168, patch 4) over two image classes
WHISPER_ARCH = "whisper-tiny"
N_MELS = 80
WHISPER_CLASSES = ((4, 1000, 1), (4, 2000, 1), (4, 3000, 1))
WHISPER_STREAM_N, WHISPER_STREAM_T = (1, 2, 4), (700, 1000, 1500, 2000,
                                                 2600, 3000)
WHISPER_REQUESTS = 24
PATCH_ARCH, PATCH, PATCH_IN = "llava-next-34b", 4, 3
PATCH_CLASSES = ((4, 224, 224), (4, 336, 336))
PATCH_STREAM = ((1, 224, 224), (2, 196, 210), (4, 224, 224), (1, 336, 336),
                (2, 300, 280), (4, 336, 336))
PATCH_REQUESTS = 12
SERVE_BASELINE = "benchmarks/baselines/serve.json"
# whisper-tiny served (phase 6c): batch, mel frames, prompt, generated
# tokens; decode against prefill from this many prompt tokens
WHISPER_BATCH, WHISPER_MEL_T, WHISPER_PROMPT, WHISPER_GEN = 4, 3000, 32, 32
WHISPER_DECODE_FROM = 16
SLICE_BATCH = 16
# repro_torch.examples.train_cnn at its defaults (200 steps) through K4.
TRAIN_ARGS = ["--algorithm", "mec_fused2"]
TRAIN_STEPS = 200
TIMING_BATCHES = (1, 16)
WARMUP, ITERS = 3, 15
# The L2-cold timer (cold_ms): launches between one pair of events, over a
# ring of operands spanning twice the H100's 50 MB L2.
COLD_CALLS = 24
COLD_RING_BYTES = 2 * 50 * 2 ** 20
DEVICE = "cuda"

# Data-sheet peaks by card name: dense f32 on the CUDA cores, device memory
# bandwidth, and the dense tensor-core rates in TF32 and bf16/f16 (without
# sparsity); the first substring that matches wins.
PEAKS = (
    ("H100 PCIe", 51e12, 2.0e12, 378e12, 756e12, "H100 PCIe data sheet"),
    ("H100 NVL", 60e12, 3.9e12, 417.5e12, 835.5e12, "H100 NVL data sheet"),
    ("H200", 67e12, 4.8e12, 495e12, 989e12, "H200 SXM data sheet"),
    ("H100", 67e12, 3.35e12, 495e12, 989e12, "H100 SXM data sheet"),
)
# K1 and K4 multiply f32 operands as three TF32 products (hi*hi + hi*lo +
# lo*hi) and bf16/f16 operands as one: their own arithmetic's bound.
TF32_PRODUCTS = 3

KERNEL_ROWS = {
    # wrapper name -> (source, the TPU kernel it replaces)
    "mec_conv_fused": ("src/repro_torch/kernels/csrc/mec_conv.cu",
                       "src/repro/kernels/mec_conv.py:137"),
    "mec_lower": ("src/repro_torch/kernels/csrc/mec_conv.cu",
                  "src/repro/kernels/mec_conv.py:39"),
    "mec_gemm": ("src/repro_torch/kernels/csrc/mec_conv.cu",
                 "src/repro/kernels/mec_conv.py:82"),
    "mec_conv_fused2": ("src/repro_torch/kernels/csrc/mec_conv.cu",
                        "src/repro/kernels/mec_conv.py:171"),
    "mec_conv1d": ("src/repro_torch/kernels/csrc/mec_conv1d.cu",
                   "src/repro/kernels/mec_conv1d.py:19"),
}


def emit(obj, stream=sys.stdout) -> None:
    print(json.dumps(obj), file=stream, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def peaks_for(name: str):
    for tag, flops, bw, tf32, bf16, label in PEAKS:
        if tag in name:
            return flops, bw, tf32, bf16, label
    raise RuntimeError(f"no data-sheet peak for card {name!r}; add it to PEAKS")


def stride_pair(s):
    return (s, s) if isinstance(s, int) else tuple(s)


def make_operands(gen, batch, geom, dtype):
    """Seeded NHWC input ~ N(0, 1) and HWIO kernel ~ N(0, 1/K), quantized
    to ``dtype``."""
    ih, iw, ic, kh, kw, kc, _ = geom
    x = torch.randn((batch, ih, iw, ic), generator=gen, device=DEVICE)
    k = torch.randn((kh, kw, ic, kc), generator=gen, device=DEVICE)
    k = k * (kh * kw * ic) ** -0.5
    return x.to(dtype), k.to(dtype)


def time_ms(fn) -> float:
    """Median device time of one call, from CUDA events around each of
    ITERS calls after WARMUP calls."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(ITERS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def cold_ms(fn, ring, calls: int = COLD_CALLS) -> dict:
    """Device time of one call of a short kernel whose operands the L2 does
    not hold, as its real caller finds them.  ``ring`` is a list of
    argument tuples that together span at least COLD_RING_BYTES of what
    the calls read and write; ``calls`` launches, walking the ring (each
    slot's output is kept until the slot comes round again, so the outputs
    cycle too), run between one pair of CUDA events, ITERS times, with the
    host's enqueue hidden behind a sleep of the card
    (``bench.harness.slept_event_ms``, the planner's timer).  Returns the
    median, min and max per call, in ms."""
    from repro_torch.bench.harness import slept_event_ms
    m = len(ring)
    outs = [None] * m

    def run():
        for i in range(calls):
            outs[i % m] = fn(*ring[i % m])

    run()
    per_call = [ms / calls for ms in slept_event_ms(run, ITERS, 1.0)]
    return {"ms": statistics.median(per_call), "min_ms": min(per_call),
            "max_ms": max(per_call), "calls": calls, "ring": m}


def ring_slots(bytes_per_call: int) -> int:
    """Slots of a ring whose calls together touch COLD_RING_BYTES."""
    return max(2, math.ceil(COLD_RING_BYTES / bytes_per_call))


def conv1d_timing(C, gen, kw: int, peak_flops: float, peak_bw: float,
                  check_plain: bool = True) -> dict:
    """K5, its plain version and cuDNN's depthwise conv1d (one library call
    on a contiguous (n, c, t) copy, the copy not timed) at the zamba2-7b
    conv input in bf16, a column slice of the in_proj output as the model
    passes it, each on the L2-cold timer; K5's output and cuDNN's are
    checked against the plain version first.  Beside them, two copies of
    the same bytes with no arithmetic: the slice's copy into a contiguous
    tensor (``copy_ms``, PyTorch's strided copy kernel) and a clone of a
    contiguous tensor of the conv's size (``memcpy_ms``, a device-to-device
    memcpy), what streaming them takes on this card in practice.  ``C`` is
    the module ``repro_torch.kernels.mec_conv1d``; ``check_plain=False``
    skips K5's check, for a probe's variant that is wrong by design."""
    n, t, c = SERVE_BATCH, SERVE_PROMPT, CONV_HI - CONV_LO
    es = torch.tensor([], dtype=torch.bfloat16).element_size()
    flops, nbytes = 2 * kw * n * t * c, (2 * n * t * c + kw * c) * es
    k = torch.randn((kw, c), generator=gen, device=DEVICE, dtype=torch.bfloat16)
    xs = [torch.randn((n, t, IN_PROJ), generator=gen, device=DEVICE,
                      dtype=torch.bfloat16)[..., CONV_LO:CONV_HI]
          for _ in range(ring_slots(nbytes))]
    check(not check_plain or torch.equal(C.mec_conv1d(xs[0], k),
                                         C.mec_conv1d_plain(xs[0], k)),
          "K5 at the zamba2-7b shape differs from its plain version")
    w_c1k = k.t().contiguous().unsqueeze(1)
    x_ncts = [x.permute(0, 2, 1).contiguous() for x in xs]

    def library_conv1d(x_nct):
        return F.conv1d(x_nct, w_c1k, groups=c, padding=kw - 1)

    lib_y = library_conv1d(x_ncts[0])[..., :t].permute(0, 2, 1)
    check(torch.allclose(lib_y.double(), C.mec_conv1d_plain(xs[0], k).double(),
                         rtol=CONV1D_TOL["bfloat16"], atol=CONV1D_TOL["bfloat16"]),
          "cuDNN's depthwise conv1d does not compute K5's function")
    del lib_y
    timed = {"kernel": cold_ms(lambda x: C.mec_conv1d(x, k), [(x,) for x in xs]),
             "plain": cold_ms(lambda x: C.mec_conv1d_plain(x, k), [(x,) for x in xs]),
             "library": cold_ms(library_conv1d, [(x,) for x in x_ncts]),
             "copy": cold_ms(torch.Tensor.contiguous, [(x,) for x in xs]),
             "memcpy": cold_ms(torch.Tensor.clone, [(x,) for x in x_ncts])}
    t_ops, t_bytes = flops / peak_flops, nbytes / peak_bw
    return {"shape": [n, t, c, kw], "dtype": "bfloat16", "input_row_stride": IN_PROJ,
            "ms": timed["kernel"]["ms"], "plain_ms": timed["plain"]["ms"],
            "library_ms": timed["library"]["ms"], "copy_ms": timed["copy"]["ms"],
            "memcpy_ms": timed["memcpy"]["ms"],
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "timer": "L2-cold", "cold": timed}


def lowered_view(x, k_w, s_w):
    """L as a strided view of I: L[n, w, h, q] = I[n, h, s_w*w, q]."""
    n, ih, iw, ic = x.shape
    o_w = (iw - k_w) // s_w + 1
    return x.as_strided((n, o_w, ih, k_w * ic),
                        (ih * iw * ic, s_w * ic, iw * ic, 1))


def window_view(low, k_h, s_h):
    """The paper's ld-aliased windows of L: (n, o_h, o_w, k_h*k_w*i_c)."""
    n, o_w, ih, kwic = low.shape
    o_h = (ih - k_h) // s_h + 1
    return low.as_strided((n, o_h, o_w, k_h * kwic),
                          (o_w * ih * kwic, s_h * kwic, ih * kwic, 1))


def scaled_err(y, ref) -> float:
    """max|y - ref| / max|ref| in f64."""
    y64, r64 = y.double(), ref.double()
    return ((y64 - r64).abs().max() / r64.abs().max()).item()


def conv1d_case(C, ref, name, dname, x, k, window=None):
    """K5 on x against its plain version and the f64 oracle.  ``window`` =
    (start, stop) compares only those output steps, the plain version and
    the oracle run on the input from k_w - 1 steps before ``start``."""
    y = C.mec_conv1d(x, k)
    torch.cuda.synchronize()
    check(y.shape == x.shape and y.dtype == x.dtype and y.is_contiguous(),
          f"K5 {name} {dname}: {tuple(y.shape)} {y.dtype}")
    lo, hi = window or (0, x.shape[1])
    pre = min(lo, k.shape[0] - 1)
    xin = x[:, lo - pre:hi].contiguous()
    plain = C.mec_conv1d_plain(xin, k)[:, pre:]
    oracle = ref.conv1d_ref(xin.double(), k.double())[:, pre:]
    y = y[:, lo:hi]
    tol = CONV1D_TOL[dname]
    ok_o = torch.allclose(y.double(), oracle, rtol=tol, atol=tol)
    ok_p = torch.allclose(y.double(), plain.double(), rtol=tol, atol=tol)
    check(ok_o and ok_p, f"K5 {name} {dname}: outside rtol = atol = {tol} "
          f"(f64 oracle {ok_o}, plain {ok_p})")
    check(torch.equal(y, plain), f"K5 {name} {dname}: not equal to its plain "
          f"version to the bit")
    return {"geom": name, "dtype": dname, "tol": tol,
            "max_abs_err_vs_plain": (y.float() - plain.float()).abs().max().item(),
            "bit_exact_vs_plain": bool(torch.equal(y, plain)),
            "scaled_err_vs_f64": scaled_err(y, oracle)}


def device_breakdown(prof, wall_s: float, top: int = 15) -> dict:
    """Device time by kernel from a torch.profiler trace, and the device's
    busy share of the ``wall_s`` host-clock window."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_us = sum(dev_us(e) for e in kernels)
    kernels.sort(key=dev_us, reverse=True)
    return {"wall_s": wall_s, "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
            "kernel_launches": sum(e.count for e in kernels),
            "top": [{"name": e.key[:120], "count": e.count,
                     "device_ms": dev_us(e) / 1e3} for e in kernels[:top]]}


def profile_serving(cfg, seed: int, decode_steps: int = 4) -> dict:
    """Trace one zamba2-7b prefill (after a warm-up prefill) and
    ``decode_steps`` decode steps (after two warm-up steps)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import lm as lm_mod, serve as serve_lib
    from repro_torch.models.layers import f32_accumulation
    model = lm_mod.LM(cfg)
    out = {}
    with torch.inference_mode(), f32_accumulation():
        params = launch_serve.init_params(cfg, seed, DEVICE)
        prompt = launch_serve.make_prompt(cfg, SERVE_BATCH, SERVE_PROMPT, seed,
                                          DEVICE)
        max_len = SERVE_PROMPT + 2 + decode_steps
        serve_lib.prefill(model, params, {"tokens": prompt}, max_len)
        torch.cuda.synchronize()
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            _, cache = serve_lib.prefill(model, params, {"tokens": prompt},
                                         max_len)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out["prefill"] = device_breakdown(prof, wall)
        tok = prompt[:, -1:]
        for _ in range(2):
            _, cache = serve_lib.decode_step(model, params, cache, tok)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(decode_steps):
                _, cache = serve_lib.decode_step(model, params, cache, tok)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out["decode"] = {"steps": decode_steps, **device_breakdown(prof, wall)}
    return out


def plan_phase(stack, plan_dir: Path) -> dict:
    """The planner on the card (phase 4b): measured plans for each layer of
    ``stack`` (the slice phase's (name, x, w, stride, spec) convs) in each
    of PLAN_DTYPES, their round trips, the stack through ``conv2d(plan=)``
    against the f64 oracle with its launch counts, its time beside
    ``auto`` and all-``direct``, the calibration store, and the trainer
    with ``--algorithm auto``.  Returns the planned stacks by dtype."""
    import contextlib
    import io
    from repro_torch.core.conv_api import conv2d
    from repro_torch.core.numerics import fwd_tolerance
    from repro_torch.core.direct import ieee_f32_conv
    from repro_torch.examples import train_cnn
    from repro_torch.kernels import mec_conv as K, ref
    from repro_torch.launch.costmodel import pick_conv2d_algorithm
    from repro_torch.plan import (CalibrationStore, ConvPlan, PlanCache,
                                  current_calibration, plan_conv2d,
                                  reset_calibration_cache, spec_key)
    from repro_torch.plan.convplan import tune_measured

    layers = {}
    for name, _, _, _, spec in stack:
        layers.setdefault(name, spec)
    plans = {}
    for dname in PLAN_DTYPES:
        for name, spec in layers.items():
            t0 = time.perf_counter()
            plan, detail = tune_measured(spec, dname, iters=PLAN_ITERS,
                                         warmup=PLAN_WARMUP)
            seconds = time.perf_counter() - t0
            lost = sorted(a for a in detail["skipped"]
                          if a.split("[")[0] in PLAN_KERNEL_ALGOS)
            check(not lost, f"plan {name} {dname}: the race lost {lost}: "
                  f"{detail['skipped']}")
            check(set(PLAN_KERNEL_ALGOS) <= set(detail["candidate_us"]),
                  f"plan {name} {dname}: timed {sorted(detail['candidate_us'])}")
            check((plan.backend, plan.mode, plan.dtype) == ("cuda", "measured", dname),
                  f"plan {name} {dname}: {plan}")
            check(ConvPlan.from_json(plan.to_json()) == plan,
                  f"plan {name} {dname}: JSON round trip")
            tuning = detail["tuning"]
            row = {"layer": name, "dtype": dname, "spec": spec_key(spec),
                   "analytic": detail["analytic_algorithm"],
                   "candidate_us": detail["candidate_us"],
                   "candidate_rel_spread": {a: st["us_rel_spread"] for a, st
                                            in detail["candidate_stats"].items()},
                   "skipped": detail["skipped"],
                   "tuning": None if tuning is None else {
                       "knob": tuning["knob"], "default": tuning["default"],
                       "picked": tuning["picked"],
                       "trials_us": {lbl: t["us_median"]
                                     for lbl, t in tuning["trials"].items()}},
                   "algorithm": plan.algorithm, "solution": plan.solution,
                   "w_blk": plan.w_blk, "seconds": round(seconds, 3)}
            emit({"phase": "plan", **row})
            plans[(name, dname)] = plan
    # the user's entry point runs the same policy
    entry = plan_conv2d(layers["cv11"], dtype="float32", mode="measured",
                        iters=PLAN_ITERS, warmup=PLAN_WARMUP)
    check(entry.mode == "measured" and entry.backend == "cuda",
          f"plan_conv2d(mode='measured'): {entry}")
    # a fresh plan cache on one file holds every plan
    cache_file = plan_dir / "plans" / "measured.json"
    writer = PlanCache(cache_file)
    for plan in plans.values():
        writer.put(plan.cache_key(), plan)
    reader = PlanCache(cache_file)
    check(all(reader.get(p.cache_key()) == p for p in plans.values())
          and writer.io_errors == reader.io_errors == 0,
          f"plans through a fresh cache on {cache_file}")

    # the 34-conv stack through conv2d(plan=)
    stacks = {}
    for dname in PLAN_DTYPES:
        dtype = DTYPES[dname]
        xs, convs = {}, []
        for name, x, w, s, spec in stack:
            xs.setdefault(name, x.to(dtype))
            convs.append((name, xs[name], w.to(dtype), s, spec,
                          plans[(name, dname)]))
        expected = {fn.__name__: 0 for fn in K.KERNELS}
        runs = {"mec_fused": ("mec_conv_fused",),
                "mec_fused2": ("mec_conv_fused2",),
                "mec_lowered": ("mec_lower", "mec_gemm")}
        for *_, plan in convs:
            for kname in runs.get(plan.algorithm, ()):
                expected[kname] += 1
        K.reset_launch_counts()
        torch.cuda.synchronize()
        outs = [conv2d(x, w, stride=s, padding="VALID", plan=plan)
                for _, x, w, s, _, plan in convs]
        torch.cuda.synchronize()
        counts = K.launch_counts()
        check(counts == expected, f"planned stack {dname} launched {counts}, "
              f"its plans {expected}")
        worst = 0.0
        for (name, x, w, s, spec, plan), y in zip(convs, outs):
            tol = fwd_tolerance(plan.algorithm, dname,
                                spec.k_h * spec.k_w * spec.i_c)
            e = ref.scaled_error(y, ref.conv2d_f64(x, w, s))
            check(tuple(y.shape) == spec.out_shape and y.dtype == dtype
                  and math.isfinite(e) and e <= tol,
                  f"planned stack {name} {dname} ({plan.algorithm}): error "
                  f"{e} vs f64 > tol {tol}")
            worst = max(worst, e / tol)
        del outs

        def run(**kw):
            return lambda: [conv2d(x, w, stride=s, padding="VALID", **kw)
                            for _, x, w, s, _, _ in convs]

        def planned():
            return [conv2d(x, w, stride=s, padding="VALID", plan=plan)
                    for _, x, w, s, _, plan in convs]

        lib_ops = [(x.permute(0, 3, 1, 2),        # NHWC memory = channels_last
                    w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last),
                    s) for _, x, w, s, _, _ in convs]

        def library():
            with ieee_f32_conv():
                return [F.conv2d(x, k, stride=s) for x, k, s in lib_ops]

        paths = {"planned": planned, "auto": run(algorithm="auto"),
                 "direct": run(algorithm="direct"), "library": library}
        stacks[dname] = {
            "convs": len(convs),
            "plans": {n: plans[(n, dname)].algorithm for n in layers},
            "w_blk": {n: plans[(n, dname)].w_blk for n in layers},
            "launches": counts, "worst_err_over_tol": worst,
            # CUDA events around the 34 calls (the host's enqueue included)
            **{f"{p}_ms": time_ms(fn) for p, fn in paths.items()},
            # the device's time alone: the host's enqueue hidden behind a
            # sleep (cold_ms's timer on a one-slot ring, so the L2 is warm)
            "device_ms": {p: cold_ms(fn, [()], calls=1)["ms"]
                          for p, fn in paths.items()}}
        emit({"phase": "plan", "stack": dname, **stacks[dname]})

    # the calibration store holds the trials, fits, and leaves auto at K1
    calib = CalibrationStore(backend="cuda").load()
    cells = calib.time_cells()
    check(all(set(PLAN_KERNEL_ALGOS) <= set(cells.get(spec_key(spec), {}))
              for spec in layers.values()),
          f"the calibration store holds {sorted(cells)}")
    fit = calib.fit()
    env_file = plan_dir / "calibration.json"
    env_file.write_text(json.dumps(calib.to_dict()))
    reset_calibration_cache()
    check(current_calibration("cuda") is not None,
          "the fitted calibration is not the ambient one")
    for spec in layers.values():
        for calibration in ("ambient", calib):
            got = pick_conv2d_algorithm(spec, "cuda", calibration=calibration)
            check(got == "mec_fused", f"auto on CUDA with a fitted store: {got}")

    # the trainer, with one plan per layer resolved once
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        acc = train_cnn.main(["--algorithm", "auto"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    print(log.getvalue(), file=sys.stderr, end="", flush=True)
    train_counts = K.launch_counts()
    plan_lines = [ln for ln in log.getvalue().splitlines() if " plan[" in ln]
    check(acc > 0.8, f"train_cnn --algorithm auto: final accuracy {acc}")
    check(len(plan_lines) == 3, f"train_cnn printed plans {plan_lines}")
    check(train_counts == {"mec_conv_fused": 3 * TRAIN_STEPS, "mec_lower": 0,
                           "mec_gemm": 0, "mec_conv_fused2": 0},
          f"train_cnn --algorithm auto launched {train_counts}")
    out = {"phase": "plan", "stacks": stacks,
           "calibration": {"cells": len(cells),
                           "samples": sum(len(v) for v in calib.time_samples.values()),
                           "time_constants": fit["time_constants"],
                           "decisions": fit["decisions"]},
           "train_cnn_auto": {"plans": plan_lines, "final_acc": acc,
                              "launches": train_counts,
                              "seconds": round(train_s, 3)}}
    emit(out)
    return stacks


def bench_phase(tmp_dir: Path) -> dict:
    """The benchmark subsystem on the card (phase 4c): the Table 2,
    Table 3 and dtype suites timed at full width through
    ``repro_torch.bench.harness.run_suite`` (every algorithm variant, each
    cell on the device timer), the autotune comparison over Table 3, the
    memory auditor over the smoke and Table 2 plans built on the card, a
    calibration fitted from the two documents and checked, and each suite
    against its own untimed re-run.  Returns the kernels' launches during
    the suites."""
    from repro_torch.analysis import memaudit
    from repro_torch.bench import check as bench_check
    from repro_torch.bench.harness import run_autotune, run_suite
    from repro_torch.kernels import mec_conv as K
    from repro_torch.plan import calibrate as cal

    t_phase = time.perf_counter()
    K.reset_launch_counts()
    torch.cuda.synchronize()
    docs, seconds = {}, {}
    for suite, kw in BENCH_SUITES:
        t0 = time.perf_counter()
        docs[suite] = run_suite(suite, iters=BENCH_ITERS, warmup=BENCH_WARMUP,
                                **kw)
        seconds[suite] = round(time.perf_counter() - t0, 3)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    check(all(n > 0 for n in launches.values()),
          f"the bench suites launched {launches}: a kernel never ran")
    for suite, doc in docs.items():
        untimed = [f"{r['scenario']}/{r['algorithm']}" for r in doc["results"]
                   if r["us_per_call"] is None]
        check(not untimed, f"bench {suite}: untimed cells {untimed}")
        us = {}
        for r in doc["results"]:
            us.setdefault(r["scenario"], {})[r["algorithm"]] = r["us_per_call"]
        noisy = max(doc["results"], key=lambda r: r["timing"]["us_rel_spread"])
        emit({"phase": "bench", "suite": suite, "seconds": seconds[suite],
              "us_per_call": us, "max_rel_spread": [
                  f"{noisy['scenario']}/{noisy['algorithm']}",
                  noisy["timing"]["us_rel_spread"]]})
    emit({"phase": "bench", "suite": "resnet101", "crosscheck": {
        c["scenario"]: {"auto": c["auto_algorithm"], "best": c["measured_best"],
                        "auto_matches_best": c["auto_matches_best"],
                        "auto_overhead_ok": c["auto_overhead_ok"]}
        for c in docs["resnet101"]["crosscheck"]}})

    # the measured planner against the analytic pick, per Table-3 layer
    t0 = time.perf_counter()
    autotune = run_autotune(BENCH_AUTOTUNE, iters=BENCH_ITERS,
                            warmup=BENCH_WARMUP)
    seconds["autotune"] = round(time.perf_counter() - t0, 3)
    skipped = {r["scenario"]: r["skipped"] for r in autotune["results"]
               if r["n_skipped"]}
    check(not skipped, f"autotune skipped candidates: {skipped}")
    emit({"phase": "bench", "suite": "autotune", "base_suite": BENCH_AUTOTUNE,
          "seconds": seconds["autotune"],
          "cells": {r["scenario"]: {
              "analytic": r["analytic_algorithm"], "analytic_us": r["analytic_us"],
              "measured": r["measured_algorithm"], "measured_us": r["measured_us"],
              "speedup": r["speedup"], "w_blk": r["plan"]["w_blk"]}
              for r in autotune["results"]}})

    # Eq. 2-4 against the allocator, over the smoke and Table 2 plans:
    # every cell gated, the kernel paths' rule and the plain algorithms'
    # bands (F6), direct on its own bytes beside cuDNN's
    t0 = time.perf_counter()
    audit, audit_failures = memaudit.run_audit()
    plans = {r["scenario"] for r in audit["results"]}
    seconds["memaudit"] = round(time.perf_counter() - t0, 3)
    cells = {}
    for r in audit["results"]:
        cells.setdefault(r["scenario"], {})[r["algorithm"]] = {
            "predicted": r["predicted_overhead_bytes"],
            "measured": r["measured_temp_bytes"], "ratio": r["ratio"],
            "blocks": r["measured_block_bytes"],
            "library": r["library_workspace_bytes"], "verdict": r["verdict"]}
    bad = [f"{r['scenario']}/{r['algorithm']}" for r in audit["results"]
           if r["verdict"] != "pass" or r["policy"] != "gated"]
    check(len(audit["results"]) > len(plans) and not bad and not audit_failures,
          f"memaudit cells failed: {bad}: {audit_failures}")
    # the paper's claim, on the kernel path and the plain MEC: L below
    # im2col's matrix wherever Eq. 4 predicts a saving
    for alg in ("mec_lowered", "mec"):
        rows = [c for c in audit["crosscheck"] if c["algorithm"] == alg]
        check({c["scenario"] for c in rows} == plans
              and all(c["ok"] == "yes" for c in rows),
              f"memaudit: {alg} above im2col against Eq. 4: {rows}")
    emit({"phase": "bench", "suite": "memaudit", "plans": len(plans),
          "seconds": seconds["memaudit"], "cells_gated": len(audit["results"]),
          "crosscheck": {f"{c['scenario']}/{c['algorithm']}": c["ok"]
                         for c in audit["crosscheck"]}, "cells": cells})

    # a calibration fitted from the two documents, then checked
    calib = cal.Calibration.for_current_env("cuda")
    n_time = cal.ingest_autotune(calib, autotune)
    n_mem = cal.ingest_memaudit(calib, audit)
    fitted = tmp_dir / "bench-calibration.json"
    fitted.write_text(json.dumps(calib.to_dict()))
    cal_failures = cal.check_calibration(json.loads(fitted.read_text()))
    check(n_time > 0 and n_mem > 0 and not cal_failures,
          f"calibration from the bench: {n_time} time and {n_mem} memory "
          f"samples, failures {cal_failures}")

    # each suite against its own untimed re-run: the exact fields agree
    compare = {}
    for suite, _ in BENCH_SUITES:
        failures, _ = bench_check.compare(
            docs[suite], run_suite(suite, with_timing=False),
            schema_only_on_timing=True)
        check(not failures, f"bench.check {suite}: {failures}")
        compare[suite] = len(docs[suite]["results"])
    phase_s = round(time.perf_counter() - t_phase, 3)
    emit({"phase": "bench", "launches": launches, "seconds": phase_s,
          "by_part": seconds, "calibration": {
              "time_samples": n_time, "memory_samples": n_mem,
              "mem_ratio": calib.fit()["mem_ratio"],
              "check_failures": len(cal_failures)},
          "compared_cells": compare})
    return launches


def analysis_phase(geoms) -> dict:
    """The analysis suites on the card (phase 4d).  The drift guard: the
    static launch check (``analysis.launch_check``) against the launcher
    (``ops.launch_config``) on every geometry this script launches (the
    kernel sweep with F1's geometries and cv1-cv12 at their batches,
    Table 3 at batch 16, one geometry no launcher takes), f32 and bf16,
    the fields equal or both refusing.  Then the numcheck suite on the
    card (every algorithm x dtype x direction at the probe spec, the
    kernel paths on the Table-3 layers at batch 16 in f32 and bf16), and
    the lint with its empty baseline.  Returns the kernels' launches in
    the numcheck sweep."""
    from repro_torch.analysis import launch_check as LC
    from repro_torch.analysis import lint
    from repro_torch.analysis.__main__ import run_numcheck
    from repro_torch.bench.scenarios import CV_LAYERS
    from repro_torch.bench.scenarios import RESNET101_WEIGHTS as RESNET101
    from repro_torch.core.convspec import ConvSpec
    from repro_torch.kernels import mec_conv as K, ops

    t_phase = time.perf_counter()
    cases = [(batch, geom) for _, geom, batch in geoms]
    cases += [(SLICE_BATCH, CV_LAYERS[n]) for n in RESNET101]
    cases += [(1, LAUNCH_REFUSED)]
    compared, both_refused, mismatches = 0, [], []
    for dname in ("float32", "bfloat16"):
        for batch, (ih, iw, ic, kh, kw, kc, s) in cases:
            s_h, s_w = stride_pair(s)
            spec = ConvSpec(batch, ih, iw, ic, kh, kw, kc, s_h, s_w)
            for alg in LC.KERNEL_ALGORITHMS:
                try:
                    want = ops.launch_config(alg[len("mec_"):], DTYPES[dname],
                                             (batch, ih, iw, ic),
                                             (kh, kw, ic, kc), (s_h, s_w))
                except K.LaunchRefused:
                    want = None
                got = LC.launcher_fields(alg, dname, spec, None)
                compared += 1
                if got != want:
                    mismatches.append([str(spec), alg, dname, got, want])
                elif got is None:
                    both_refused.append(f"{alg} {dname} {ih}x{iw}x{ic} "
                                        f"k{kh}x{kw}x{kc}")
    check(not mismatches, f"launch check differs from the launcher: "
          f"{mismatches[:5]}")
    check(len(both_refused) >= 1, "no geometry that both refuse")

    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        doc, n_fail, n_skip = run_numcheck("cuda")
    torch.cuda.synchronize()
    numcheck_s = time.perf_counter() - t0
    launches = K.launch_counts()
    check(n_fail == 0, f"numcheck: {n_fail} cell(s) broke their contract")
    check(all(r["skipped_reason"] for r in doc["results"]
              if r["verdict"] == "skipped"), "numcheck: a skip with no reason")
    check(all(n > 0 for n in launches.values()),
          f"numcheck launched {launches}: a kernel never ran")
    worst = {}
    for r in doc["results"]:
        if r["probe"] is None:
            continue
        p = r["probe"]
        ratio = max(p["fwd_err"] / p["budget_fwd"],
                    p["din_err"] / p["budget_grad"],
                    p["dk_err"] / p["budget_grad_kernel"])
        key = f"{r['source']}/{r['dtype']}"
        worst[key] = max(worst.get(key, 0.0), ratio)
    findings = lint.lint_tree(ROOT)
    baseline = lint.load_baseline(ROOT / lint.DEFAULT_BASELINE)
    check(not findings and not baseline,
          f"lint: {[f.render() for f in findings]}, baseline {baseline}")
    emit({"phase": "analysis", "seconds": round(time.perf_counter() - t_phase, 3),
          "launch_check": {"compared": compared, "fields_equal": True,
                           "both_refused": both_refused},
          "numcheck": {"cells": len(doc["results"]), "failed": n_fail,
                       "skipped": n_skip, "seconds": round(numcheck_s, 3),
                       "worst_err_over_budget": worst},
          "lint": {"findings": 0, "baseline": 0}, "launches": launches})
    return launches


def examples_phase(tol_of) -> dict:
    """The quickstart and the paper-figure drivers on the card (phase 4e),
    at the paper's sizes: ``repro_torch.examples.quickstart`` (every
    algorithm against ``direct``, within twice its contract, a plan
    round-tripped and replayed), then ``repro_torch.benchmarks.run``
    (Fig. 4(a)-(e), Table 3, the traffic model); their CSV lines go to
    stderr.  Table 3's ratios stand beside the paper's 3.2x / 1.2x.
    Returns the kernels' launches."""
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.examples import quickstart
    from repro_torch.kernels import mec_conv as K

    def to_stderr(line):
        print(line, file=sys.stderr, flush=True)

    t_phase = time.perf_counter()
    K.reset_launch_counts()
    torch.cuda.synchronize()
    q = quickstart.main(["--device", "cuda"], emit=to_stderr)
    for name, kw in quickstart.ALGORITHMS:
        tol = tol_of(kw["algorithm"], "float32", 3 * 3 * 8)
        check(q["errors"][name] <= 2 * tol * q["scale"],
              f"quickstart {name}: {q['errors'][name]} vs direct")
    check(q["replay_matches_auto"], "quickstart: the replayed plan differs")
    quick_s = time.perf_counter() - t_phase
    results = bench_run.main(["--device", "cuda"], emit=to_stderr)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    check(all(n > 0 for n in launches.values()),
          f"the examples launched {launches}: a kernel never ran")
    t3 = results["table3_resnet101"]
    fig4cd = results["fig4cd_runtime"]
    emit({"phase": "examples", "seconds": round(time.perf_counter() - t_phase, 3),
          "quickstart": {"seconds": round(quick_s, 3),
                         "max_err_over_scale": max(q["errors"].values())
                         / q["scale"], "auto": q["auto"]},
          "table3": {"mem_ratio": t3["mem_ratio"], "paper_mem_ratio": 3.2,
                     "runtime_ratio": t3["runtime_ratio"],
                     "runtime_ratio_any_mec": t3["runtime_ratio_any_mec"],
                     "paper_runtime_ratio": 1.2,
                     "t_im2col_us": t3["t_im2col_us"], "t_mec_us": t3["t_mec_us"],
                     "t_any_mec_us": t3["t_any_mec_us"]},
          "fig4cd_mec_vs_im2col_geomean": math.prod(fig4cd) ** (1 / len(fig4cd)),
          "fig4a_mem_ratio_s10": results["fig4a_ks_sweep"],
          "launches": launches})
    return launches


def conv_bound_ms(spec, es: int, peak_tf32: float, peak_bw: float):
    """(ms, by) of a conv's bound on the card: its multiply-adds as three
    TF32 tensor-core products each (K1's own f32 arithmetic) against its
    bytes (input, kernel and output once each)."""
    from repro_torch.core import memory
    n_in = spec.i_n * spec.i_h * spec.i_w * spec.i_c
    n_k = spec.k_h * spec.k_w * spec.i_c * spec.k_c
    t_ops = TF32_PRODUCTS * memory.conv_flops(spec) / peak_tf32
    t_bytes = (n_in + n_k + math.prod(spec.out_shape)) * es / peak_bw
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def served_checks(svc, x, got, tol_of) -> float:
    """A served answer against the eager ``conv2d(plan=)`` of the request's
    padded class input (equal bits: the replay runs the same kernel) and
    against the f64 oracle of the request itself (within the plan's f32
    contract).  Returns the scaled error against the oracle."""
    from repro_torch.core.conv_api import apply_padding, conv2d
    from repro_torch.kernels import ref
    cls = svc.bucket(x.shape)
    plan = svc.plans[cls]
    o_n, o_h, o_w, _ = svc.request_out_shape(x.shape)
    with torch.no_grad():
        eager = conv2d(svc.pad_to_class(x, cls), svc.kernel, stride=svc.stride,
                       padding=svc.padding, plan=plan)[:o_n, :o_h, :o_w]
    check(tuple(got.shape) == tuple(eager.shape) and torch.equal(got, eager),
          f"served {tuple(x.shape)} in class {cls.tag()}: the graph replay "
          f"differs from the eager conv2d(plan=)")
    k_h, k_w, i_c, _ = svc.kernel.shape
    oracle = ref.conv2d_f64(apply_padding(x, k_h, k_w, *svc.stride, svc.padding),
                            svc.kernel, svc.stride)
    err = ref.scaled_error(got, oracle)
    tol = tol_of(plan.algorithm, "float32", k_h * k_w * i_c)
    check(math.isfinite(err) and err <= tol,
          f"served {tuple(x.shape)} in class {cls.tag()}: error {err} vs f64 "
          f"> tol {tol}")
    return err


def class_latencies(svc, reqs) -> dict:
    """Per class of ``svc``: p50 and p99 (us) of the warm service and of
    eager ``conv2d(algorithm="auto")``, host clock, device synchronised."""
    from repro_torch.bench.harness import serve_latencies
    out = {}
    for mode in ("warm", "auto"):
        per_class, _ = serve_latencies(svc, reqs, mode)
        for cls, lat in per_class.items():
            if lat:
                out.setdefault(cls.tag(), {})[mode] = {
                    "n": len(lat), "p50_us": statistics.median(lat),
                    "p99_us": float(sorted(lat)[max(0, math.ceil(0.99 * len(lat)) - 1)])}
    return out


def serve_conv_phase(seed: int, tol_of, peak_tf32: float, peak_bw: float) -> dict:
    """Plan-driven conv serving on the card (phase 6b).  (a) The whisper
    mel frontend at whisper-tiny's width (80 mels -> 384, f32) as two
    ConvServices over WHISPER_CLASSES, warmed through the plan cache
    (K1, the cached policy's pick on the card) and driven by a fixed
    stream of mixed (n, T) mels; (b) the patch embed at llava-next-34b's
    width over PATCH_CLASSES.  Counts are read around the warm-up and the
    stream alone.  Then every answer against the eager planned conv (equal
    bits) and the f64 oracle, warm and auto latencies per class, and every
    candidate timed on the whisper layers' largest class by the measured
    planner.  (c) The bench ``serve`` suite, gated by ``bench.check``
    against the JAX package's baseline.  Returns the launches of each
    part and the K1 timings for the kernels line."""
    import numpy as np
    from repro_torch.bench import check as bench_check
    from repro_torch.bench.harness import run_serve
    from repro_torch.configs.archs import ARCHS
    from repro_torch.kernels import mec_conv as K
    from repro_torch.plan import global_plan_cache, tune_measured
    from repro_torch.serving import patch_embed_service, whisper_frontend_service

    t_phase = time.perf_counter()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 20)
    d_model = ARCHS[WHISPER_ARCH].d_model
    rng = np.random.RandomState(seed)
    shapes = [(WHISPER_STREAM_N[(i // len(WHISPER_STREAM_T) + i) % 3],
               WHISPER_STREAM_T[i % len(WHISPER_STREAM_T)])
              for i in range(WHISPER_REQUESTS)]
    shapes = [shapes[i] for i in rng.permutation(len(shapes))]
    mels = [torch.randn((n, t, N_MELS), generator=gen, device=DEVICE)
            for n, t in shapes]
    io_before = global_plan_cache().io_errors
    torch.cuda.synchronize()

    # (a) the whisper frontend: warm-up and the stream, counted
    K.reset_launch_counts()
    t0 = time.perf_counter()
    frontend, (svc1, svc2) = whisper_frontend_service(
        gen, N_MELS, d_model, WHISPER_CLASSES, device=DEVICE)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    served = []
    for mel in mels:
        x1 = mel[:, :, None, :]
        y1 = svc1(x1)
        h = F.gelu(y1, approximate="tanh")
        y2 = svc2(h)
        served.append((x1, y1, h, y2))
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    whisper_launches = K.launch_counts()
    replays = {f"conv{i + 1}": {c.tag(): n for c, n in svc.replays.items()}
               for i, svc in enumerate((svc1, svc2))}
    for svc in (svc1, svc2):
        check(svc.warmup.warning_count == 0 and svc.warmup.plan_cache_io_errors == 0,
              f"whisper frontend warm-up: {svc.warmup.summary()}")
        check(all(p.algorithm == "mec_fused" for p in svc.plans.values()),
              f"whisper frontend plans {[p.algorithm for p in svc.plans.values()]}: "
              "not K1")
    check(whisper_launches == {"mec_conv_fused": 2 * 2 * len(WHISPER_CLASSES),
                               "mec_lower": 0, "mec_gemm": 0, "mec_conv_fused2": 0},
          f"whisper frontend launched {whisper_launches}: K1 once eagerly and "
          f"once captured per class and layer")
    check(sum(sum(r.values()) for r in replays.values()) == 2 * WHISPER_REQUESTS,
          f"whisper frontend replays {replays}")
    errs = {"conv1": 0.0, "conv2": 0.0}
    for x1, y1, h, y2 in served:
        errs["conv1"] = max(errs["conv1"], served_checks(svc1, x1, y1, tol_of))
        errs["conv2"] = max(errs["conv2"], served_checks(svc2, h, y2, tol_of))
    frames = frontend(mels[0])
    check(torch.equal(frames, F.gelu(served[0][3], approximate="tanh")[:, :, 0, :]),
          "the whisper frontend differs from its services' answers")
    lat = {"conv1": class_latencies(svc1, [s[0] for s in served]),
           "conv2": class_latencies(svc2, [s[2] for s in served])}

    # every candidate on the largest class of each layer, measured
    cls = max(WHISPER_CLASSES)
    measured, k1_ms = {}, {}
    for name, svc in (("conv1", svc1), ("conv2", svc2)):
        spec = svc.class_spec(shape_class(cls))
        plan, detail = tune_measured(spec, "float32", backend=DEVICE,
                                     iters=PLAN_ITERS, warmup=PLAN_WARMUP)
        check("mec_fused" in detail["candidate_us"] and not any(
            a in detail["skipped"] for a in PLAN_KERNEL_ALGOS),
              f"whisper {name}: kernel candidates skipped {detail['skipped']}")
        b_ms, b_by = conv_bound_ms(spec, 4, peak_tf32, peak_bw)
        x = torch.randn((spec.i_n, spec.i_h, spec.i_w, spec.i_c), generator=gen,
                        device=DEVICE)
        plain_ms = time_ms(lambda: K.mec_conv_fused_plain(x, svc.kernel,
                                                          svc.stride))
        del x
        measured[name] = {"spec": str(spec), "candidate_us": detail["candidate_us"],
                          "spread": {a: s.get("us_rel_spread") for a, s in
                                     detail["candidate_stats"].items()},
                          "skipped": detail["skipped"],
                          "measured_pick": plan.algorithm,
                          "measured_w_blk": plan.w_blk,
                          "k1_plain_ms": plain_ms,
                          "served_plan": svc.plans[shape_class(cls)].algorithm,
                          "served_w_blk": svc.plans[shape_class(cls)].w_blk,
                          "bound_ms": b_ms, "bound_by": b_by}
        k1_ms[name] = {"ms": detail["candidate_us"]["mec_fused"] / 1e3,
                       "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": detail["candidate_us"].get("direct", 0) / 1e3}
    emit({"phase": "serve_conv", "part": "whisper_frontend", "d_model": d_model,
          "classes": [c.tag() for c in svc1.classes], "requests": len(shapes),
          "request_shapes": shapes, "warm_seconds": round(warm_s, 4),
          "stream_seconds": round(stream_s, 4), "launches": whisper_launches,
          "replays": replays, "max_scaled_err_vs_f64": errs,
          "plans": {f"conv{i + 1}": {c.tag(): [p.algorithm, p.w_blk]
                                     for c, p in svc.plans.items()}
                    for i, svc in enumerate((svc1, svc2))},
          "latency_us": lat, "measured": measured})
    del served, frontend, svc1, svc2, mels, frames
    torch.cuda.empty_cache()

    # (b) the patch embed at llava-next-34b's width
    d_vlm, prefix = ARCHS[PATCH_ARCH].d_model, ARCHS[PATCH_ARCH].prefix_len
    images = [torch.randn((n, hh, ww, PATCH_IN), generator=gen, device=DEVICE)
              for n, hh, ww in PATCH_STREAM]
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    pfront, psvc = patch_embed_service(gen, PATCH_IN, d_vlm, PATCH, PATCH_CLASSES,
                                       prefix, device=DEVICE)
    torch.cuda.synchronize()
    pwarm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    answers = [psvc(images[i % len(images)]) for i in range(PATCH_REQUESTS)]
    torch.cuda.synchronize()
    pstream_s = time.perf_counter() - t0
    patch_launches = K.launch_counts()
    check(psvc.warmup.warning_count == 0 and psvc.warmup.plan_cache_io_errors == 0,
          f"patch embed warm-up: {psvc.warmup.summary()}")
    check(patch_launches == {"mec_conv_fused": 2 * len(PATCH_CLASSES),
                             "mec_lower": 0, "mec_gemm": 0, "mec_conv_fused2": 0},
          f"patch embed launched {patch_launches}")
    perr = 0.0
    for img, ans in zip(images, answers):
        perr = max(perr, served_checks(psvc, img, ans, tol_of))
    del answers
    tokens = pfront(images[0])
    check(tuple(tokens.shape) == (PATCH_STREAM[0][0], prefix, d_vlm)
          and bool(torch.isfinite(tokens).all()),
          f"patch embed tokens {tuple(tokens.shape)}")
    del tokens
    plat = class_latencies(psvc, images)
    emit({"phase": "serve_conv", "part": "patch_embed", "d_model": d_vlm,
          "patch": PATCH, "prefix_len": prefix,
          "classes": [c.tag() for c in psvc.classes], "requests": PATCH_REQUESTS,
          "warm_seconds": round(pwarm_s, 4), "stream_seconds": round(pstream_s, 4),
          "launches": patch_launches,
          "replays": {c.tag(): n for c, n in psvc.replays.items()},
          "max_scaled_err_vs_f64": perr,
          "plans": {c.tag(): [p.algorithm, p.w_blk] for c, p in psvc.plans.items()},
          "latency_us": plat})
    del pfront, psvc, images
    torch.cuda.empty_cache()

    # (c) the bench serve suite, checked against the JAX package's baseline
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    doc = run_serve(device=DEVICE)
    torch.cuda.synchronize()
    bench_s = time.perf_counter() - t0
    bench_launches = K.launch_counts()
    failures, _ = bench_check.compare(
        doc, json.loads((ROOT / SERVE_BASELINE).read_text()),
        schema_only_on_timing=True)
    check(not failures, f"bench serve against {SERVE_BASELINE}: {failures}")
    check(all(r["warmup_warnings"] == 0 and r["plan_cache_io_errors"] == 0
              for r in doc["results"]), "bench serve: warm-up warnings")
    check(bench_launches["mec_conv_fused"] > 0,
          f"bench serve launched {bench_launches}")
    io_errors = global_plan_cache().io_errors - io_before
    check(io_errors == 0, f"plan cache I/O errors in the serve phase: {io_errors}")
    by = {}
    for r in doc["results"]:
        by.setdefault(r["scenario"], {})[r["serve_mode"]] = [
            r["p50_us"], r["p99_us"], r["first_request_us"]]
    emit({"phase": "serve_conv", "part": "bench_serve", "seconds": round(bench_s, 3),
          "records": len(doc["results"]), "check": "ok",
          "p50_p99_first_us": by, "launches": bench_launches,
          "plan_cache_io_errors": io_errors,
          "phase_seconds": round(time.perf_counter() - t_phase, 3)})
    return {"whisper": whisper_launches, "patch": patch_launches,
            "bench": bench_launches, "whisper_k1": k1_ms}


def shape_class(cls):
    from repro_torch.serving import ShapeClass
    return ShapeClass(*cls)


def serve_whisper_phase(seed: int) -> dict:
    """whisper-tiny served on the card (phase 6c) at its published widths
    and full depth (4 + 4 layers), bf16, seeded random weights:
    ``python -m repro_torch.launch.serve --arch whisper-tiny --warm-plans``
    (its output to stderr), then the same through ``serve()`` with the
    counts read around it: the mel (batch 4, 3000 frames) through the
    warmed frontend (K1 on the card), ``fit_prefix`` to encoder_len, the
    encoder, a prefill of 32 tokens and 32 greedy tokens.  Decode against a
    prefill of the extended sequence (gated in f32, reported in bf16), and
    one prefill traced for device time and idle share."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.archs import ARCHS
    from repro_torch.kernels import mec_conv as K
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import lm as lm_mod, serve as serve_lib
    from repro_torch.models.layers import f32_accumulation
    from repro_torch.serving import fit_prefix

    t_phase = time.perf_counter()
    cfg = ARCHS[WHISPER_ARCH]
    with contextlib.redirect_stdout(sys.stderr):
        cli = launch_serve.main(["--arch", WHISPER_ARCH, "--warm-plans",
                                 "--batch", str(WHISPER_BATCH),
                                 "--prompt-len", str(WHISPER_PROMPT),
                                 "--gen", str(WHISPER_GEN)])
    check(tuple(cli.shape) == (WHISPER_BATCH, WHISPER_GEN),
          f"the whisper-tiny CLI served {tuple(cli.shape)}")
    torch.cuda.synchronize()
    K.reset_launch_counts()
    res = launch_serve.serve(cfg, batch=WHISPER_BATCH, prompt_len=WHISPER_PROMPT,
                             gen=WHISPER_GEN, device=DEVICE, seed=seed,
                             warm_plans=True)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    check(launches == {"mec_conv_fused": 4, "mec_lower": 0, "mec_gemm": 0,
                       "mec_conv_fused2": 0},
          f"whisper-tiny served with {launches}: K1 once eagerly and once "
          "captured per frontend layer")
    check([r.warning_count for r in res["warmup"]] == [0, 0]
          and [r.plan_cache_io_errors for r in res["warmup"]] == [0, 0],
          f"whisper-tiny warm-up: {[r.summary() for r in res['warmup']]}")
    check([[p.algorithm for p in r.plans.values()] for r in res["warmup"]]
          == [["mec_fused"], ["mec_fused"]], "whisper-tiny frontend not on K1")
    toks = res["tokens"]
    check(tuple(toks.shape) == (WHISPER_BATCH, WHISPER_GEN)
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab,
          f"whisper-tiny tokens {tuple(toks.shape)}")
    check(bool(torch.isfinite(res["prefill_logits"]).all())
          and bool(torch.isfinite(res["logits"]).all()),
          "whisper-tiny logits are not finite")

    # decode against a prefill of the extended sequence, and the profile
    decode, prof_out = {}, None
    for dname in ("float32", "bfloat16"):
        dcfg = cfg.with_(dtype=dname)
        model = lm_mod.LM(dcfg)
        with torch.inference_mode(), f32_accumulation():
            frontend, _ = launch_serve.warm_frontend(
                dcfg, launch_serve.default_shape_classes(dcfg, WHISPER_BATCH),
                seed, DEVICE)
            params = launch_serve.init_params(dcfg, seed, DEVICE)
            prompt = launch_serve.make_prompt(dcfg, WHISPER_BATCH, WHISPER_PROMPT,
                                              seed, DEVICE)
            g = torch.Generator(device=DEVICE)
            g.manual_seed(seed + 4)
            mel = torch.randn((WHISPER_BATCH, WHISPER_MEL_T, N_MELS), generator=g,
                              device=DEVICE)
            frames = fit_prefix(frontend(mel), dcfg.encoder_len)
            full, _ = serve_lib.prefill(model, params, {"tokens": prompt,
                                                        "frames": frames},
                                        WHISPER_PROMPT)
            _, cache = serve_lib.prefill(
                model, params, {"tokens": prompt[:, :WHISPER_DECODE_FROM],
                                "frames": frames}, WHISPER_PROMPT)
            for i in range(WHISPER_DECODE_FROM, WHISPER_PROMPT):
                logits, cache = serve_lib.decode_step(model, params, cache,
                                                      prompt[:, i:i + 1])
            decode[dname] = scaled_err(logits, full)
            if dname == "float32":
                check(decode[dname] <= LOGITS_TOL,
                      f"whisper-tiny decode vs prefill, f32: {decode[dname]} "
                      f"> {LOGITS_TOL}")
                continue
            served_err = scaled_err(full, res["prefill_logits"])
            check(served_err <= LOGITS_TOL,
                  f"whisper-tiny serve() and a prefill of the same inputs: "
                  f"{served_err}")
            inputs = {"tokens": prompt, "frames": frames}
            max_len = WHISPER_PROMPT + WHISPER_GEN
            serve_lib.prefill(model, params, inputs, max_len)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                serve_lib.prefill(model, params, inputs, max_len)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            prof_out = device_breakdown(prof, wall, top=8)
        del params, frames, cache, full
    torch.cuda.empty_cache()
    emit({"phase": "serve_whisper", "arch": WHISPER_ARCH, "dtype": cfg.dtype,
          "layers": {"encoder": cfg.encoder_layers, "decoder": cfg.n_layers},
          "d_model": cfg.d_model, "heads": cfg.n_heads, "d_ff": cfg.d_ff,
          "vocab": cfg.vocab, "encoder_len": cfg.encoder_len,
          "params": cfg.param_count(), "batch": WHISPER_BATCH,
          "mel_frames": WHISPER_MEL_T, "prompt": WHISPER_PROMPT,
          "generated": WHISPER_GEN, "frontend_launches": launches,
          "warm_seconds": res["warm_s"], "frontend_seconds": res["frontend_s"],
          "prefill_seconds": res["prefill_s"], "decode_seconds": res["decode_s"],
          "decode_tokens_per_s": res["decode_tokens_per_s"],
          "decode_vs_prefill": decode, "serve_vs_prefill_err": served_err,
          "prefill_profile": prof_out,
          "phase_seconds": round(time.perf_counter() - t_phase, 3)})
    return launches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    # 1. device ------------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false); this script measures the GPU port only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    peak_flops, peak_bw, peak_tf32, peak_bf16, peak_label = peaks_for(kind)
    print(smi, flush=True)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "peak_f32_flops": peak_flops,
          "peak_bytes_per_s": peak_bw, "peak_tf32_flops": peak_tf32,
          "peak_bf16_flops": peak_bf16, "peak_source": peak_label})
    # A plan cache or calibration left on the machine must not decide a
    # pick: both live in a directory made for this run.
    plan_dir = tempfile.mkdtemp(prefix="chip_smoke-plans-")
    atexit.register(shutil.rmtree, plan_dir, True)
    os.environ["REPRO_TORCH_PLAN_CACHE_DIR"] = str(Path(plan_dir) / "plans")
    os.environ["REPRO_TORCH_CALIBRATION"] = str(Path(plan_dir) / "calibration.json")
    # The plain versions and the oracle use cuBLAS/cuDNN: keep f32 IEEE.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    check(Path(repro_torch.__file__).resolve().is_relative_to(ROOT),
          f"repro_torch imported from {repro_torch.__file__}, not {ROOT}")
    from repro_torch.core import memory
    from repro_torch.core.conv_api import conv2d, conv2d_spec, resolve_algorithm
    from repro_torch.core.convspec import spec_of
    from repro_torch.core.direct import ieee_f32_conv
    from repro_torch.core.numerics import fwd_tolerance, grad_tolerance
    from repro_torch.examples import train_cnn
    from repro_torch.configs.archs import ARCHS
    from repro_torch.core.mec import mec_conv1d_depthwise
    from repro_torch.kernels import build, mec_conv as K, mec_conv1d as C, ref
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import lm as lm_mod, serve as serve_lib
    from repro_torch.models.layers import f32_accumulation, linear, rms_norm
    from repro_torch.kernels.ops import (mec_conv2d_cuda, pick_fused_w_blk,
                                         pick_oh_blk)
    from repro_torch.models.layers import init_conv2d
    from repro_torch.plan import global_plan_cache, plan_cache_key
    from repro_torch.bench.scenarios import CV_LAYERS
    from repro_torch.bench.scenarios import RESNET101_WEIGHTS as RESNET101
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    check(not bad, f"the port loaded {bad}")

    # 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build()
    K._lib()          # load and bind the libraries now, not inside a timing
    C._lib()
    build_s = time.perf_counter() - t0
    for name, info in built.items():
        ptxas = [ln.strip() for ln in info["log"].splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        print("\n".join([f"[ptxas {name}]"] + ptxas), file=sys.stderr, flush=True)
    emit({"phase": "build", "seconds": round(build_s, 3),
          "libraries": {n: {"compiled": i["compiled"],
                            "nvcc_seconds": round(i["seconds"], 3)}
                        for n, i in built.items()}})

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(args.seed)

    # 3. kernels -----------------------------------------------------------
    geoms = [(f"sweep{i}", g, 2) for i, g in enumerate(SWEEP)]
    geoms += [(name, g, 2) for name, g in EDGE_GEOMS.items()]
    geoms += [(name, g, 1) for name, g in CV_LAYERS.items()]
    worst = {}
    for dname, dtype in DTYPES.items():
        for name, geom, batch in geoms:
            x, k = make_operands(gen, batch, geom, dtype)
            kh, kw, kc, s = geom[3], geom[4], geom[5], geom[6]
            s_h, s_w = stride_pair(s)
            spec = spec_of(x, k, (s_h, s_w))
            tol = fwd_tolerance("mec_fused", dname, kh * kw * geom[2])
            oracle = ref.conv2d_f64(x, k, (s_h, s_w))
            f_blk = pick_fused_w_blk(spec.o_w, kc, batch, spec.o_h)
            oh_blk = pick_oh_blk(spec.o_h, spec.o_w, f_blk, kc, batch)
            tile = K.fused2_tile(oh_blk, f_blk, kh, kw, s_h, s_w)
            check(tile == (oh_blk, f_blk),
                  f"K4 {name}: launcher's sub-tile {tile} is not the picked "
                  f"block {(oh_blk, f_blk)}")
            y1 = K.mec_conv_fused(x, k, (s_h, s_w), w_blk=f_blk)
            y4 = K.mec_conv_fused2(x, k, (s_h, s_w), w_blk=f_blk, oh_blk=oh_blk)
            low = K.mec_lower(x, kw, s_w)
            kmat = k.reshape(kh, kw * geom[2], kc)
            y3 = K.mec_gemm(low, kmat, kh, s_h)
            torch.cuda.synchronize()
            check(torch.equal(low, K.mec_lower_plain(x, kw, s_w))
                  and torch.equal(low, ref.lower_ref(x, kw, s_w)),
                  f"K2 mec_lower differs from its plain version on {name} {dname}")
            row = {"phase": "kernels", "geom": name, "dtype": dname,
                   "tol": tol}
            for kname, y, plain in (
                    ("K1", y1, K.mec_conv_fused_plain(x, k, (s_h, s_w))),
                    ("K3", y3, K.mec_gemm_plain(low, kmat, kh, s_h)),
                    ("K4", y4, K.mec_conv_fused2_plain(x, k, (s_h, s_w), oh_blk))):
                check(y.shape == spec.out_shape and y.dtype == dtype,
                      f"{kname} {name} {dname}: {tuple(y.shape)} {y.dtype}")
                e_o, e_p = ref.scaled_error(y, oracle), ref.scaled_error(y, plain)
                row[kname] = [e_o, e_p]
                check(math.isfinite(e_o) and e_o <= tol,
                      f"{kname} {name} {dname}: error {e_o} vs f64 > tol {tol}")
                check(e_p <= 2 * tol,
                      f"{kname} {name} {dname}: error {e_p} vs plain > {2 * tol}")
                key = (kname, dname)
                worst[key] = max(worst.get(key, 0.0), e_o / tol, e_p / (2 * tol))
            emit(row, sys.stderr)
    emit({"phase": "kernels", "checked": len(geoms) * len(DTYPES),
          "K2": "exact",
          "worst_err_over_tol": {f"{k}/{d}": round(v, 4)
                                 for (k, d), v in sorted(worst.items())}})

    # K5: the test cases and F2 at batch 2, the zamba2-7b conv input as a
    # column slice, and long_500k for the 64-bit offsets.
    conv1d_rows = []
    for dname, dtype in DTYPES.items():
        for t, c, kw in CONV1D_CASES:
            x = torch.randn((2, t, c), generator=gen, device=DEVICE).to(dtype)
            k = torch.randn((kw, c), generator=gen, device=DEVICE).to(dtype)
            conv1d_rows.append(conv1d_case(C, ref, f"t{t}_c{c}_kw{kw}", dname,
                                           x, k))
        zx = torch.randn((SERVE_BATCH, SERVE_PROMPT, IN_PROJ), generator=gen,
                         device=DEVICE).to(dtype)
        k = torch.randn((4, CONV_HI - CONV_LO), generator=gen,
                        device=DEVICE).to(dtype)
        conv1d_rows.append(conv1d_case(C, ref, "zamba2_slice", dname,
                                       zx[..., CONV_LO:CONV_HI], k))
        del zx
    x = torch.randn((1, LONG_T, CONV_HI - CONV_LO), generator=gen,
                    device=DEVICE, dtype=torch.bfloat16)
    k = torch.randn((4, CONV_HI - CONV_LO), generator=gen, device=DEVICE,
                    dtype=torch.bfloat16)
    check(x.numel() > 2 ** 31, f"long_500k input has {x.numel()} elements")
    for window in ((0, LONG_WINDOW), (LONG_T - LONG_WINDOW, LONG_T)):
        conv1d_rows.append(conv1d_case(C, ref, f"long_500k_{window[0]}",
                                       "bfloat16", x, k, window))
    del x, k
    # K5's runtime-k_w path (fault F5), to the bit like the others
    for dname, dtype in DTYPES.items():
        for t, c, kw in CONV1D_ANY_KW:
            x = torch.randn((2, t, c), generator=gen, device=DEVICE).to(dtype)
            k = torch.randn((kw, c), generator=gen, device=DEVICE).to(dtype)
            conv1d_rows.append(conv1d_case(C, ref, f"t{t}_c{c}_kw{kw}", dname,
                                           x, k))
    torch.cuda.empty_cache()
    for row in conv1d_rows:
        emit({"phase": "kernels", "kernel": "K5", **row}, sys.stderr)
    emit({"phase": "kernels", "kernel": "K5", "checked": len(conv1d_rows),
          "bit_exact_vs_plain": sum(r["bit_exact_vs_plain"] for r in conv1d_rows),
          "worst_scaled_err_vs_f64": {
              d: max(r["scaled_err_vs_f64"] for r in conv1d_rows if r["dtype"] == d)
              for d in DTYPES}})

    # Mixed operand dtypes (fault F4): K1, K4, K2+K3 and K5 run their f32
    # instance on both operands promoted, equal to the bit to that run cast
    # to the input's dtype, and within the input dtype's contract of f64.
    mixed = []
    for xd, kd in MIXED:
        x, _ = make_operands(gen, 2, MIXED_GEOM, DTYPES[xd])
        _, k = make_operands(gen, 2, MIXED_GEOM, DTYPES[kd])
        oracle = ref.conv2d_f64(x, k, 1)
        row = {"phase": "kernels", "mixed": [xd, kd]}
        for mode in ("fused", "fused2", "lowered"):
            y = mec_conv2d_cuda(x, k, 1, mode=mode)
            want = mec_conv2d_cuda(x.float(), k.float(), 1, mode=mode).to(x.dtype)
            tol = fwd_tolerance("mec_" + mode, xd, 9 * MIXED_GEOM[2])
            e = ref.scaled_error(y, oracle)
            check(y.dtype == x.dtype and torch.equal(y, want) and e <= tol,
                  f"{mode} on {xd} x {kd}: not its f32 run on promoted "
                  f"operands, or error {e} > tol {tol}")
            row[mode] = e
        for kw in (4, 9):
            x1 = torch.randn((2, 1024, 256), generator=gen, device=DEVICE).to(DTYPES[xd])
            k1 = torch.randn((kw, 256), generator=gen, device=DEVICE).to(DTYPES[kd])
            y1 = C.mec_conv1d(x1, k1)
            check(y1.dtype == x1.dtype
                  and torch.equal(y1, C.mec_conv1d(x1.float(), k1.float()).to(x1.dtype))
                  and torch.equal(y1, C.mec_conv1d_plain(x1, k1)),
                  f"K5 k_w={kw} on {xd} x {kd}: not its f32 run on promoted operands")
        row["K5"] = "equal bits"
        mixed.append(row)
        emit(row, sys.stderr)
    del x, k, oracle, y, want, x1, k1, y1
    emit({"phase": "kernels", "mixed_dtypes": len(mixed) * 5,
          "equal_to_promoted_f32_run": True})

    # 4. slice: the main path ----------------------------------------------
    stack = []
    for name, count in RESNET101.items():
        ih, iw, ic, kh, kw, kc, s = CV_LAYERS[name]
        x = torch.randn((SLICE_BATCH, ih, iw, ic), generator=gen, device=DEVICE)
        for _ in range(count):
            w = init_conv2d(gen, kh, kw, ic, kc, device=DEVICE)["w"]
            spec = conv2d_spec(x, w, stride=s, padding="VALID")
            check(resolve_algorithm(spec, x.device) == "mec_fused",
                  f"auto resolves {name} to {resolve_algorithm(spec, x.device)}")
            stack.append((name, x, w, s, spec))
    check(len(stack) == 34, f"{len(stack)} convs in the ResNet-101 stack")

    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [conv2d(x, w, stride=s, padding="VALID", algorithm="auto")
            for _, x, w, s, _ in stack]
    torch.cuda.synchronize()
    auto_s = time.perf_counter() - t0
    auto_counts = K.launch_counts()
    check(auto_counts["mec_conv_fused"] >= len(stack)
          and auto_counts["mec_lower"] == 0 and auto_counts["mec_gemm"] == 0,
          f"auto path launched {auto_counts}")
    for name, _, _, _, spec in stack:
        hit = global_plan_cache().get(plan_cache_key(spec, "float32", "cuda"))
        check(hit is not None and hit.algorithm == "mec_fused" and hit.w_blk
              == pick_fused_w_blk(spec.o_w, spec.k_c, spec.i_n, spec.o_h),
              f"auto's cached plan for {name}: {hit}")

    lowered = [(n, x, w, s, spec) for i, (n, x, w, s, spec) in enumerate(stack)
               if i == 0 or stack[i - 1][0] != n]
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs_low = [conv2d(x, w, stride=s, padding="VALID", algorithm="mec_lowered")
                for _, x, w, s, _ in lowered]
    torch.cuda.synchronize()
    lowered_s = time.perf_counter() - t0
    low_counts = K.launch_counts()
    check(low_counts["mec_lower"] >= len(lowered)
          and low_counts["mec_gemm"] >= len(lowered)
          and low_counts["mec_conv_fused"] == 0,
          f"mec_lowered path launched {low_counts}")

    abs_err = {"mec_conv_fused": 0.0, "mec_lower": 0.0, "mec_gemm": 0.0}
    scaled = {"auto": 0.0, "mec_lowered": 0.0}
    checked_oracle = set()
    for path, runs, ys in (("auto", stack, outs), ("mec_lowered", lowered, outs_low)):
        for (name, x, w, s, spec), y in zip(runs, ys):
            check(tuple(y.shape) == spec.out_shape and bool(torch.isfinite(y).all()),
                  f"{path} {name}: shape {tuple(y.shape)} or non-finite values")
            tol = fwd_tolerance("mec_fused", "float32", spec.k_h * spec.k_w * spec.i_c)
            plain = K.mec_conv_fused_plain(x, w, s)
            e = ref.scaled_error(y, plain)
            check(e <= 2 * tol, f"{path} {name}: error {e} vs plain > {2 * tol}")
            scaled[path] = max(scaled[path], e)
            diff = (y - plain).abs().max().item()
            if path == "auto":
                abs_err["mec_conv_fused"] = max(abs_err["mec_conv_fused"], diff)
            else:
                abs_err["mec_gemm"] = max(abs_err["mec_gemm"], diff)
                s_h, s_w = stride_pair(s)
                low = K.mec_lower(x, spec.k_w, s_w)
                check(torch.equal(low, K.mec_lower_plain(x, spec.k_w, s_w)),
                      f"K2 differs from its plain version on {name}")
            if (path, name) not in checked_oracle:
                checked_oracle.add((path, name))
                e_o = ref.scaled_error(y, ref.conv2d_f64(x, w, s))
                check(e_o <= tol, f"{path} {name}: error {e_o} vs f64 > {tol}")
                scaled[path] = max(scaled[path], e_o)

    # Paper Eq. 3 on the card: mec_lowered allocates the compact L beside O,
    # the fused kernel O alone.  Extra = peak allocated above what was live.
    mem = {}
    for name, x, w, s, spec in lowered:
        out_b = math.prod(spec.out_shape) * x.element_size()
        low_b = memory.mec_overhead(spec) * x.element_size()
        extra = {}
        for alg in ("mec_fused", "mec_fused2", "mec_lowered"):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            y = conv2d(x, w, stride=s, padding="VALID", algorithm=alg)
            torch.cuda.synchronize()
            extra[alg] = torch.cuda.max_memory_allocated() - base
            del y
        slack = 2 << 20       # allocator rounding
        for alg in ("mec_fused", "mec_fused2"):
            check(out_b <= extra[alg] <= out_b + slack,
                  f"{name}: {alg} allocated {extra[alg]} B, O is {out_b} B")
        check(low_b + out_b <= extra["mec_lowered"] <= low_b + out_b + slack,
              f"{name}: lowered path allocated {extra['mec_lowered']} B, "
              f"Eq. 3 L + O is {low_b + out_b} B")
        mem[name] = {"out_bytes": out_b, "eq3_bytes": low_b,
                     "fused_extra_bytes": extra["mec_fused"],
                     "fused2_extra_bytes": extra["mec_fused2"],
                     "lowered_extra_bytes": extra["mec_lowered"]}
    emit({"phase": "slice", "batch": SLICE_BATCH, "convs": len(stack),
          "auto_launches": auto_counts, "auto_seconds": round(auto_s, 4),
          "lowered_convs": len(lowered), "lowered_launches": low_counts,
          "lowered_seconds": round(lowered_s, 4),
          "max_scaled_err": scaled, "max_abs_err_vs_plain": abs_err,
          "memory": mem})

    # 4b. plan: the planner ------------------------------------------------
    planned = plan_phase(stack, Path(plan_dir))

    # 4c. bench: the benchmark subsystem, memory auditor and calibration ----
    bench_launches = bench_phase(Path(plan_dir))

    # 4d. analysis: launch check against the launcher, numcheck, lint ------
    analysis_launches = analysis_phase(geoms)

    # 4e. examples: the quickstart and the paper-figure drivers ------------
    examples_launches = examples_phase(fwd_tolerance)

    # 5. train: the training path ------------------------------------------
    # (a) each distinct layer: K4 forward, MEC VJP backward, against f64
    # autograd through F.conv2d, loss sum(out^2).
    grad_err = {}
    for name, x, w, s, spec in lowered:
        xg, wg = x.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
        y = conv2d(xg, wg, stride=s, padding="VALID", algorithm="mec_fused2")
        y.square().sum().backward()
        x64, w64 = x.double().requires_grad_(), w.double().requires_grad_()
        y64 = ref.conv2d_f64(x64, w64, s)
        y64.square().sum().backward()
        tols = {"out": fwd_tolerance("mec_fused2", "float32",
                                     spec.k_h * spec.k_w * spec.i_c),
                "d_input": grad_tolerance("mec_fused2", "float32",
                                          spec.k_h * spec.k_w * spec.k_c),
                "d_kernel": grad_tolerance("mec_fused2", "float32",
                                           spec.i_n * spec.o_h * spec.o_w)}
        errs = {"out": ref.scaled_error(y, y64),
                "d_input": ref.scaled_error(xg.grad, x64.grad),
                "d_kernel": ref.scaled_error(wg.grad, w64.grad)}
        for what, e in errs.items():
            check(math.isfinite(e) and e <= tols[what],
                  f"train {name} {what}: error {e} vs f64 > tol {tols[what]}")
        grad_err[name] = {"err": errs, "tol": tols}
        del xg, wg, y, x64, w64, y64

    # The 34-conv stack forward and backward through K4 and the MEC VJP.
    leaves = {}
    for name, x, _, _, _ in stack:
        leaves.setdefault(name, x.detach().clone().requires_grad_())
    kernels = [w.detach().clone().requires_grad_() for _, _, w, _, _ in stack]
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs2 = [conv2d(leaves[name], wg, stride=s, padding="VALID", algorithm="mec_fused2")
             for (name, _, _, s, _), wg in zip(stack, kernels)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sum(y.square().sum() for y in outs2).backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    train_counts = K.launch_counts()
    check(train_counts["mec_conv_fused2"] >= len(stack)
          and train_counts["mec_conv_fused"] == 0 and train_counts["mec_lower"] == 0
          and train_counts["mec_gemm"] == 0, f"mec_fused2 stack launched {train_counts}")
    abs_err["mec_conv_fused2"] = 0.0
    for (name, x, w, s, spec), y, wg in zip(stack, outs2, kernels):
        check(tuple(y.shape) == spec.out_shape and wg.grad is not None
              and bool(torch.isfinite(wg.grad).all()),
              f"mec_fused2 stack {name}: output or kernel gradient")
        w_blk = pick_fused_w_blk(spec.o_w, spec.k_c, spec.i_n, spec.o_h)
        plain = K.mec_conv_fused2_plain(
            x, w, s, pick_oh_blk(spec.o_h, spec.o_w, w_blk, spec.k_c, spec.i_n))
        tol = fwd_tolerance("mec_fused2", "float32", spec.k_h * spec.k_w * spec.i_c)
        check(ref.scaled_error(y, plain) <= 2 * tol,
              f"mec_fused2 stack {name}: error vs plain > {2 * tol}")
        abs_err["mec_conv_fused2"] = max(abs_err["mec_conv_fused2"],
                                         (y - plain).abs().max().item())
    check(all(bool(torch.isfinite(v.grad).all()) for v in leaves.values()),
          "mec_fused2 stack: non-finite input gradient")
    del outs2, leaves, kernels

    # (b) the CNN trainer at its defaults; its lines go to stderr.
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        acc = train_cnn.main(TRAIN_ARGS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t3
    cnn_counts = K.launch_counts()
    check(acc > 0.8, f"train_cnn through mec_fused2: final accuracy {acc}")
    check(cnn_counts == {"mec_conv_fused": 0, "mec_lower": 0, "mec_gemm": 0,
                         "mec_conv_fused2": 3 * TRAIN_STEPS},
          f"train_cnn launched {cnn_counts}, not 3 x {TRAIN_STEPS} K4")
    emit({"phase": "train", "batch": SLICE_BATCH, "grad_check": grad_err,
          "stack_convs": len(stack), "stack_launches": train_counts,
          "stack_forward_seconds": round(t1 - t0, 4),
          "stack_backward_seconds": round(t2 - t1, 4),
          "train_cnn": {"args": TRAIN_ARGS, "steps": TRAIN_STEPS, "final_acc": acc,
                        "launches": cnn_counts, "seconds": round(train_s, 3),
                        "seconds_per_step": train_s / TRAIN_STEPS}})

    # 6. serve: zamba2-7b at full width and depth ---------------------------
    cfg = ARCHS[SERVE_ARCH].with_(conv_impl="fused")
    n_mamba = cfg.n_layers
    torch.cuda.empty_cache()
    K.reset_launch_counts()
    C.mec_conv1d.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    served = launch_serve.serve(cfg, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                                gen=SERVE_GEN, temperature=0.0, device=DEVICE,
                                seed=args.seed)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_counts = {**K.launch_counts(), "mec_conv1d": C.mec_conv1d.launches}
    serve_peak = torch.cuda.max_memory_allocated()
    check(serve_counts == {"mec_conv_fused": 0, "mec_lower": 0, "mec_gemm": 0,
                           "mec_conv_fused2": 0, "mec_conv1d": n_mamba},
          f"serve launched {serve_counts}, not {n_mamba} K5 and no K1-K4")
    toks = served["tokens"]
    check(tuple(toks.shape) == (SERVE_BATCH, SERVE_GEN)
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab,
          f"served tokens {tuple(toks.shape)}")
    check(bool(torch.isfinite(served["prefill_logits"]).all())
          and bool(torch.isfinite(served["logits"]).all()),
          "served logits are not finite")
    fused_logits = served["prefill_logits"]
    serve_times = {"prefill_seconds": served["prefill_s"],
                   "decode_seconds": served["decode_s"],
                   "decode_tokens_per_s": served["decode_tokens_per_s"]}
    del served
    torch.cuda.empty_cache()

    # The same prompt and weights through the plain lowered conv1d, and
    # decode against prefill, at full width: both gated in f32 and reported
    # in bf16.  In bf16 the paths round in different places (the lowered
    # conv sums in cuBLAS's order; decode keeps the conv's SiLU output in
    # f32 where prefill casts it), and 81 random-weight layers amplify a
    # rounding apart into percents of the logits; in f32 the paths agree
    # unless they compute different functions.  Then, in bf16, K5 against
    # the lowered conv on layer 0's real conv input, and their memory.
    decode, lowered_err = {}, {}
    for dname in ("float32", "bfloat16"):
        dcfg = cfg.with_(dtype=dname)
        model = lm_mod.LM(dcfg)
        with torch.inference_mode(), f32_accumulation():
            params = launch_serve.init_params(dcfg, args.seed, DEVICE)
            prompt = launch_serve.make_prompt(dcfg, SERVE_BATCH, SERVE_PROMPT,
                                              args.seed, DEVICE)
            C.mec_conv1d.launches = 0
            low, cache = serve_lib.prefill(lm_mod.LM(dcfg.with_(conv_impl="lowered")),
                                           params, {"tokens": prompt}, SERVE_PROMPT)
            check(C.mec_conv1d.launches == 0, "the lowered path launched K5")
            del cache
            full, cache = serve_lib.prefill(model, params, {"tokens": prompt},
                                            SERVE_PROMPT)
            del cache
            lowered_err[dname] = scaled_err(full, low)
            del low
            _, cache = serve_lib.prefill(model, params,
                                         {"tokens": prompt[:, :DECODE_FROM]},
                                         SERVE_PROMPT)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(DECODE_FROM, SERVE_PROMPT):
                logits, cache = serve_lib.decode_step(model, params, cache,
                                                      prompt[:, i:i + 1])
            torch.cuda.synchronize()
            decode[dname] = {"err": scaled_err(logits, full),
                             "seconds_per_step": (time.perf_counter() - t0)
                             / (SERVE_PROMPT - DECODE_FROM)}
            del cache, logits
            if dname == "float32":
                check(decode[dname]["err"] <= LOGITS_TOL,
                      f"decode vs prefill at full width, f32: "
                      f"{decode[dname]['err']} > {LOGITS_TOL}")
                check(lowered_err[dname] <= LOGITS_TOL,
                      f"fused vs lowered last-token logits, f32: "
                      f"{lowered_err[dname]} > {LOGITS_TOL}")
                del params, full
                torch.cuda.empty_cache()
                continue
            same_err = scaled_err(full, fused_logits)
            check(same_err <= LOGITS_TOL,
                  f"serve and a prefill of the same prompt and weights: {same_err}")
            p0 = lm_mod.tree_at(params["mamba"], (0, 0))
            h = rms_norm(model.embed(params, prompt), params["mamba_norms"][0],
                         cfg.norm_eps)
            zxbcdt = linear(h, p0["in_proj"])
            conv_x = zxbcdt[..., CONV_LO:CONV_HI]
            conv_w = p0["conv_w"].to(conv_x.dtype)
            y = C.mec_conv1d(conv_x, conv_w)
            vector_bytes = C.vector_bytes(conv_x, conv_w, y)
            check(vector_bytes == 16, f"K5 takes {vector_bytes}-byte vectors on "
                  f"layer 0's conv input, not 16")
            plain = C.mec_conv1d_plain(conv_x, conv_w)
            k5_abs_err = (y.float() - plain.float()).abs().max().item()
            check(scaled_err(y, plain) <= CONV1D_TOL["bfloat16"],
                  f"K5 on layer 0's conv input: {scaled_err(y, plain)} vs plain")
            y_low = mec_conv1d_depthwise(conv_x, conv_w)
            tol = CONV1D_TOL["bfloat16"]
            check(torch.allclose(y.double(), y_low.double(), rtol=tol, atol=tol),
                  "K5 and the lowered conv1d differ on layer 0's conv input")
            layer0 = {"k5_vs_plain_max_abs_err": k5_abs_err,
                      "k5_vs_lowered_max_abs_err":
                          (y.float() - y_low.float()).abs().max().item(),
                      "k5_vs_lowered_elements_differing":
                          int((y != y_low).sum().item()),
                      "elements": y.numel(), "vector_bytes": vector_bytes}
            del y_low
            # Memory: K5 allocates its output; the lowered conv1d L + output.
            out_b = conv_x.numel() * conv_x.element_size()
            low_b = out_b * cfg.conv_width
            extra = {}
            for name, fn in (("fused", lambda: C.mec_conv1d(conv_x, conv_w)),
                             ("lowered",
                              lambda: mec_conv1d_depthwise(conv_x, conv_w))):
                del y
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                y = fn()
                torch.cuda.synchronize()
                extra[name] = torch.cuda.max_memory_allocated() - base
            check(extra["fused"] == out_b,
                  f"K5 allocated {extra['fused']} B, its output is {out_b} B")
            check(low_b + out_b <= extra["lowered"] <= low_b + out_b + (2 << 20),
                  f"lowered conv1d allocated {extra['lowered']} B, L + O is "
                  f"{low_b + out_b} B")
            del y, plain, zxbcdt, h, params, full
    torch.cuda.empty_cache()
    emit({"phase": "serve", "arch": SERVE_ARCH, "dtype": cfg.dtype,
          "layers": {"mamba2": n_mamba, "shared_attention_applications":
                     cfg.n_layers // cfg.attn_every},
          "params": cfg.param_count(), "batch": SERVE_BATCH,
          "prompt": SERVE_PROMPT, "generated": SERVE_GEN,
          "launches": serve_counts, **serve_times,
          "serve_seconds_total": serve_s,
          "peak_allocated_bytes": serve_peak,
          "fused_vs_lowered_logits_err": lowered_err,
          "layer0_conv": layer0,
          "decode_vs_prefill": decode, "serve_vs_prefill_err": same_err,
          "memory": {"conv_out_bytes": out_b, "conv_l_bytes": low_b,
                     "fused_extra_bytes": extra["fused"],
                     "lowered_extra_bytes": extra["lowered"]}})

    # 6b. serve_conv: plan-driven conv serving --------------------------------
    serve_conv = serve_conv_phase(args.seed, fwd_tolerance, peak_tf32, peak_bw)

    # 6c. serve_whisper: whisper-tiny through the warmed frontend ------------
    whisper_launches = serve_whisper_phase(args.seed)

    # 7. timing ------------------------------------------------------------
    def bound(flops, nbytes, peak=None):
        t_ops, t_bytes = flops / (peak or peak_flops), nbytes / peak_bw
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")

    def mma_bound(flops, nbytes, dtype):
        """K1/K3/K4's bound: their arithmetic on the tensor cores, three
        TF32 products a multiply-add for f32, one bf16 product for bf16."""
        if dtype == torch.float32:
            return bound(TF32_PRODUCTS * flops, nbytes, peak_tf32)
        return bound(flops, nbytes, peak_bf16)

    # the tensor-core kernels, by the number fused_config knows them by
    mma_kernels = {"mec_conv_fused": 1, "mec_gemm": 3, "mec_conv_fused2": 4}
    shapes = {n: {} for n in KERNEL_ROWS if n != "mec_conv1d"}
    shapes_bf16 = {n: {} for n in mma_kernels}
    pair = {}
    for name in RESNET101:
        geom = CV_LAYERS[name]
        ih, iw, ic, kh, kw, kc, s = geom
        s_h, s_w = stride_pair(s)
        for batch in TIMING_BATCHES:
            x, k = make_operands(gen, batch, geom, torch.float32)
            spec = spec_of(x, k, (s_h, s_w))
            f_blk = pick_fused_w_blk(spec.o_w, kc, batch, spec.o_h)
            oh_blk = pick_oh_blk(spec.o_h, spec.o_w, f_blk, kc, batch)
            kmat = k.reshape(kh, kw * ic, kc)
            low = K.mec_lower(x, kw, s_w)
            core = K.gemm_core(low.shape, kmat.shape, kh, s_h)
            es = x.element_size()
            n_in, n_k, n_out = x.numel(), k.numel(), math.prod(spec.out_shape)
            n_low = memory.mec_overhead(spec)
            flops = memory.conv_flops(spec)

            def kernel_fns(x, k, low, kmat):
                """(kernel, plain version, library call) of each conv2d
                kernel on these operands (the library: cuDNN's conv for
                K1/K4, f32 with TF32 off; matmul on the ld-aliased windows
                of L for K3; the strided view's copy for K2)."""
                x_nchw = x.permute(0, 3, 1, 2)      # NHWC memory = channels_last
                k_oihw = k.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)

                def library_conv():
                    if x.dtype != torch.float32:
                        return F.conv2d(x_nchw, k_oihw, stride=(s_h, s_w))
                    with ieee_f32_conv():
                        return F.conv2d(x_nchw, k_oihw, stride=(s_h, s_w))

                k_2d = k.reshape(kh * kw * ic, kc)
                return {
                    "mec_conv_fused": (
                        lambda: K.mec_conv_fused(x, k, (s_h, s_w), w_blk=f_blk),
                        lambda: K.mec_conv_fused_plain(x, k, (s_h, s_w)),
                        library_conv),
                    "mec_lower": (
                        lambda: K.mec_lower(x, kw, s_w),
                        lambda: K.mec_lower_plain(x, kw, s_w),
                        lambda: lowered_view(x, kw, s_w).contiguous()),
                    "mec_gemm": (
                        lambda: K.mec_gemm(low, kmat, kh, s_h),
                        lambda: K.mec_gemm_plain(low, kmat, kh, s_h),
                        lambda: torch.matmul(window_view(low, kh, s_h), k_2d)),
                    "mec_conv_fused2": (
                        lambda: K.mec_conv_fused2(x, k, (s_h, s_w), w_blk=f_blk,
                                                  oh_blk=oh_blk),
                        lambda: K.mec_conv_fused2_plain(x, k, (s_h, s_w), oh_blk),
                        library_conv)}

            def config(kname, dtype):
                if kname == "mec_gemm":
                    return K.gemm_config(dtype, low.shape, kmat.shape, kh, s_h)
                return K.fused_config(mma_kernels[kname], dtype, x.shape, k.shape,
                                      (s_h, s_w), f_blk, oh_blk)

            # each function's own bytes: I (K2 reads it, K1/K4 read it with
            # K and write O), L (K2 writes it, K3 reads it with K), O
            nbytes = {"mec_conv_fused": (n_in + n_k + n_out) * es,
                      "mec_lower": (n_in + n_low) * es,
                      "mec_gemm": (n_low + n_k + n_out) * es,
                      "mec_conv_fused2": (n_in + n_k + n_out) * es}
            fns = kernel_fns(x, k, low, kmat)
            lib_ms = {kname: time_ms(lib) for kname, (_, _, lib) in fns.items()
                      if kname != "mec_conv_fused2"}
            lib_ms["mec_conv_fused2"] = lib_ms["mec_conv_fused"]
            # K4's own traffic: I once plus the halo rows that consecutive
            # h-blocks both read, beside K and O.  The bound counts I once.
            halo = max(0, kh - s_h) / (oh_blk * s_h)
            for kname, (fn, plain_fn, _) in fns.items():
                b_ms, b_by = bound(flops if kname != "mec_lower" else 0,
                                   nbytes[kname])
                rec = {"layer": name, "batch": batch,
                       "w_blk": core["oh_blk"] if kname == "mec_gemm" else f_blk,
                       "ms": time_ms(fn), "plain_ms": time_ms(plain_fn),
                       "library_ms": lib_ms[kname], "bound_ms": b_ms, "bound_by": b_by}
                if kname in mma_kernels:
                    # bound_ms is the tensor cores'; the CUDA cores' f32 one
                    # beside it
                    m_ms, m_by = mma_bound(flops, nbytes[kname], torch.float32)
                    rec.update(bound_ms=m_ms, bound_by=m_by, cuda_core_bound_ms=b_ms,
                               config=config(kname, x.dtype))
                    # deterministic: the cluster's partial sums add in rank order
                    check(torch.equal(fn(), fn()),
                          f"{kname} {name} batch {batch}: two runs differ")
                if kname == "mec_gemm":
                    rec["h_blk"] = core["w_blk"]
                if kname == "mec_conv_fused2":
                    rec["oh_blk"] = oh_blk
                    rec["design_bytes"] = (n_in * (1 + halo) + n_k + n_out) * es
                shapes[kname][(name, batch)] = rec
                emit({"phase": "timing", "kernel": kname, **rec})
            if batch == SLICE_BATCH:
                # K1, K3 and K4 in bf16 beside their library calls in bf16
                # (kernel and library only; the plain version is no
                # yardstick), each output first checked against the f64
                # oracle and the plain version: at batch 16 the pickers
                # choose other tiles and splits than the kernels phase saw
                xb, kb = x.to(torch.bfloat16), k.to(torch.bfloat16)
                lowb, kmatb = low.to(torch.bfloat16), kmat.to(torch.bfloat16)
                fns_b = kernel_fns(xb, kb, lowb, kmatb)
                tol_b = fwd_tolerance("mec_fused", "bfloat16", kh * kw * ic)
                oracle_b = ref.conv2d_f64(xb, kb, (s_h, s_w))
                lib_b = {}
                for kname in mma_kernels:
                    fn, plain_fn, lib = fns_b[kname]
                    y = fn()
                    e_o = ref.scaled_error(y, oracle_b)
                    e_p = ref.scaled_error(y, plain_fn())
                    check(y.dtype == torch.bfloat16 and math.isfinite(e_o)
                          and e_o <= tol_b,
                          f"{kname} {name} bf16 batch {batch}: error {e_o} vs "
                          f"f64 > tol {tol_b}")
                    check(e_p <= 2 * tol_b,
                          f"{kname} {name} bf16 batch {batch}: error {e_p} vs "
                          f"plain > {2 * tol_b}")
                    key = (f"K{mma_kernels[kname]}", f"bfloat16@{batch}")
                    worst[key] = max(worst.get(key, 0.0), e_o / tol_b,
                                     e_p / (2 * tol_b))
                    del y
                    if kname == "mec_conv_fused2":
                        lib_b[kname] = lib_b["mec_conv_fused"]
                    else:
                        lib_b[kname] = time_ms(lib)
                    b_ms, b_by = mma_bound(flops, nbytes[kname] // es * 2,
                                           torch.bfloat16)
                    rec = {"layer": name, "batch": batch, "dtype": "bfloat16",
                           "err": [e_o, e_p], "tol": tol_b,
                           "ms": time_ms(fn), "library_ms": lib_b[kname],
                           "bound_ms": b_ms, "bound_by": b_by,
                           "config": config(kname, torch.bfloat16)}
                    shapes_bf16[kname][name] = rec
                    emit({"phase": "timing", "kernel": kname, **rec})
                del xb, kb, lowb, kmatb, fns_b, oracle_b
            pair[(name, batch)] = {
                "layer": name, "batch": batch,
                "ms": time_ms(lambda: mec_conv2d_cuda(x, k, (s_h, s_w),
                                                      mode="lowered")),
                "library_ms": lib_ms["mec_conv_fused"]}
            emit({"phase": "timing", "kernel": "mec_lower+mec_gemm",
                  **pair[(name, batch)]})
            del low, fns
    # the kernels phase's worst errors with the bf16 checks at batch 16 added
    emit({"phase": "timing", "worst_err_over_tol": {
        f"{k}/{d}": round(v, 4) for (k, d), v in sorted(worst.items())}})

    # K5 at the zamba2-7b conv input in bf16, a column slice of the in_proj
    # output as the model passes it, on the L2-cold timer (a prefill's
    # in_proj output, 59.7 MB, is not in the L2 when K5 reads it).
    k5 = conv1d_timing(C, gen, cfg.conv_width, peak_flops, peak_bw)
    emit({"phase": "timing", "kernel": "mec_conv1d", **k5})
    # and its runtime-k_w path at the same shape (no model reaches it)
    k5_any = conv1d_timing(C, gen, ANY_KW_TIMED, peak_flops, peak_bw)
    emit({"phase": "timing", "kernel": "mec_conv1d", "path": "runtime k_w",
          **k5_any})

    # 8. profile ------------------------------------------------------------
    emit({"phase": "profile", **profile_serving(cfg, args.seed)})

    # Main-path totals: each kernel over the calls its path made at batch 16
    # (K1: the 34-conv stack; K2, K3: one call per Table-3 layer; K4: the
    # 34-conv training stack), K5 over the 81 calls of one zamba2-7b
    # prefill.
    weights = {"mec_conv_fused": RESNET101,
               "mec_lower": {n: 1 for n in RESNET101},
               "mec_gemm": {n: 1 for n in RESNET101},
               "mec_conv_fused2": RESNET101}
    launches = {"mec_conv_fused": auto_counts["mec_conv_fused"],
                "mec_lower": low_counts["mec_lower"],
                "mec_gemm": low_counts["mec_gemm"],
                "mec_conv_fused2": train_counts["mec_conv_fused2"]}
    abs_err["mec_lower"] = 0.0       # checked bit-exact above
    rows = []
    for kname, (source, replaces) in KERNEL_ROWS.items():
        if kname == "mec_conv1d":
            calls = serve_counts["mec_conv1d"]
            rows.append({
                "name": kname, "route": "cuda", "source": source,
                "replaces": replaces, "launches": calls,
                "max_abs_err": k5_abs_err, "ms": calls * k5["ms"],
                "plain_ms": calls * k5["plain_ms"],
                "bound_ms": calls * k5["bound_ms"], "bound_by": k5["bound_by"],
                "library_ms": calls * k5["library_ms"],
                "timer": k5["timer"], "vector_bytes": layer0["vector_bytes"],
                "per_call": {f: k5[f] for f in ("ms", "plain_ms", "bound_ms",
                                                "library_ms")},
                "per_call_spread": {f: [k5["cold"][f]["min_ms"], k5["cold"][f]["max_ms"]]
                                    for f in ("kernel", "plain", "library")},
                "copy_ms_per_call": k5["copy_ms"],
                "memcpy_ms_per_call": k5["memcpy_ms"],
                "any_kw": {"k_w": ANY_KW_TIMED,
                           **{f: k5_any[f] for f in ("ms", "plain_ms", "bound_ms",
                                                     "library_ms")}}})
            continue
        recs = [(w, shapes[kname][(n, SLICE_BATCH)]) for n, w in weights[kname].items()]

        def total(field):
            return sum(w * r[field] for w, r in recs)

        ops_ms = sum(w * r["bound_ms"] for w, r in recs if r["bound_by"] == "operations")
        rows.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": abs_err[kname], "ms": total("ms"),
            "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": "operations" if 2 * ops_ms >= total("bound_ms") else "bytes",
            "library_ms": total("library_ms")})
        if kname in shapes_bf16:
            # what bound_ms is read against, the CUDA cores' f32 bound, and
            # the bf16 times beside the library call's in bf16
            bf = [(w, shapes_bf16[kname][n]) for n, w in weights[kname].items()]
            rows[-1].update({
                "bound_rate": f"{TF32_PRODUCTS} TF32 tensor-core products a "
                              f"multiply-add at {peak_tf32 / 1e12:g} TFLOP/s",
                "cuda_core_bound_ms": total("cuda_core_bound_ms"),
                "bf16": {"ms": sum(w * r["ms"] for w, r in bf),
                         "library_ms": sum(w * r["library_ms"] for w, r in bf),
                         "bound_ms": sum(w * r["bound_ms"] for w, r in bf),
                         "bound_by": f"bf16 tensor cores at "
                                     f"{peak_bf16 / 1e12:g} TFLOP/s"}})
    rows[list(KERNEL_ROWS).index("mec_conv_fused2")]["train_cnn_launches"] = \
        cnn_counts["mec_conv_fused2"]
    for row in rows:
        if row["name"] != "mec_conv1d":
            row["planned_stack_launches"] = {
                d: planned[d]["launches"][row["name"]] for d in PLAN_DTYPES}
            row["bench_launches"] = bench_launches[row["name"]]
            row["analysis_launches"] = analysis_launches[row["name"]]
            row["examples_launches"] = examples_launches[row["name"]]
    for row in rows:
        if row["name"] != "mec_conv1d":
            row["serve_launches"] = {
                "whisper_frontend_stream": serve_conv["whisper"][row["name"]],
                "patch_embed_stream": serve_conv["patch"][row["name"]],
                "bench_serve": serve_conv["bench"][row["name"]],
                "whisper_tiny_served": whisper_launches[row["name"]]}
    rows[list(KERNEL_ROWS).index("mec_conv_fused")]["whisper_frontend"] = \
        serve_conv["whisper_k1"]
    rows[list(KERNEL_ROWS).index("mec_gemm")]["lowered_pair"] = {
        "ms": sum(pair[(n, SLICE_BATCH)]["ms"] for n in RESNET101),
        "library_ms": sum(pair[(n, SLICE_BATCH)]["library_ms"] for n in RESNET101)}
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
