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
             promoted operands, cast to the input's dtype.  Then K5's
             gradient (fault F10): the wrapper's autograd node at the
             zamba2-7b and xlstm-125m conv inputs (strided slices) in f32
             and bf16, dx and dk against the plain version's autograd
             within the f32 gradient budget; one launch a forward, none in
             the backward.
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
             ``mec_fused2``: accuracy above 0.8, 3 K4 and 3 K6 launches a
             step.
5b. k6     - K6, the MEC weight gradient: against its plain version and
             the f64 oracle at batch 2 on the Table-3 layers and edge
             geometries, bit-equal on a second launch; at batch 128 in f32
             timed beside its bound, the plain version and
             ``torch.nn.grad.conv2d_weight`` (``k6_phase``).
6. serve   - zamba2-7b at full width and depth, bf16, seeded random
             weights, ``conv_impl="fused"``, through
             ``repro_torch.launch.serve.serve``: batch 4, prompt 512, 32
             greedy tokens, decoding through the captured program (one
             CUDA graph a step) and eagerly (equal tokens); 81 K5
             launches (one per Mamba2 layer) and no K1-K4 in each; finite
             logits; prefill seconds, decode tokens/s and peak memory of
             each.  Four decode steps through the graph against the eager
             step: equal bits on the logits and every cache buffer.  The
             same prompt and weights through
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
             32, 32 greedy tokens, decoding with the graph and eagerly;
             decode against a prefill of the extended sequence (gated in
             f32 at 2e-2, reported in bf16); graph against eager (equal
             bits); one prefill and four decode steps (graph and eager)
             traced for device time and idle share.
6d. serve_dense - qwen3-4b at full size (36 layers): bf16 ``serve()`` at
             batch 8, prompt 128, 32 tokens, graph and eager; graph
             against eager (equal bits); 24 seeded requests (prompts
             32-512, 16-64 new tokens, one stopping on EOS at prefill, one
             at a decode step) through an 8-slot ``ContinuousBatcher`` of
             1024 positions with the graph, eagerly (equal bits), with the
             int8 KV cache (pool under 0.6 x bf16) and with triangle
             attention (equal bits).  The gates in f32 (in bf16, tens of
             random-weight layers amplify the roundings of differently
             shaped GEMMs into percents; those numbers are reported): 4
             decode steps against a prefill and each of 8 requests
             through the batcher against itself served alone, within
             2e-2.  The int8 decode attention within 0.03 at the model's
             widths; the int8 decode gate (0.05) at the JAX package's
             smoke sizes; the f32 smoke batcher's tokens equal to each
             request alone.
6e. serve_vlm - llava-next-34b at published widths and full depth (60
             layers, bf16, 64.1 GiB of weights): ``serve(warm_plans=True,
             shape_classes=[(2, 336, 336)])``, 336 x 336 images through the
             warmed patch embed (K1: warm-up and capture, one replay) to
             2880 vision tokens, prompt 128, 32 tokens, graph and eager;
             graph against eager (equal bits); 4 requests with vision
             extras through a 2-slot batcher (recycling); in f32 at full
             width and 8 layers, decode against prefill and the batcher
             against each request alone within 2e-2;
             ``chunked_attention_tri`` equal to ``chunked_attention`` to
             the bit at the prefill's length and the model's heads.
6f. serve_ssm - xlstm-125m at full size (12 layers: 9 mLSTM and 3 sLSTM
             blocks, d_model 768, d_in 1536, 4 heads of 384, vocab 50304),
             bf16, seeded random weights, ``conv_impl="fused"``: ``serve()``
             at batch 8, prompt 1024, 32 greedy tokens, graph and eager
             (equal tokens), 12 K5 launches (one a block) and no K1-K4 in
             each; K5 12 times a prefill and 0 times a decode step; graph
             against eager (equal bits); a decode step and a prefill
             traced (the sLSTM scan's share); in f32, decode against
             prefill and the lowered conv against the fused one within
             2e-2 (bf16 reported); long_500k's batch from
             ``configs.shapes.make_batch``: its state bytes equal at 64 and
             524,352 positions, 8 captured decode steps from position
             524,287.
6g. serve_moe - qwen3-moe-30b-a3b at full size (48 layers, 128 experts
             of d_ff 768, top-8, 30.5 B parameters, bf16, seeded random
             weights drawn layer by layer on the card): ``serve()`` at batch
             8, prompt 128, 32 tokens, graph and eager (equal tokens, last
             logits and drop counts; the prefill's and each step's dropped
             assignments printed); graph against eager over 4 steps on the
             float cache and on the cache quantized to int8 (equal bits;
             int8 against float reported); in f32 at 8 of 48 layers, 4
             decode steps from prefills of 1 x 1 up to 2 x 2048 tokens,
             each against a prefill of the same tokens within 2e-2 where
             neither path dropped an assignment.  kimi-k2-1t-a32b at full width (384
             experts of d_ff 2048 at d_model 7168, one shared expert) and
             the depth that fits the card, printed: ``serve()`` at batch 2,
             prompt 32, 8 tokens, graph against eager.
6h. train_lm - LM training: one ``training.steps.make_train_step`` step
             (bf16, remat, AdamW in place) per family at full width and the
             largest depth whose 12 bytes a parameter fit beside 14 GB and
             a layer's f32 attention probabilities, printed: xlstm-125m, whisper-tiny, qwen3-4b at full size,
             zamba2-7b, qwen3-moe-30b-a3b and llava-next-34b cut; batch 2 x
             512 tokens; step seconds and peak bytes; xlstm-125m and
             zamba2-7b with ``conv_impl="fused"``, K5 counted in the step
             (its forward and its remat recompute).  Their gradients in f32
             at full width (2 and 4 layers) through K5 against the lowered
             conv, each leaf within 1e-4.  The chunked loss at 8 x 2048
             tokens and vocab 151,936: peak within one chunk's f32 logits
             plus the head's f32 copy and gradient, beside one chunk.
             ``launch.train`` on xlstm-125m at full size for 20 steps with a
             checkpoint at 10, then a new process from that checkpoint:
             steps 10-19's losses equal to the bit, the loss falling
             (deterministic algorithms, cuBLAS workspace pinned).  The
             optimizer learns: xlstm-125m's loss on one repeated batch
             falls by 10 times the spread between batches in 6 steps.
             One zamba2-7b step traced: K5's device time in it.
6i. dist  - distributed execution on ranks that share the card: gloo
             processes on cuda:0 (NCCL refuses two ranks on one device;
             ``nccl`` over more ranks than cards must raise, and NCCL at
             world size 1 runs an all-reduce and ``sharded_conv2d`` over a
             1-way mesh to the single-device bits).  Four ranks: Table 2
             at batch 1 under ``spatial`` over 2 and 4 ranks where viable
             and ``channel`` over 2 and 4, and at batch 8 under the three
             composites over 2 x 2, through ``mec_fused`` (K1) and
             ``mec_lowered`` (K2+K3) in f32, and ``mec_fused2`` (K4) on
             the 2-rank splits, each through ``analysis.shardcheck.
             check_sharding``: forward and both gradients of its
             ``sum(out^2)`` probe against the single-device conv on the
             card within the f32 budgets; the bytes by kind the busiest
             rank hands ``torch.distributed`` (``launch.hlo_analysis.
             collective_bytes``) equal to the contract exactly (the halo
             and the cotangent sums of ``conv_partition_costs``, the
             output's and split gradients' all-gathers); the precision
             flow under a declared ``HIGHEST`` in f32 and bf16; each rank's
             body's requested bytes (memaudit's measurement) within the
             Eq. 3 rule on its local geometry, the halo concat's copy
             beside; the ResNet-101 stack at batch 16 under
             ``partition="auto"`` on 2 x 2 in f32 and bf16 (picks, plans,
             errors); the bench ``dist`` suite (65 records' exact fields
             against ``benchmarks/baselines/dist.json``, the smoke cells
             timed, their shardcheck fields passing); GPipe over 4
             stages.  Eight ranks: ``--suite shardcheck`` over the dist
             baseline, its verdicts equal to the committed
             ``BENCH_shardcheck.json`` cell by cell.  Two ranks: a data-parallel
             gradient of xlstm-125m (full width, 4 layers, f32, K5)
             within 1e-5 of the whole batch's, the compressed step's loss
             falling on one repeated batch.  Then ``torch.distributed.run
             --nproc-per-node 2 -m repro_torch.launch.train --arch
             xlstm-125m --mesh host --backend gloo`` at full size, 10
             steps of 8 x 128 at lr 5e-4, plain and ``--compress-grads``:
             finite losses, K5 24 times a step on each rank, the last
             losses within 0.35.  The phase's seconds, the ranks' spawn
             and start, and the host-staged bytes a step.  No scaling is
             read from any of it.
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
             copies of the same bytes and its bound, again at k_w = 16
             (its runtime-k_w path), and at xlstm-125m's mLSTM conv input
             (8, 1024, 1536, k_w = 4; a strided view of the up
             projection) and at its training caller's input (zamba2-7b's
             conv input at the train step's 2 x 512).  K2 against its library call
             (``as_strided().contiguous()``) over the five Table-3 layers
             at batch 16 in 5 alternating L2-cold rounds: medians and
             spreads.
8. profile - one zamba2-7b prefill and four decode steps (eager and
             captured) traced with ``torch.profiler``: device time by
             kernel, launches, and the device's busy share of the
             host-clock window.
roofline   - beside each one-card step timed above (qwen3-4b's captured
             decode step and prefill, xlstm-125m's and zamba2-7b's decode
             steps, each family's train step): ``launch.costmodel.
             cell_cost`` at ``MeshShape(1, 1, 1)``, the bound max(compute,
             memory) at ``launch.hlo_analysis``'s constants, and the
             measured seconds over it.
dryrun     - in a background process from the start, without the card:
             ``launch.dryrun`` on a fake process group of 256 ranks,
             whisper-tiny ``train_4k`` (ZeRO-1) and the three conv cells;
             the parameter and moment bytes a device exact, the conv
             contracts held.  Counts on fake tensors, not measurements.

The last lines are the nvidia-smi line, the ``{"kernels": [...]}`` line
and ``{"ok": true, "device": {...}}``.  Imports torch and the port only.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
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
ZAMBA2_CONV = (SERVE_BATCH, SERVE_PROMPT, IN_PROJ, CONV_LO, CONV_HI)
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
# every ported family's decode step (phases 6-6e): this many steps from one
# cache through the captured program and eagerly, equal bits
GRAPH_STEPS = 4
# the dense family served (phase 6d): qwen3-4b at full size through serve()
# (batch, prompt, generated tokens), then seeded requests (prompt and new
# token ranges) through an 8-slot batcher of 1024 positions, plain, eager,
# with the int8 KV cache and with triangle attention; the JAX package's
# int8 gates (tests/test_kv_quant.py) and its bytes bound
DENSE_ARCH = "qwen3-4b"
DENSE_BATCH, DENSE_PROMPT, DENSE_GEN = 8, 128, 32
# 16 requests and 4 checked alone since PR 24 (24 and 8 before), for the
# time limit the tp phase shares
DENSE_SLOTS, DENSE_MAX_LEN, DENSE_REQUESTS = 8, 1024, 16
DENSE_REQ_PROMPT, DENSE_REQ_NEW = (32, 512), (16, 64)
INT8_ATTN_GATE, INT8_DECODE_GATE, INT8_BYTES_RATIO = 0.03, 0.05, 0.6
# the JAX package's decode gate is set for its smoke configs (4 layers of
# width 64); at qwen3-4b's full size (f32) the error is swept over depth
# and gated under INT8_FULL_GATE, which a control with each layer reading
# its neighbour's scales must exceed
INT8_DEPTHS = (1, 4, 12, 36)
INT8_FULL_GATE = 0.1
# the first requests that are also served alone (bf16 reported, f32 gated)
DENSE_CHECKED = 4
# the f32 smoke batcher on the card: tokens equal to each request alone
SMOKE_BATCHER_ARCH = "yi-6b"
# the vlm family served (phase 6e): llava-next-34b at full width and depth,
# images of one class through the warmed patch embed; then requests with
# vision extras through a 2-slot batcher (recycling forced)
VLM_ARCH = "llava-next-34b"
VLM_BATCH, VLM_IMAGE, VLM_PROMPT, VLM_GEN = 2, 336, 128, 32
VLM_SLOTS, VLM_REQUESTS = 2, 4
VLM_REQ_PROMPT, VLM_REQ_NEW = (32, 128), (8, 16)
# the f32 gates at llava's full width: its depth cut to fit the card
VLM_F32_LAYERS = 8
# the ssm family served (phase 6f): xlstm-125m at full size (bf16, the fused
# conv, K5 in every block's prefill) through serve() at batch, prompt and
# generated tokens; its long_500k batch decoded this many captured steps;
# K5 timed at its mLSTM conv input, x_in, the first d_in columns of each
# 2 d_in-wide row of the up projection (n, t, row width, first, last + 1)
SSM_ARCH = "xlstm-125m"
SSM_BATCH, SSM_PROMPT, SSM_GEN = 8, 1024, 32
SSM_LONG_STEPS = 8
SSM_CONV = (SSM_BATCH, SSM_PROMPT, 3072, 0, 1536)
# the moe family served (phase 6g): qwen3-moe-30b-a3b at full size through
# serve() (batch, prompt, generated tokens), the float and the int8 cache;
# its f32 gates at MOE_F32_LAYERS of 48 layers: GRAPH_STEPS decode steps
# from a prefill of each (batch, prompt, capacity) of MOE_GATE_CASES, each
# step against a prefill of the same tokens, gated where neither path
# dropped an assignment.  Batches of at most 4 rows never drop in decode (a
# step's top-8 assignments never fill an expert's minimum capacity of 4),
# nor does a prefill of at most 4 tokens, so the (1, 1) case gates its
# first three steps whatever the router; the longer prompts drop on random
# weights (their router sends most tokens to a few experts) and are gated
# where they do not; "no_drop" sets the capacity factor to n_experts /
# top_k, where every bucket holds every token, so nothing can drop.  kimi-k2-1t-a32b at full width
# and the depth whose bf16 weights fit beside its head's f32 copy and
# KIMI_HEADROOM bytes, through serve() (batch, prompt, tokens)
MOE_ARCH, MOE_BIG_ARCH = "qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"
MOE_BATCH, MOE_PROMPT, MOE_GEN = 8, 128, 32
MOE_F32_LAYERS = 8
MOE_GATE_CASES = ((1, 1, None), (1, 16, None), (2, 256, None),
                  (2, 2048, None), (2, 256, "no_drop"))
KIMI_BATCH, KIMI_PROMPT, KIMI_GEN = 2, 32, 8
KIMI_HEADROOM = 1.5e9
# LM training on one card (phase 6h): one step per family at full width and
# the largest depth whose parameters, gradients and AdamW moments (12 bytes
# a parameter) fit beside TRAIN_HEADROOM bytes, batch x sequence
# TRAIN_BATCH x TRAIN_SEQ; zamba2-7b and xlstm-125m with the fused conv
# (K5), their gradients at full width against the lowered conv in f32 at
# TRAIN_GRAD_LAYERS; the chunked loss's peak at LOSS_TOKENS tokens of
# qwen3-4b's head (vocab 151,936) against the same loss in one chunk;
# launch.train on xlstm-125m for RESUME_STEPS steps, checkpointed at
# RESUME_AT, then resumed from that checkpoint in a new process
TRAIN_ARCHS = ("xlstm-125m", "whisper-tiny", "qwen3-4b", "zamba2-7b",
               "qwen3-moe-30b-a3b", "llava-next-34b")
TRAIN_FUSED = ("xlstm-125m", "zamba2-7b")
# its step traced with torch.profiler (a third step), for K5's device time
# in a train step: the kernels of csrc/mec_conv1d.cu by name
TRAIN_TRACED = "zamba2-7b"
K5_KERNELS = ("conv1d_kernel", "conv1d_any_kw_kernel")
TRAIN_BATCH, TRAIN_SEQ = 2, 512
# beside the state: activations, a stacked leaf's gradient stacked from
# its layers' (6.4 GiB for zamba2-7b's in_proj at 71 layers) and the
# allocator's fragmentation; a step's peak above 12 bytes a parameter read
# 6.4 GB for zamba2-7b at 62 layers, 3.8-3.9 GB for qwen3-4b and
# qwen3-moe-30b-a3b (the plain attention's state apart) on an H100 80GB
TRAIN_HEADROOM = 14e9
TRAIN_BYTES_PER_PARAM = 12
TRAIN_GRAD_LAYERS = {"zamba2-7b": 2, "xlstm-125m": 4}
TRAIN_GRAD_TOL = 1e-4
LOSS_ARCH, LOSS_TOKENS, LOSS_CHUNK = "qwen3-4b", (8, 2048), 512
# its rate: below 7e-4, at which both packages' xlstm-125m reach NaN
# within 12 steps (F11); over 20 steps its loss still moves about as much
# as the batches differ
RESUME_STEPS, RESUME_AT, RESUME_LR = 20, 10, 5e-4
# whether the optimizer learns, which the resume's 20 steps cannot show
# (its loss moves about as much as the batches differ): xlstm-125m at
# RESUME_LR on one repeated batch of launch.train's shape, its fall over
# OVERFIT_STEPS steps against OVERFIT_SPREADS x the spread of the initial
# parameters' loss over OVERFIT_BATCHES batches
OVERFIT_STEPS, OVERFIT_BATCHES, OVERFIT_SPREADS = 6, 8, 10
OVERFIT_SHAPE = (8, 128)
# K2 against its library call (timing phase): alternate rounds, L2 cold
K2_ROUNDS = 5
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


def roofline_reading(label: str, cfg, kind: str, batch: int, seq: int,
                     measured_s: float, clock: str) -> dict:
    """A one-card step beside its roofline: ``launch.costmodel.cell_cost``
    at ``MeshShape(1, 1, 1)``, the bound max(t_compute, t_memory) at the
    card's data-sheet constants (``launch.hlo_analysis``), and the step's
    measured seconds over it.  Emitted and returned."""
    from repro_torch.launch.costmodel import MeshShape, cell_cost
    from repro_torch.launch.hlo_analysis import HBM_BW, PEAK_FLOPS
    c = cell_cost(cfg, kind, batch, seq, MeshShape(1, 1, 1))
    t_c, t_m = c["flops"] / PEAK_FLOPS, c["hbm_bytes_chip"] / HBM_BW
    bound = max(t_c, t_m)
    rec = {"phase": "roofline", "step": label, "arch": cfg.name,
           "layers": cfg.n_layers, "kind": kind, "batch": batch, "seq": seq,
           "flops": c["flops"], "hbm_bytes": c["hbm_bytes_chip"],
           "t_compute_s": t_c, "t_memory_s": t_m, "bound_s": bound,
           "bound_by": "operations" if t_c >= t_m else "bytes",
           "measured_s": measured_s, "clock": clock,
           "measured_over_bound": measured_s / bound,
           "share_of_bound": bound / measured_s}
    emit(rec)
    return rec


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
                  check_plain: bool = True, shape=None) -> dict:
    """K5, its plain version and cuDNN's depthwise conv1d (one library call
    on a contiguous (n, c, t) copy, the copy not timed) at a model's conv
    input in bf16, a column slice of its projection's output as the model
    passes it, each on the L2-cold timer; K5's output must equal the plain
    version's to the bit and cuDNN's must agree with it first.  ``shape``
    is (n, t, row width, first column, last column + 1) of that slice,
    by default the zamba2-7b conv input (ZAMBA2_CONV).  Beside them, two
    copies of the same bytes with no arithmetic: the slice's copy into a
    contiguous tensor (``copy_ms``, PyTorch's strided copy kernel) and a
    clone of a contiguous tensor of the conv's size (``memcpy_ms``, a
    device-to-device memcpy), what streaming them takes on this card in
    practice.  ``C`` is the module ``repro_torch.kernels.mec_conv1d``;
    ``check_plain=False`` skips K5's check, for a probe's variant that is
    wrong by design."""
    n, t, row, lo, hi = shape or ZAMBA2_CONV
    c = hi - lo
    es = torch.tensor([], dtype=torch.bfloat16).element_size()
    flops, nbytes = 2 * kw * n * t * c, (2 * n * t * c + kw * c) * es
    k = torch.randn((kw, c), generator=gen, device=DEVICE, dtype=torch.bfloat16)
    xs = [torch.randn((n, t, row), generator=gen, device=DEVICE,
                      dtype=torch.bfloat16)[..., lo:hi]
          for _ in range(ring_slots(nbytes))]
    check(not check_plain or torch.equal(C.mec_conv1d(xs[0], k),
                                         C.mec_conv1d_plain(xs[0], k)),
          f"K5 at {[n, t, c, kw]} differs from its plain version")
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
    return {"shape": [n, t, c, kw], "dtype": "bfloat16", "input_row_stride": row,
            "ms": timed["kernel"]["ms"], "plain_ms": timed["plain"]["ms"],
            "library_ms": timed["library"]["ms"], "copy_ms": timed["copy"]["ms"],
            "memcpy_ms": timed["memcpy"]["ms"],
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "timer": "L2-cold", "cold": timed}


def k5_gradient_case(C, ref, gen, grad_tolerance, cases=None) -> list:
    """K5's gradient (fault F10): the wrapper's autograd node at zamba2-7b's
    and xlstm-125m's conv inputs (strided column slices of their
    projections; ``cases`` maps a name to (n, t, row width, first column,
    last column + 1)), dx and dk against the plain version's autograd in
    f32 and bf16, within the f32 gradient budget; one launch a forward,
    none in the backward."""
    out = []
    cases = cases or {"zamba2-7b": ZAMBA2_CONV, "xlstm-125m": SSM_CONV}
    for name, (n, t, width, lo, hi) in cases.items():
        for dname in ("float32", "bfloat16"):
            dtype = DTYPES[dname]
            row = torch.randn((n, t, width), generator=gen, device=DEVICE).to(dtype)
            k = torch.randn((4, hi - lo), generator=gen, device=DEVICE).to(dtype)
            g = torch.randn((n, t, hi - lo), generator=gen, device=DEVICE).to(dtype)
            got = {}
            for path, fn in (("kernel", C.mec_conv1d), ("plain", C.mec_conv1d_plain)):
                xr = row.clone().requires_grad_(True)
                kr = k.clone().requires_grad_(True)
                C.mec_conv1d.launches = 0
                y = fn(xr[..., lo:hi], kr)
                fwd_launches = C.mec_conv1d.launches
                check(y.grad_fn is not None, f"K5 {name} {dname} {path}: no grad_fn")
                y.backward(g)
                torch.cuda.synchronize()
                got[path] = (xr.grad[..., lo:hi], kr.grad, fwd_launches,
                             C.mec_conv1d.launches)
            check(got["kernel"][2:] == (1, 1) and got["plain"][2:] == (0, 0),
                  f"K5 {name} {dname}: launches {got['kernel'][2:]} (kernel) "
                  f"and {got['plain'][2:]} (plain) around forward, backward")
            tols = {"dx": grad_tolerance("mec_fused", "float32", 4),
                    "dk": grad_tolerance("mec_fused", "float32", n * t)}
            errs = {"dx": ref.scaled_error(got["kernel"][0], got["plain"][0]),
                    "dk": ref.scaled_error(got["kernel"][1], got["plain"][1])}
            for what in errs:
                check(errs[what] <= tols[what], f"K5 {name} {dname} {what}: "
                      f"{errs[what]} > {tols[what]} against the plain autograd")
            out.append({"model": name, "dtype": dname, "shape": [n, t, hi - lo],
                        "err": errs, "tol": tols,
                        "bits_equal": {w: bool(torch.equal(got["kernel"][i],
                                                           got["plain"][i]))
                                       for i, w in enumerate(("dx", "dk"))}})
            del row, k, g, got
    torch.cuda.empty_cache()
    return out


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


def dev_us(e) -> float:
    """A torch.profiler event's own device microseconds."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_kernels(prof) -> list:
    """The device kernels of a torch.profiler trace, by name."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0]


def device_breakdown(prof, wall_s: float, top: int = 15) -> dict:
    """Device time by kernel from a torch.profiler trace, and the device's
    busy share of the ``wall_s`` host-clock window."""
    kernels = device_kernels(prof)
    busy_us = sum(dev_us(e) for e in kernels)
    kernels.sort(key=dev_us, reverse=True)
    return {"wall_s": wall_s, "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
            "kernel_launches": sum(e.count for e in kernels),
            "top": [{"name": e.key[:120], "count": e.count,
                     "device_ms": dev_us(e) / 1e3} for e in kernels[:top]]}


def profile_serving(cfg, seed: int, decode_steps: int = 4) -> dict:
    """Trace one zamba2-7b prefill (after a warm-up prefill) and
    ``decode_steps`` decode steps, eagerly and through the captured
    program (:func:`profile_decode`)."""
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
        out["decode"] = profile_decode(model, params, cache, prompt[:, -1:],
                                       decode_steps)
    return out


#: K6's timing batch: the training cell's (``mecbench``, train.f32.b128)
K6_BATCH = 128
#: K6's edge geometries (ih, iw, ic, kh, kw, kc, stride) beside the Table-3
#: layers: i_c = 3 at cv1's k_w = 11 (k_w*i_c = 33), s_h > k_h, stride
#: (2, 3), k_c off the 64-channel tile with i_c off the 32-channel chunk,
#: and a kernel wider than one CTA's warps
K6_EDGES = [(227, 227, 3, 11, 11, 96, 4), (8, 8, 3, 2, 2, 5, 3),
            (11, 13, 2, 4, 5, 3, (2, 3)), (20, 45, 37, 3, 3, 130, 1),
            (20, 20, 32, 3, 17, 8, 1)]


def k6_phase(seed: int, grad_tolerance, peak_tf32: float, peak_bw: float) -> dict:
    """K6, the MEC weight gradient (phase 5b): at batch 2 on the Table-3
    layers and ``K6_EDGES``, one launch, within twice the f32 gradient
    budget of its plain version and of the f64 oracle, and equal bits on
    a second launch; then at batch ``K6_BATCH`` in f32 on the Table-3
    layers, the same checks against the plain version and its time beside
    its bound (three TF32 products on the tensor cores, I and G read once,
    dW written once), the plain version's time and, as ``library_ms``,
    ``torch.nn.grad.conv2d_weight`` in IEEE f32 (timed only: the port never
    calls it)."""
    from repro_torch.bench.scenarios import CV_LAYERS
    from repro_torch.bench.scenarios import RESNET101_WEIGHTS as RESNET101
    from repro_torch.core.direct import ieee_f32_conv
    from repro_torch.kernels import mec_conv as K
    from repro_torch.kernels import ref

    gen = torch.Generator(DEVICE).manual_seed(seed)

    def operands(geom, batch):
        ih, iw, ic, kh, kw, kc, s = geom
        s_h, s_w = stride_pair(s)
        x = torch.randn((batch, ih, iw, ic), generator=gen, device=DEVICE)
        g = torch.randn((batch, (ih - kh) // s_h + 1, (iw - kw) // s_w + 1, kc),
                        generator=gen, device=DEVICE)
        return x, g, kh, kw, (s_h, s_w)

    def oracle(x, g, kh, kw, s):
        k = torch.zeros((kh, kw, x.shape[3], g.shape[3]), dtype=torch.float64,
                        device=DEVICE, requires_grad=True)
        ref.conv2d_ref(x.double(), k, s).backward(g.double())
        return k.grad

    out = {"checks": {}, "timing": {}}
    cases = [(n, CV_LAYERS[n]) for n in RESNET101] + [
        (f"edge{i}", geom) for i, geom in enumerate(K6_EDGES)]
    for name, geom in cases:
        x, g, kh, kw, s = operands(geom, 2)
        before = K.mec_weight_grad.launches
        dw = K.mec_weight_grad(x, g, kh, kw, s)
        torch.cuda.synchronize()
        check(K.mec_weight_grad.launches == before + 1,
              f"K6 {name}: {K.mec_weight_grad.launches - before} launches")
        n, oh, ow, _ = g.shape
        tol = 2 * grad_tolerance("mec_fused2", "float32", n * oh * ow)
        err = {"f64": ref.scaled_error(dw, oracle(x, g, kh, kw, s)),
               "plain": ref.scaled_error(dw, K.mec_weight_grad_plain(x, g, kh, kw, s))}
        check(all(math.isfinite(e) and e <= tol for e in err.values()),
              f"K6 {name} batch 2: errors {err} > {tol}")
        check(torch.equal(dw, K.mec_weight_grad(x, g, kh, kw, s)),
              f"K6 {name}: two launches differ")
        out["checks"][name] = {"err": err, "tol": tol,
                               "config": K.wgrad_config(x.shape, g.shape, kh, kw, s)}
    for name in RESNET101:
        x, g, kh, kw, s = operands(CV_LAYERS[name], K6_BATCH)
        n, oh, ow, kc = g.shape
        ic = x.shape[3]
        fn = lambda: K.mec_weight_grad(x, g, kh, kw, s)
        plain = lambda: K.mec_weight_grad_plain(x, g, kh, kw, s)
        dw = fn()
        tol = 2 * grad_tolerance("mec_fused2", "float32", n * oh * ow)
        e = ref.scaled_error(dw, plain())
        check(math.isfinite(e) and e <= tol, f"K6 {name} batch {K6_BATCH}: {e} > {tol}")
        check(torch.equal(dw, fn()), f"K6 {name} batch {K6_BATCH}: two launches differ")
        x_nchw, g_nchw = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        with ieee_f32_conv():
            lib_ms = time_ms(lambda: torch.nn.grad.conv2d_weight(
                x_nchw, (kc, ic, kh, kw), g_nchw, stride=s))
        flops = 2 * kh * kw * ic * kc * n * oh * ow
        nbytes = 4 * (x.numel() + g.numel() + dw.numel())
        t_ops = TF32_PRODUCTS * flops / peak_tf32
        t_bytes = nbytes / peak_bw
        rec = {"layer": name, "batch": K6_BATCH, "ms": time_ms(fn),
               "plain_ms": time_ms(plain), "library_ms": lib_ms,
               "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "tf32_1x_bound_ms": flops / peak_tf32 * 1e3, "err_vs_plain": e,
               "config": K.wgrad_config(x.shape, g.shape, kh, kw, s)}
        out["timing"][name] = rec
        emit({"phase": "k6", **rec})
        del x, g, dw
        torch.cuda.empty_cache()
    emit({"phase": "k6", "checks": out["checks"]})
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
                           "mec_gemm": 0, "mec_conv_fused2": 0,
                           "mec_weight_grad": 3 * TRAIN_STEPS},
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
    # the suites time forwards: K6 runs in a backward only
    check(all(n > 0 for k, n in launches.items() if k != "mec_weight_grad"),
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
    # the examples run forwards: K6 runs in a backward only
    check(all(n > 0 for k, n in launches.items() if k != "mec_weight_grad"),
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
                               "mec_lower": 0, "mec_gemm": 0, "mec_conv_fused2": 0,
                               "mec_weight_grad": 0},
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
                             "mec_lower": 0, "mec_gemm": 0, "mec_conv_fused2": 0,
                             "mec_weight_grad": 0},
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
    served = serve_both(cfg, seed, batch=WHISPER_BATCH,
                        prompt_len=WHISPER_PROMPT, gen=WHISPER_GEN,
                        warm_plans=True)
    for mode in ("graph", "eager"):
        launches = {k: v for k, v in served[mode]["launches"].items()
                    if k != "mec_conv1d"}
        check(launches == {"mec_conv_fused": 4, "mec_lower": 0, "mec_gemm": 0,
                           "mec_conv_fused2": 0, "mec_weight_grad": 0},
              f"whisper-tiny served ({mode}) with {launches}: K1 once eagerly "
              "and once captured per frontend layer")
        check(served[mode]["warmup"] == [(0, 0, ["mec_fused"])] * 2,
              f"whisper-tiny warm-up ({mode}): {served[mode]['warmup']}")
    res = served["graph"]
    launches = {k: v for k, v in res["launches"].items() if k != "mec_conv1d"}

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
            _, cache = serve_lib.prefill(
                model, params, {"tokens": prompt[:, :WHISPER_DECODE_FROM],
                                "frames": frames},
                WHISPER_DECODE_FROM + 2 + 2 * GRAPH_STEPS)
            graph_check, _, _ = graph_vs_eager(
                model, params, lm_mod.tree_map(torch.clone, cache),
                prompt[:, WHISPER_DECODE_FROM:WHISPER_DECODE_FROM + GRAPH_STEPS])
            decode_prof = profile_decode(model, params, cache,
                                         prompt[:, :1], GRAPH_STEPS)
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
          "prefill_seconds": res["prefill_seconds"],
          "decode_seconds": res["decode_seconds"],
          "decode_tokens_per_s": res["decode_tokens_per_s"],
          "graph": public(served["graph"]), "eager": public(served["eager"]),
          "decode_vs_prefill": decode, "serve_vs_prefill_err": served_err,
          "graph_vs_eager": graph_check, "decode_profile": decode_prof,
          "prefill_profile": prof_out,
          "phase_seconds": round(time.perf_counter() - t_phase, 3)})
    return launches


def k2_against_library(K, gen, layers) -> dict:
    """K2 (``mec_lower``) and its library call (the strided view of I as L,
    copied by ``contiguous()``) on each of ``layers`` (the Table-3 layers)
    at batch 16 in f32, on the L2-cold timer, in K2_ROUNDS alternating
    rounds (K2 first in even rounds, the library first in odd ones); each
    round's total over the layers.  Medians, minima and maxima, and whether
    K2 is slower beyond the spread (its fastest round slower than the
    library's slowest)."""
    from repro_torch.bench.scenarios import CV_LAYERS
    rings = []
    for name in layers:
        geom = CV_LAYERS[name]
        k_w, s_w = geom[4], stride_pair(geom[6])[1]
        x, _ = make_operands(gen, SLICE_BATCH, geom, torch.float32)
        low = K.mec_lower(x, k_w, s_w)
        check(torch.equal(low, lowered_view(x, k_w, s_w).contiguous()),
              f"K2 on {name} differs from its library call")
        nbytes = (x.numel() + low.numel()) * x.element_size()
        xs = [x] + [make_operands(gen, SLICE_BATCH, geom, torch.float32)[0]
                    for _ in range(ring_slots(nbytes) - 1)]
        rings.append((name, xs, k_w, s_w))
        del low
    fns = {"kernel": lambda x, k_w, s_w: K.mec_lower(x, k_w, s_w),
           "library": lambda x, k_w, s_w: lowered_view(x, k_w, s_w).contiguous()}
    per = {"kernel": [], "library": []}
    for r in range(K2_ROUNDS):
        for which in (("kernel", "library") if r % 2 == 0
                      else ("library", "kernel")):
            per[which].append(sum(
                cold_ms(fns[which], [(x, k_w, s_w) for x in xs])["ms"]
                for _, xs, k_w, s_w in rings))
    del rings
    torch.cuda.empty_cache()
    out = {"rounds": K2_ROUNDS, "layers": list(layers), "batch": SLICE_BATCH,
           "timer": "L2-cold"}
    for which, vals in per.items():
        out[which] = {"median_ms": statistics.median(vals), "min_ms": min(vals),
                      "max_ms": max(vals), "rounds_ms": vals}
    out["kernel_slower_beyond_spread"] = (out["kernel"]["min_ms"]
                                          > out["library"]["max_ms"])
    return out


def tree_leaves(tree, prefix=""):
    """{path: tensor} of a cache or parameter tree (None leaves left out)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(tree_leaves(v, f"{prefix}/{k}"))
        return out
    return {} if tree is None else {prefix: tree}


def peak_run(fn):
    """(fn(), the allocator's peak bytes during it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated()


def free_card() -> None:
    """Collect garbage (a CUDA graph's pool lives as long as its program)
    and return the allocator's free blocks, before a large model."""
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def eager_decode():
    """Inside, the decode programs that ``launch.serve.serve`` and
    ``ContinuousBatcher`` build run eagerly on the card too: the
    comparison for the captured step."""
    import functools
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serving import scheduler, step_graph
    saved = launch_serve.DecodeProgram, scheduler.DecodeProgram
    eager = functools.partial(step_graph.DecodeProgram, graph=False)
    launch_serve.DecodeProgram = scheduler.DecodeProgram = eager
    try:
        yield
    finally:
        launch_serve.DecodeProgram, scheduler.DecodeProgram = saved


def serve_both(cfg, seed: int, **kw) -> dict:
    """``launch.serve.serve`` with the captured decode program and eagerly
    (:func:`eager_decode`), the kernels' counts reset before each run: per
    mode the prefill seconds, decode tokens/s with the program's build
    inside (as ``serve`` reports it) and after it, the build seconds, the
    peak bytes and the counts.  Both runs draw the same weights and
    prompts, so their greedy tokens must be equal."""
    from repro_torch.kernels import mec_conv as K, mec_conv1d as C
    from repro_torch.launch import serve as launch_serve
    out = {}
    for mode in ("graph", "eager"):
        free_card()
        K.reset_launch_counts()
        C.mec_conv1d.launches = 0
        with (eager_decode() if mode == "eager"
              else contextlib.nullcontext()):
            res, peak = peak_run(lambda: launch_serve.serve(
                cfg, device=DEVICE, seed=seed, **kw))
        check(res["decode_graph"] == (mode == "graph"),
              f"{cfg.name} {mode}: decode_graph {res['decode_graph']}")
        toks = res["tokens"]
        check(tuple(toks.shape) == (kw["batch"], kw["gen"])
              and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab,
              f"{cfg.name} {mode}: tokens {tuple(toks.shape)}")
        check(bool(torch.isfinite(res["prefill_logits"]).all())
              and bool(torch.isfinite(res["logits"]).all()),
              f"{cfg.name} {mode}: logits are not finite")
        out[mode] = {"prefill_seconds": res["prefill_s"],
                     "decode_seconds": res["decode_s"],
                     "decode_tokens_per_s": res["decode_tokens_per_s"],
                     "capture_seconds": res["capture_s"],
                     "decode_tokens_per_s_after_build": (
                         kw["batch"] * (kw["gen"] - 1)
                         / (res["decode_s"] - res["capture_s"])),
                     "warm_seconds": res["warm_s"],
                     "frontend_seconds": res["frontend_s"],
                     "peak_allocated_bytes": peak,
                     "launches": {**K.launch_counts(),
                                  "mec_conv1d": C.mec_conv1d.launches},
                     "frontend_replays": res["frontend_replays"],
                     "warmup": [(r.warning_count, r.plan_cache_io_errors,
                                 [p.algorithm for p in r.plans.values()])
                                for r in res["warmup"]],
                     "drops": res["drops"],
                     "tokens": toks, "prefill_logits": res["prefill_logits"],
                     "logits": res["logits"]}
        del res
    check(torch.equal(out["graph"]["tokens"], out["eager"]["tokens"]),
          f"{cfg.name}: graph and eager decode gave other greedy tokens")
    return out


def public(run: dict) -> dict:
    """A serve_both mode's record without its tensors."""
    return {k: v for k, v in run.items() if not isinstance(v, torch.Tensor)}


def graph_vs_eager(model, params, cache, tokens) -> dict:
    """``tokens.shape[1]`` decode steps from ``cache`` through a captured
    ``DecodeProgram`` (on a clone) and through ``decode_step`` eagerly:
    equal bits on every step's logits and on every cache leaf after.
    Returns the program's last logits (the eager cache advanced)."""
    from repro_torch.models import serve as serve_lib
    from repro_torch.models.lm import tree_map
    from repro_torch.serving import DecodeProgram
    g_cache = tree_map(torch.clone, cache)
    prog = DecodeProgram(
        lambda c, t: serve_lib.decode_step(model, params, c, t), g_cache,
        torch.zeros_like(tokens[:, :1]))
    check(prog.graph is not None, f"{model.cfg.name}: no graph captured")
    diffs, e_cache = [], cache
    for i in range(tokens.shape[1]):
        tok = tokens[:, i:i + 1]
        prog.tokens.copy_(tok)
        g = prog().clone()
        e, e_cache = serve_lib.decode_step(model, params, e_cache, tok)
        diffs.append((g.double() - e.double()).abs().max().item())
        check(torch.equal(g, e), f"{model.cfg.name} step {i}: the graph's "
              f"logits differ from the eager step's by {diffs[-1]}")
    gl, el = tree_leaves(g_cache), tree_leaves(e_cache)
    check(sorted(gl) == sorted(el), f"{model.cfg.name}: cache trees differ")
    unequal = [n for n in gl if not torch.equal(gl[n], el[n])]
    check(not unequal, f"{model.cfg.name}: the graph's cache differs from the "
          f"eager one on {unequal}")
    return {"steps": tokens.shape[1], "logits_max_abs_diff": max(diffs),
            "cache_leaves_equal": len(gl), "replays": prog.replays}, g, e_cache


def family_checks(model, params, inputs, extra, gate: bool = True) -> dict:
    """One family on the card: from a prefill of ``inputs`` (tokens (B, P)
    and the family's frontend entries), GRAPH_STEPS decode steps of
    ``extra`` through the captured program against the eager step (equal
    bits, :func:`graph_vs_eager`), and the last step's logits against a
    prefill of all P + GRAPH_STEPS tokens: rel <= LOGITS_TOL when
    ``gate`` (f32), reported otherwise (bf16: decode and prefill round in
    different places, and tens of random-weight layers amplify a rounding
    apart into percents of the logits)."""
    from repro_torch.models import serve as serve_lib
    prefix = inputs["vision"].shape[1] if "vision" in inputs else 0
    max_len = prefix + inputs["tokens"].shape[1] + extra.shape[1]
    _, cache = serve_lib.prefill(model, params, inputs, max_len)
    rec, logits, _ = graph_vs_eager(model, params, cache, extra)
    del cache
    full, _ = serve_lib.prefill(
        model, params,
        dict(inputs, tokens=torch.cat([inputs["tokens"], extra], dim=1)),
        max_len)
    rec["decode_vs_prefill"] = scaled_err(logits, full)
    check(not gate or rec["decode_vs_prefill"] <= LOGITS_TOL,
          f"{model.cfg.name} {model.cfg.dtype}: {GRAPH_STEPS} graph decode "
          f"steps against a prefill, {rec['decode_vs_prefill']} > {LOGITS_TOL}")
    return rec


def drive_batcher(batcher, requests) -> dict:
    """Submit ``requests`` and tick until every one is done: wall seconds,
    the seconds spent admitting (prefills, read on the host clock around
    each admission, which reads its token from the device) and decoding,
    ticks and tokens.  Every request ends at its budget or at its first
    EOS, and every slot is free at the end."""
    for req in requests:
        batcher.submit(req)
    admit, spent = batcher._admit, [0.0]

    def timed_admit():
        t = time.perf_counter()
        admit()
        spent[0] += time.perf_counter() - t

    batcher._admit = timed_admit
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ticks = 0
    while batcher.queue or batcher.live:
        batcher.step()
        ticks += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del batcher._admit          # no batcher -> closure -> batcher cycle
    tokens = sum(len(r.out) for r in batcher.done)
    check(len(batcher.done) == len(requests),
          f"the batcher finished {len(batcher.done)} of {len(requests)}")
    check(batcher.cache["lens"].tolist() == [-1] * batcher.n_slots,
          f"slots left live: {batcher.cache['lens'].tolist()}")
    for req in batcher.done:
        stop = [i for i, t in enumerate(req.out) if t == req.eos_id]
        check(len(req.out) == req.max_new_tokens if not stop
              else stop == [len(req.out) - 1],
              f"request {req.rid}: {len(req.out)} tokens, eos at {stop}")
    decode_tokens = tokens - len(requests)     # the first come from prefill
    return {"requests": len(requests), "ticks": ticks, "tokens": tokens,
            "seconds": wall, "tokens_per_s": tokens / wall,
            "admit_seconds": spent[0], "decode_seconds": wall - spent[0],
            "decode_tokens_per_s": decode_tokens / (wall - spent[0])}


def batcher_vs_solo(model, params, done, rows, tol=None,
                    gate_name="") -> float:
    """Each request served alone (batch-1 prefill, its cache quantized
    when ``model`` has the int8 cache, as the batcher's pool is, then eager
    decode fed the batcher's own tokens): the largest scaled error of the
    batcher's logits ``rows`` (:func:`record_logits`) against the solo
    rows, checked against ``tol`` (None: reported only)."""
    from repro_torch.models import serve as serve_lib
    from repro_torch.models.layers import kv_entries, kv_planes
    worst = 0.0
    for req in done:
        batch = {"tokens": req.prompt[None], **(req.extras or {})}
        prefix = batch["vision"].shape[1] if "vision" in batch else 0
        max_len = prefix + req.prompt.shape[0] + len(req.out)
        logits, cache = serve_lib.prefill(model, params, batch, max_len)
        if model.cfg.kv_cache_int8:
            planes = kv_planes(cache["k"].shape, None, True, DEVICE)
            for name, val in kv_entries(planes, cache["k"], cache["v"]):
                planes[name].copy_(val)
            cache = dict(planes, len=cache["len"])
        solo = [logits[0]]
        for tok in req.out[:-1]:
            logits, cache = serve_lib.decode_step(
                model, params, cache,
                torch.tensor([[tok]], device=DEVICE))
            solo.append(logits[0])
        errs = [scaled_err(a, b) for a, b in zip(rows[req.rid], solo)]
        worst = max(worst, max(errs))
        check(tol is None or max(errs) <= tol,
              f"{model.cfg.name} {model.cfg.dtype} {gate_name}: request "
              f"{req.rid} against the same served alone, {max(errs)} > {tol}")
        del cache
    return worst


def make_requests(cfg, n, prompt_range, new_range, seed, extras=None,
                  eos=None):
    """``n`` requests with seeded prompt lengths, token ids and token
    budgets (lengths drawn on the host, ids on the card); ``eos`` maps a
    request id to its eos id."""
    from repro_torch.serving import Request
    host = torch.Generator().manual_seed(seed)
    lens = torch.randint(prompt_range[0], prompt_range[1] + 1, (n,),
                         generator=host).tolist()
    news = torch.randint(new_range[0], new_range[1] + 1, (n,),
                         generator=host).tolist()
    dev = torch.Generator(device=DEVICE).manual_seed(seed)
    return [Request(rid=i, prompt=torch.randint(0, cfg.vocab, (lens[i],),
                                                generator=dev, device=DEVICE),
                    max_new_tokens=news[i],
                    eos_id=(eos or {}).get(i),
                    extras=extras[i] if extras else None)
            for i in range(n)]


def copy_requests(reqs):
    from repro_torch.serving import Request
    return [Request(rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                    eos_id=r.eos_id, extras=r.extras) for r in reqs]


def pool_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(cache).values())


def record_logits(batcher) -> dict:
    """Wrap ``batcher``'s prefill and decode program, as attributes of the
    instance, so that each request's logits rows (its prefill's, then one
    a tick while it is live) collect in the returned {rid: [(V,) f32]}."""
    rows = {}
    prefill, decode = batcher._prefill, batcher._decode

    def recorded_prefill(req, slot):
        row = prefill(req, slot)
        rows[req.rid] = [row]
        return row

    def recorded_decode():
        logits = decode()
        for req in batcher.live.values():
            rows[req.rid].append(logits[req.slot].clone())
        return logits

    batcher._prefill, batcher._decode = recorded_prefill, recorded_decode
    return rows


def run_batcher(model, params, reqs, n_slots, max_len, eager=False):
    """A fresh batcher over copies of ``reqs`` (its decode program eager
    when ``eager``): (its record with the peak bytes, pool bytes and the
    seconds its constructor took, which builds the decode program, outside
    the record's other seconds; its requests by id; their logits rows by
    id)."""
    from repro_torch.serving import ContinuousBatcher
    free_card()
    t0 = time.perf_counter()
    with eager_decode() if eager else contextlib.nullcontext():
        batcher, peak = peak_run(lambda: ContinuousBatcher(
            model, params, n_slots=n_slots, max_len=max_len))
    build_s = time.perf_counter() - t0
    program = batcher._decode
    rows = record_logits(batcher)
    rec, peak_run_b = peak_run(lambda: drive_batcher(batcher,
                                                     copy_requests(reqs)))
    del batcher._prefill          # no batcher -> closure -> batcher cycle
    batcher._decode = program
    rec.update(peak_allocated_bytes=max(peak, peak_run_b),
               build_seconds=build_s,
               graph=program.graph is not None, replays=program.replays,
               pool_bytes=pool_bytes(batcher.cache))
    return rec, {r.rid: r for r in batcher.done}, rows


def int8_decode_rel(cfg, params, seed: int, control: bool = False) -> float:
    """tests/test_kv_quant.py test_int8_cache_decode_dense: 6 decode steps
    of the same seeded tokens (batch 2) from zero caches of 16 positions,
    float against int8: the last step's scaled error.  ``control`` rolls
    the int8 cache's scale planes by one layer before the last step, so
    that step reads five positions' scales from the wrong layer."""
    from repro_torch.models import lm as lm_mod, serve as serve_lib
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (2, 8), generator=g, device=DEVICE)
    last = {}
    for int8 in (False, True):
        model = lm_mod.LM(cfg.with_(kv_cache_int8=int8))
        cache = serve_lib.init_decode_cache(model, 2, 16, device=DEVICE)
        cache["len"].zero_()
        for t in range(6):
            if int8 and control and t == 5:
                for name in ("k_s", "v_s"):
                    cache[name].copy_(cache[name].roll(1, 0))
            logits, cache = serve_lib.decode_step(model, params, cache,
                                                  toks[:, t:t + 1])
        last[int8] = logits
    return scaled_err(last[True], last[False])


def int8_depth_sweep(cfg, params, seed: int) -> dict:
    """:func:`int8_decode_rel` at the model's widths over the first
    INT8_DEPTHS layers of ``params`` (the last, full depth, gated under
    INT8_FULL_GATE), and the control at full depth, which must read above
    the gate: the gate tells a sound int8 cache from one whose scales come
    from the wrong layer."""
    from repro_torch.models.lm import tree_map
    sweep = {}
    for depth in INT8_DEPTHS:
        cut = dict(params, blocks=tree_map(lambda x: x[:depth],
                                           params["blocks"]))
        sweep[depth] = int8_decode_rel(cfg.with_(n_layers=depth), cut, seed)
    full = sweep[cfg.n_layers]
    control = int8_decode_rel(cfg, params, seed, control=True)
    check(full < INT8_FULL_GATE, f"{cfg.name} {cfg.dtype}: int8 cache decode "
          f"against the float cache, {full} >= {INT8_FULL_GATE}")
    check(control > INT8_FULL_GATE, f"{cfg.name}: the control (scales from "
          f"the wrong layer) reads {control}, under the gate {INT8_FULL_GATE}")
    return {"by_depth": sweep, "control_wrong_layer_scales": control,
            "gate": INT8_FULL_GATE}


def serve_dense_phase(seed: int) -> dict:
    """The dense family on the card (phase 6d): qwen3-4b at full size (36
    layers, seeded random weights).  (a) bf16 ``serve()`` at batch 8,
    prompt 128, 32 greedy tokens, with the captured decode program and
    eagerly (equal tokens; no conv kernel runs).  (b) bf16: graph against
    eager (equal bits), decode against prefill (reported), four decode
    steps traced eagerly and captured.  (c) 24 seeded requests (prompts
    32-512, 16-64 new tokens; one stops on EOS at prefill, one at its third
    token unless its stream diverges first) through an 8-slot batcher of
    1024 positions in bf16: with the graph, eagerly (equal logits bits),
    with the int8 KV cache (pool under 0.6 x bf16) and with triangle
    attention (equal bits); the first 8 requests against themselves served
    alone, the int8 batcher's against themselves served alone with the
    int8 cache (reported).  (d) f32, the same weights' distribution:
    decode against prefill within 2e-2; the int8 decode error over depth
    (:func:`int8_depth_sweep`: full depth under 0.1, its control above);
    the first 8 requests through an f32 batcher, each within 2e-2 of
    itself served alone, and through an f32 int8 batcher, each within
    2e-2 of itself served alone with the int8 cache and under 0.1 against
    the float path fed its tokens.  (e) The int8 decode attention at the
    model's
    widths within 0.03.  (f) The f32 smoke batcher: tokens equal to each
    request served alone; the int8 decode gate (0.05) at the JAX
    package's smoke sizes, yi-6b and qwen3-4b."""
    from repro_torch.configs.archs import ARCHS, smoke_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import lm as lm_mod, serve as serve_lib
    from repro_torch.models.layers import (decode_attention,
                                           f32_accumulation, quantize_kv)
    from repro_torch.serving import ContinuousBatcher

    t_phase = time.perf_counter()
    cfg = ARCHS[DENSE_ARCH]
    served = serve_both(cfg, seed, batch=DENSE_BATCH, prompt_len=DENSE_PROMPT,
                        gen=DENSE_GEN)
    for mode in ("graph", "eager"):
        check(not any(served[mode]["launches"].values()),
              f"qwen3-4b {mode} launched {served[mode]['launches']}")
    out = {"phase": "serve_dense", "arch": DENSE_ARCH, "dtype": cfg.dtype,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads], "d_ff": cfg.d_ff,
           "vocab": cfg.vocab, "params": cfg.param_count(),
           "serve": {"batch": DENSE_BATCH, "prompt": DENSE_PROMPT,
                     "generated": DENSE_GEN,
                     **{m: public(served[m]) for m in served}}}
    del served
    free_card()
    model = lm_mod.LM(cfg)
    # request 0 stops on its prefill token, request 1 on its third greedy
    # token alone; the first DENSE_CHECKED are also served alone
    reqs = make_requests(cfg, DENSE_REQUESTS, DENSE_REQ_PROMPT, DENSE_REQ_NEW,
                         seed + 5)
    with torch.inference_mode(), f32_accumulation():
        params = launch_serve.init_params(cfg, seed, DEVICE)
        prompt = launch_serve.make_prompt(cfg, DENSE_BATCH,
                                          DENSE_PROMPT + GRAPH_STEPS, seed,
                                          DEVICE)
        out["family_checks"] = family_checks(
            model, params, {"tokens": prompt[:, :DENSE_PROMPT]},
            prompt[:, DENSE_PROMPT:], gate=False)
        _, cache = serve_lib.prefill(model, params,
                                     {"tokens": prompt[:, :DENSE_PROMPT]},
                                     DENSE_PROMPT + 6)
        out["decode_profile"] = profile_decode(model, params, cache,
                                               prompt[:, -1:], GRAPH_STEPS)
        out["roofline"] = [
            roofline_reading("serve_dense decode (graph)", cfg, "decode",
                             DENSE_BATCH, DENSE_PROMPT + 6,
                             out["decode_profile"]["graph"]["device_busy_s"]
                             / GRAPH_STEPS, "device"),
            roofline_reading("serve_dense prefill", cfg, "prefill",
                             DENSE_BATCH, DENSE_PROMPT,
                             out["serve"]["graph"]["prefill_seconds"],
                             "host")]
        del cache, prompt
        first, _ = serve_lib.prefill(model, params,
                                     {"tokens": reqs[0].prompt[None]},
                                     reqs[0].prompt.shape[0])
        reqs[0].eos_id = int(torch.argmax(first[0]))
        logits, cache = serve_lib.prefill(model, params,
                                          {"tokens": reqs[1].prompt[None]},
                                          reqs[1].prompt.shape[0] + 3)
        for _ in range(2):
            logits, cache = serve_lib.decode_step(
                model, params, cache, torch.argmax(logits, -1)[:, None])
        reqs[1].eos_id = int(torch.argmax(logits[0]))
        del cache, logits, first
        runs, done, rows = {}, {}, {}
        int8_model = lm_mod.LM(cfg.with_(kv_cache_int8=True))
        for name, mmodel, eager in (
                ("graph", model, False), ("eager", model, True),
                ("int8", int8_model, False),
                ("tri", lm_mod.LM(cfg.with_(attn_skip_masked=True)), False)):
            runs[name], done[name], rows[name] = run_batcher(
                mmodel, params, reqs, DENSE_SLOTS, DENSE_MAX_LEN, eager)
        check(len(done["graph"][0].out) == 1,
              f"request 0 did not stop on its prefill token: {done['graph'][0].out}")
        for name in ("eager", "tri"):
            same = all(done[name][i].out == done["graph"][i].out
                       and all(torch.equal(a, b) for a, b in
                               zip(rows[name][i], rows["graph"][i]))
                       for i in done["graph"])
            check(same, f"the {name} batcher's logits differ from the graph's")
        runs["graph"]["vs_solo_bf16"] = batcher_vs_solo(
            model, params, [done["graph"][i] for i in range(DENSE_CHECKED)],
            rows["graph"])
        runs["int8"]["vs_int8_solo_bf16"] = batcher_vs_solo(
            int8_model, params, [done["int8"][i] for i in range(DENSE_CHECKED)],
            rows["int8"])
        ratio = runs["int8"]["pool_bytes"] / runs["graph"]["pool_bytes"]
        check(ratio < INT8_BYTES_RATIO, f"int8 pool is {ratio} x the bf16 pool")
        runs["int8"]["pool_ratio"] = ratio
        runs["eos_request_1"] = done["graph"][1].out[-1] == reqs[1].eos_id
        del done, rows, params
        free_card()
        # (d) f32: the gates
        f32 = cfg.with_(dtype="float32")
        model32 = lm_mod.LM(f32)
        params = launch_serve.init_params(f32, seed, DEVICE)
        prompt = launch_serve.make_prompt(f32, 2, DENSE_PROMPT + GRAPH_STEPS,
                                          seed, DEVICE)
        out["family_checks_f32"] = family_checks(
            model32, params, {"tokens": prompt[:, :DENSE_PROMPT]},
            prompt[:, DENSE_PROMPT:])
        out["int8_decode_f32"] = int8_depth_sweep(f32, params, seed + 6)
        sub = reqs[:DENSE_CHECKED]
        runs["f32"], done32, rows32 = run_batcher(
            model32, params, sub, DENSE_SLOTS, DENSE_MAX_LEN)
        runs["f32"]["vs_solo"] = batcher_vs_solo(
            model32, params, done32.values(), rows32, LOGITS_TOL, "batcher")
        model8 = lm_mod.LM(f32.with_(kv_cache_int8=True))
        runs["f32_int8"], done8, rows8 = run_batcher(
            model8, params, sub, DENSE_SLOTS, DENSE_MAX_LEN)
        runs["f32_int8"]["vs_int8_solo"] = batcher_vs_solo(
            model8, params, done8.values(), rows8, LOGITS_TOL, "int8 batcher")
        runs["f32_int8"]["vs_float_solo"] = batcher_vs_solo(
            model32, params, done8.values(), rows8, INT8_FULL_GATE,
            "int8 batcher against the float path")
        out["batcher"] = {"slots": DENSE_SLOTS, "max_len": DENSE_MAX_LEN,
                          "prompt_range": DENSE_REQ_PROMPT,
                          "new_range": DENSE_REQ_NEW, "checked": DENSE_CHECKED,
                          **runs}
        del done32, done8, rows32, rows8, params, prompt
        free_card()
        # (e) the int8 decode attention at qwen3-4b's widths
        g = torch.Generator(device=DEVICE).manual_seed(seed + 6)
        b, smax, hd = DENSE_SLOTS, DENSE_MAX_LEN, cfg.head_dim
        q = torch.randn((b, 1, cfg.n_heads, hd), generator=g, device=DEVICE,
                        dtype=torch.bfloat16)
        kv = [torch.randn((b, smax, cfg.n_kv_heads, hd), generator=g,
                          device=DEVICE, dtype=torch.bfloat16) for _ in range(2)]
        length = torch.tensor(smax - 100, dtype=torch.int32, device=DEVICE)
        exact = decode_attention(q, kv[0], kv[1], length)
        (kq, ks), (vq, vs) = quantize_kv(kv[0]), quantize_kv(kv[1])
        quant = decode_attention(q, kq, vq, length, k_scale=ks, v_scale=vs)
        rel = scaled_err(quant, exact)
        check(rel < INT8_ATTN_GATE, f"int8 decode attention: {rel}")
        out["int8_attention"] = {"shape": [b, smax, cfg.n_kv_heads, hd],
                                 "rel": rel, "gate": INT8_ATTN_GATE}
        del q, kv, kq, vq
    free_card()
    # (f) the f32 smoke batcher: tokens equal to each request served alone;
    # the int8 decode gate at the JAX package's own sizes
    scfg = smoke_config(SMOKE_BATCHER_ARCH)
    smodel = lm_mod.LM(scfg)
    with torch.inference_mode(), f32_accumulation():
        out["int8_decode_smoke"] = {
            arch: int8_decode_rel(smoke_config(arch), launch_serve.init_params(
                smoke_config(arch), seed, DEVICE), seed + 6)
            for arch in ("yi-6b", "qwen3-4b")}
        for arch, rel in out["int8_decode_smoke"].items():
            check(rel < INT8_DECODE_GATE, f"{arch} smoke: int8 cache decode "
                  f"against the float cache, {rel} >= {INT8_DECODE_GATE}")
        sparams = launch_serve.init_params(scfg, seed, DEVICE)
        sreqs = make_requests(scfg, 6, (4, 30), (4, 12), seed + 7)
        batcher = ContinuousBatcher(smodel, sparams, n_slots=3, max_len=64)
        drive_batcher(batcher, sreqs)
        for req in batcher.done:
            logits, cache = serve_lib.prefill(smodel, sparams,
                                              {"tokens": req.prompt[None]}, 64)
            solo = [int(torch.argmax(logits[0]))]
            for _ in range(req.max_new_tokens - 1):
                logits, cache = serve_lib.decode_step(
                    smodel, sparams, cache,
                    torch.tensor([[solo[-1]]], device=DEVICE))
                solo.append(int(torch.argmax(logits[0])))
            check(req.out == solo, f"smoke batcher request {req.rid}: "
                  f"{req.out} != {solo}")
        out["smoke_batcher_tokens_equal"] = len(batcher.done)
    out["phase_seconds"] = round(time.perf_counter() - t_phase, 3)
    emit(out)
    return out


def serve_vlm_phase(seed: int) -> dict:
    """The vlm family on the card (phase 6e): llava-next-34b at published
    widths and full depth (60 layers, bf16, seeded random weights).
    (a) ``serve(warm_plans=True, shape_classes=[(2, 336, 336)])``: a
    seeded 336 x 336 image a sequence through the warmed patch embed (K1:
    its eager warm-up and its capture, then one replay) to 2880 vision
    tokens, prompt 128, 32 greedy tokens, with the captured decode program
    and eagerly.  (b) Graph against eager (equal bits) and decode against
    prefill (reported in bf16), the vision tokens through the same
    frontend.  (c) 4 requests with vision extras through a 2-slot batcher
    (slot recycling forced), each against itself served alone (reported).
    (d) In f32 at full width, the depth cut to VLM_F32_LAYERS (full depth
    is 128 GiB in f32): decode against prefill and the 4 requests through
    a 2-slot batcher, each within 2e-2.  (e) Triangle attention at the
    prefill's length and the model's heads: equal bits to
    ``chunked_attention``."""
    from repro_torch.configs.archs import ARCHS
    from repro_torch.kernels import mec_conv as K
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import lm as lm_mod
    from repro_torch.models.layers import (chunked_attention,
                                           chunked_attention_tri,
                                           f32_accumulation)

    t_phase = time.perf_counter()
    free_card()
    allocated_at_start = torch.cuda.memory_allocated()
    cfg = ARCHS[VLM_ARCH]
    classes = [(VLM_BATCH, VLM_IMAGE, VLM_IMAGE)]
    served = serve_both(cfg, seed, batch=VLM_BATCH, prompt_len=VLM_PROMPT,
                        gen=VLM_GEN, warm_plans=True, shape_classes=classes)
    for mode in ("graph", "eager"):
        run = served[mode]
        check(run["launches"] == {"mec_conv_fused": 2, "mec_lower": 0,
                                  "mec_gemm": 0, "mec_conv_fused2": 0,
                                  "mec_weight_grad": 0, "mec_conv1d": 0},
              f"llava {mode} launched {run['launches']}: K1 once eagerly and "
              "once captured")
        check(run["frontend_replays"] == 1, f"llava {mode}: "
              f"{run['frontend_replays']} patch-embed replays")
        check(run["warmup"] == [(0, 0, ["mec_fused"])],
              f"llava {mode} warm-up: {run['warmup']}")
    out = {"phase": "serve_vlm", "arch": VLM_ARCH, "dtype": cfg.dtype,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads], "d_ff": cfg.d_ff,
           "vocab": cfg.vocab, "prefix_len": cfg.prefix_len,
           "params": cfg.param_count(),
           "allocated_at_start": allocated_at_start,
           "serve": {"batch": VLM_BATCH, "image": [VLM_IMAGE, VLM_IMAGE],
                     "prompt": VLM_PROMPT, "generated": VLM_GEN,
                     **{m: public(served[m]) for m in served}},
           "k1_launches": served["graph"]["launches"]["mec_conv_fused"]}
    del served
    free_card()
    max_len = cfg.prefix_len + VLM_REQ_PROMPT[1] + VLM_REQ_NEW[1]
    for dcfg, gate in ((cfg, False),
                       (cfg.with_(dtype="float32", n_layers=VLM_F32_LAYERS),
                        True)):
        key = "" if not gate else "_f32"
        model = lm_mod.LM(dcfg)
        with torch.inference_mode(), f32_accumulation():
            K.reset_launch_counts()
            frontend, services = launch_serve.warm_frontend(dcfg, classes,
                                                            seed, DEVICE)
            params = launch_serve.init_params(dcfg, seed, DEVICE)
            g = torch.Generator(device=DEVICE).manual_seed(seed + 4)
            image = torch.randn((VLM_BATCH, VLM_IMAGE, VLM_IMAGE, 3),
                                generator=g, device=DEVICE)
            prompt = launch_serve.make_prompt(dcfg, VLM_BATCH,
                                              VLM_PROMPT + GRAPH_STEPS, seed,
                                              DEVICE)
            out["family_checks" + key] = family_checks(
                model, params, {"tokens": prompt[:, :VLM_PROMPT],
                                "vision": frontend(image)},
                prompt[:, VLM_PROMPT:], gate=gate)
            del image, prompt
            images = [torch.randn((1, VLM_IMAGE, VLM_IMAGE, 3), generator=g,
                                  device=DEVICE) for _ in range(VLM_REQUESTS)]
            extras = [{"vision": frontend(im)} for im in images]
            reqs = make_requests(dcfg, VLM_REQUESTS, VLM_REQ_PROMPT,
                                 VLM_REQ_NEW, seed + 8, extras=extras)
            rec, done, rows = run_batcher(model, params, reqs, VLM_SLOTS,
                                          max_len)
            rec["vs_solo"] = batcher_vs_solo(
                model, params, done.values(), rows,
                LOGITS_TOL if gate else None, "batcher")
            rec.update(slots=VLM_SLOTS, max_len=max_len, layers=dcfg.n_layers)
            out["batcher" + key] = rec
            out["frontend" + key] = {
                "launches": K.launch_counts(),
                "replays": sum(sum(s.replays.values()) for s in services)}
            del done, rows, reqs, extras, images, params, frontend, services
        free_card()
    # (e) triangle attention at the prefill's length and the model's heads
    s = cfg.prefix_len + VLM_PROMPT
    g = torch.Generator(device=DEVICE).manual_seed(seed + 9)
    q = torch.randn((VLM_BATCH, s, cfg.n_heads, cfg.head_dim), generator=g,
                    device=DEVICE, dtype=torch.bfloat16)
    k, v = (torch.randn((VLM_BATCH, s, cfg.n_kv_heads, cfg.head_dim),
                        generator=g, device=DEVICE, dtype=torch.bfloat16)
            for _ in range(2))
    with torch.inference_mode():
        tri = chunked_attention_tri(q, k, v, cfg.q_chunk, cfg.kv_chunk)
        plain = chunked_attention(q, k, v, True, cfg.q_chunk, cfg.kv_chunk)
    nq, nk = -(-s // cfg.q_chunk), -(-s // cfg.kv_chunk)
    visited = sum(1 for i in range(nq) for j in range(nk)
                  if j * cfg.kv_chunk <= (i + 1) * cfg.q_chunk - 1)
    diff = (tri.double() - plain.double()).abs().max().item()
    check(torch.equal(tri, plain), f"triangle attention differs from the "
          f"plain one by {diff}")
    out["triangle_attention"] = {"shape": list(q.shape), "kv": cfg.n_kv_heads,
                                 "chunks": [cfg.q_chunk, cfg.kv_chunk],
                                 "pairs": [visited, nq * nk],
                                 "max_abs_diff": diff, "equal_bits": True}
    del q, k, v, tri, plain
    free_card()
    out["phase_seconds"] = round(time.perf_counter() - t_phase, 3)
    emit(out)
    return out


def traced_prefill(model, params, batch, max_len) -> dict:
    """One prefill (after an untraced one) under ``torch.profiler``: device
    time by kernel and idle share, and the host-clock seconds spent in the
    sLSTM blocks (``models.xlstm.slstm_core``, synchronised around each
    call) over the prefill's seconds."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import serve as serve_lib, xlstm
    serve_lib.prefill(model, params, batch, max_len)
    torch.cuda.synchronize()
    core, spent = xlstm.slstm_core, [0.0]

    def timed_core(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = core(*args)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t
        return out

    xlstm.slstm_core = timed_core
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            serve_lib.prefill(model, params, batch, max_len)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        xlstm.slstm_core = core
    return {**device_breakdown(prof, wall, top=8), "slstm_seconds": spent[0],
            "slstm_share": spent[0] / wall}


def serve_ssm_phase(seed: int) -> dict:
    """The ssm family on the card (phase 6f): xlstm-125m at full size (12
    layers: 3 super-blocks of 3 mLSTM and 1 sLSTM block, d_model 768,
    d_in 1536, 4 heads of 384, vocab 50304; seeded random weights),
    ``conv_impl="fused"``.  (a) bf16 ``serve()`` at batch 8, prompt 1024,
    32 greedy tokens, with the captured decode program and eagerly (equal
    tokens): 12 K5 launches (one a block) and no K1-K4 in each run.
    (b) bf16: K5 launches 12 times a prefill and 0 times a decode step;
    graph against eager over 4 steps (equal bits, logits and every cache
    leaf); decode against prefill (reported); four decode steps traced,
    eagerly and captured; one prefill traced, with the sLSTM scan's share.
    (c) f32: a prefill of 1024 tokens and one decode step against a
    prefill of 1025, and the lowered conv against the fused one on the
    same prompt, each within 2e-2 (bf16 reported).  (d) long_500k:
    ``configs.shapes.make_batch`` (batch 1, the cache at position 524287),
    its state bytes equal to a cache's of 64 and of max_seq (524352)
    positions, then 8 captured decode steps from it."""
    from repro_torch.configs.archs import ARCHS
    from repro_torch.configs.shapes import SHAPES, make_batch
    from repro_torch.kernels import mec_conv as K, mec_conv1d as C
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import lm as lm_mod, serve as serve_lib
    from repro_torch.models.layers import f32_accumulation
    from repro_torch.serving import DecodeProgram

    t_phase = time.perf_counter()
    free_card()
    cfg = ARCHS[SSM_ARCH].with_(conv_impl="fused")
    n_blocks = cfg.n_layers
    no_conv2d = {"mec_conv_fused": 0, "mec_lower": 0, "mec_gemm": 0,
                 "mec_conv_fused2": 0, "mec_weight_grad": 0}
    served = serve_both(cfg, seed, batch=SSM_BATCH, prompt_len=SSM_PROMPT,
                        gen=SSM_GEN)
    for mode in ("graph", "eager"):
        counts = served[mode]["launches"]
        check(counts == {**no_conv2d, "mec_conv1d": n_blocks},
              f"xlstm-125m {mode} launched {counts}, not {n_blocks} K5 and "
              "no K1-K4")
    out = {"phase": "serve_ssm", "arch": SSM_ARCH, "dtype": cfg.dtype,
           "conv_impl": cfg.conv_impl, "layers": cfg.n_layers,
           "blocks": {"mlstm": n_blocks - n_blocks // cfg.slstm_every,
                      "slstm": n_blocks // cfg.slstm_every},
           "d_model": cfg.d_model, "d_in": 2 * cfg.d_model,
           "heads": cfg.n_heads, "head_dim": 2 * cfg.d_model // cfg.n_heads,
           "vocab": cfg.vocab, "param_count_approx": cfg.param_count(),
           "serve": {"batch": SSM_BATCH, "prompt": SSM_PROMPT,
                     "generated": SSM_GEN,
                     **{m: public(served[m]) for m in served}},
           "k5_launches_served": served["graph"]["launches"]["mec_conv1d"]}
    fused_logits = served["graph"]["prefill_logits"]
    del served
    free_card()
    model = lm_mod.LM(cfg)
    with torch.inference_mode(), f32_accumulation():
        params = launch_serve.init_params(cfg, seed, DEVICE)
        out["params"] = sum(t.numel() for t in tree_leaves(params).values())
        out["param_bytes"] = sum(t.numel() * t.element_size()
                                 for t in tree_leaves(params).values())
        # serve()'s prompt, and GRAPH_STEPS tokens more
        head = {"tokens": launch_serve.make_prompt(cfg, SSM_BATCH, SSM_PROMPT,
                                                   seed, DEVICE)}
        extra = launch_serve.make_prompt(cfg, SSM_BATCH, GRAPH_STEPS,
                                         seed + 7, DEVICE)
        # (b) K5 per prefill and per decode step; serve() against a prefill
        C.mec_conv1d.launches = 0
        logits, cache = serve_lib.prefill(model, params, head,
                                          SSM_PROMPT + GRAPH_STEPS)
        torch.cuda.synchronize()
        prefill_k5 = C.mec_conv1d.launches
        C.mec_conv1d.launches = 0
        for i in range(GRAPH_STEPS):
            serve_lib.decode_step(model, params, cache, extra[:, i:i + 1])
        torch.cuda.synchronize()
        decode_k5 = C.mec_conv1d.launches
        check(prefill_k5 == n_blocks and decode_k5 == 0,
              f"xlstm-125m: K5 launched {prefill_k5} times in a prefill (not "
              f"{n_blocks}) and {decode_k5} in {GRAPH_STEPS} decode steps")
        out["k5_launches"] = {"prefill": prefill_k5,
                              "decode_steps": GRAPH_STEPS,
                              "decode": decode_k5}
        out["serve_vs_prefill_err"] = scaled_err(fused_logits, logits)
        check(out["serve_vs_prefill_err"] <= LOGITS_TOL,
              f"xlstm-125m: serve() and a prefill of its prompt differ by "
              f"{out['serve_vs_prefill_err']}")
        out["decode_profile"] = profile_decode(model, params, cache,
                                               extra[:, -1:], GRAPH_STEPS)
        out["roofline"] = roofline_reading(
            "serve_ssm decode (graph)", cfg, "decode", SSM_BATCH,
            SSM_PROMPT + SSM_GEN,
            out["decode_profile"]["graph"]["device_busy_s"] / GRAPH_STEPS,
            "device")
        del cache, logits
        out["prefill_profile"] = traced_prefill(model, params, head,
                                                SSM_PROMPT)
        out["family_checks"] = family_checks(model, params, head, extra,
                                             gate=False)
        out["family_checks"]["fused_vs_lowered"] = scaled_err(
            serve_lib.prefill(model, params, head, SSM_PROMPT)[0],
            serve_lib.prefill(lm_mod.LM(cfg.with_(conv_impl="lowered")),
                              params, head, SSM_PROMPT)[0])
        del params, head, extra
        free_card()
        # (c) the f32 gates
        f32 = cfg.with_(dtype="float32")
        model32 = lm_mod.LM(f32)
        params = launch_serve.init_params(f32, seed, DEVICE)
        prompt = launch_serve.make_prompt(f32, SSM_BATCH, SSM_PROMPT + 1,
                                          seed, DEVICE)
        head = {"tokens": prompt[:, :SSM_PROMPT]}
        _, cache = serve_lib.prefill(model32, params, head, SSM_PROMPT + 1)
        dec, _ = serve_lib.decode_step(model32, params, cache,
                                       prompt[:, SSM_PROMPT:])
        del cache
        full, _ = serve_lib.prefill(model32, params, {"tokens": prompt},
                                    SSM_PROMPT + 1)
        fused, _ = serve_lib.prefill(model32, params, head, SSM_PROMPT)
        lowered, _ = serve_lib.prefill(lm_mod.LM(f32.with_(conv_impl="lowered")),
                                       params, head, SSM_PROMPT)
        gates = {"decode_vs_prefill": scaled_err(dec, full),
                 "fused_vs_lowered": scaled_err(fused, lowered),
                 "finite": all(bool(torch.isfinite(t).all())
                               for t in (dec, full, fused, lowered))}
        for name in ("decode_vs_prefill", "fused_vs_lowered"):
            check(gates[name] <= LOGITS_TOL, f"xlstm-125m f32 {name}: "
                  f"{gates[name]} > {LOGITS_TOL}")
        check(gates["finite"], "xlstm-125m f32: logits are not finite")
        out["f32_gates"] = {**gates, "tol": LOGITS_TOL,
                            "prompt": SSM_PROMPT}
        del params, prompt, head, dec, full, fused, lowered
        free_card()
        # (d) long_500k: the state does not grow; captured steps from it
        cell = SHAPES["long_500k"]
        params = launch_serve.init_params(cfg, seed, DEVICE)
        batch = make_batch(cfg, cell, seed, DEVICE)
        cache = batch["cache"]
        sizes = {n: pool_bytes(serve_lib.init_decode_cache(
                     model, cell.global_batch, n, device=DEVICE))
                 for n in (64, cfg.max_seq)}
        check(int(cache["len"]) == cell.seq_len - 1
              and set(sizes.values()) == {pool_bytes(cache)},
              f"long_500k: len {int(cache['len'])}, state bytes "
              f"{pool_bytes(cache)} against {sizes}")
        t0 = time.perf_counter()
        prog = DecodeProgram(
            lambda c, t: serve_lib.decode_step(model, params, c, t), cache,
            batch["tokens"].clone())
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        check(prog.graph is not None, "long_500k: no graph captured")
        t0 = time.perf_counter()
        for _ in range(SSM_LONG_STEPS):
            logits = prog()
            prog.tokens.copy_(torch.argmax(logits, dim=-1, keepdim=True))
        torch.cuda.synchronize()
        long_s = time.perf_counter() - t0
        check(bool(torch.isfinite(logits).all()) and
              int(cache["len"]) == cell.seq_len - 1 + SSM_LONG_STEPS,
              f"long_500k: len {int(cache['len'])} after {SSM_LONG_STEPS} steps")
        out["long_500k"] = {"batch": cell.global_batch, "seq_len": cell.seq_len,
                            "len_after": int(cache["len"]),
                            "state_bytes": pool_bytes(cache),
                            "state_bytes_at": sizes, "steps": SSM_LONG_STEPS,
                            "build_seconds": build_s, "seconds": long_s,
                            "tokens_per_s": (cell.global_batch * SSM_LONG_STEPS
                                             / long_s)}
        del prog, cache, batch, params, logits
    free_card()
    out["phase_seconds"] = round(time.perf_counter() - t_phase, 3)
    emit(out)
    return out


def int8_cache_of(cache: dict) -> dict:
    """The float attention cache quantized into int8 planes with bf16
    scales (``models.layers.kv_planes``/``kv_entries``), its length kept."""
    from repro_torch.models.layers import kv_entries, kv_planes
    q = kv_planes(tuple(cache["k"].shape), None, True, cache["k"].device)
    for name, val in kv_entries(q, cache["k"], cache["v"]):
        q[name].copy_(val)
    return {**q, "len": cache["len"].clone()}


def layer_bytes(cfg, es: int):
    """(bytes of one layer, bytes of everything else) of the model's
    parameters at ``es`` bytes each, from ``param_count``."""
    base = cfg.with_(n_layers=0).param_count()
    return (cfg.with_(n_layers=1).param_count() - base) * es, base * es


def serve_moe_phase(seed: int) -> dict:
    """The moe family on the card (phase 6g).  (a) qwen3-moe-30b-a3b at full
    size (48 layers, 128 experts of d_ff 768, top-8, seeded random bf16
    weights drawn layer by layer on the card): ``serve()`` at batch 8,
    prompt 128, 32 greedy tokens, with the captured decode program and
    eagerly: equal tokens and last logits, equal drop counts (printed: the
    prefill's and each decode step's), no conv kernel.  (b) bf16: from a
    prefill of the same prompt, GRAPH_STEPS decode steps through the graph
    against the eager step (equal bits, logits and every cache leaf), on
    the float cache and on the cache quantized to int8; the int8 steps'
    logits against the float steps' (reported).  (c) f32 at 8 of 48 layers
    (full depth in f32 is 122 GB): GRAPH_STEPS decode steps from prefills
    of MOE_GATE_CASES (batch x prompt 1 x 1 up to 2 x 2048), each step's
    logits against a prefill of the same tokens within 2e-2, gated on the
    steps where neither the decode path (its prefill and steps) nor the
    reference prefill dropped an assignment; a prefill of at most 4 tokens
    must not drop, nor may any at a capacity factor of n_experts / top_k
    (one case at 2 x 256), and at least one step is gated.  (d) kimi-k2-1t-a32b at full
    width (384 experts of d_ff 2048 at d_model 7168, one shared expert) and
    the depth that fits: ``serve()`` at batch 2, prompt 32, 8 tokens,
    graph against eager (equal tokens, logits and drops)."""
    from repro_torch.configs.archs import ARCHS
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import lm as lm_mod, moe, serve as serve_lib
    from repro_torch.models.layers import f32_accumulation

    t_phase = time.perf_counter()
    free_card()
    out = {"phase": "serve_moe"}

    def served_record(cfg, served, **kw):
        for mode in ("graph", "eager"):
            check(not any(served[mode]["launches"].values()),
                  f"{cfg.name} {mode} launched {served[mode]['launches']}")
        check(torch.equal(served["graph"]["logits"], served["eager"]["logits"])
              and served["graph"]["drops"] == served["eager"]["drops"],
              f"{cfg.name}: graph and eager decode differ in their last "
              f"logits or drops ({served['graph']['drops']} against "
              f"{served['eager']['drops']})")
        return {**kw, **{m: public(served[m]) for m in served}}

    cfg = ARCHS[MOE_ARCH]
    served = serve_both(cfg, seed, batch=MOE_BATCH, prompt_len=MOE_PROMPT,
                        gen=MOE_GEN)
    out[MOE_ARCH] = {
        "dtype": cfg.dtype, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "experts": cfg.n_experts, "top_k": cfg.top_k,
        "moe_d_ff": cfg.moe_d_ff, "heads": [cfg.n_heads, cfg.n_kv_heads],
        "vocab": cfg.vocab, "params": cfg.param_count(),
        "param_bytes": cfg.param_count() * 2,
        "capacity": {"prefill": moe._capacity(MOE_BATCH * MOE_PROMPT, cfg),
                     "decode": moe._capacity(MOE_BATCH, cfg)},
        "serve": served_record(cfg, served, batch=MOE_BATCH,
                               prompt=MOE_PROMPT, generated=MOE_GEN)}
    del served
    free_card()
    model = lm_mod.LM(cfg)
    with torch.inference_mode(), f32_accumulation():
        params = launch_serve.init_params(cfg, seed, DEVICE)
        prompt = launch_serve.make_prompt(cfg, MOE_BATCH,
                                          MOE_PROMPT + GRAPH_STEPS, seed,
                                          DEVICE)
        _, cache = serve_lib.prefill(model, params,
                                     {"tokens": prompt[:, :MOE_PROMPT]},
                                     MOE_PROMPT + GRAPH_STEPS)
        extra = prompt[:, MOE_PROMPT:]
        q8 = int8_cache_of(cache)
        rec, float_logits, _ = graph_vs_eager(model, params, cache, extra)
        rec8, int8_logits, _ = graph_vs_eager(
            lm_mod.LM(cfg.with_(kv_cache_int8=True)), params, q8, extra)
        rec8["int8_vs_float_logits"] = scaled_err(int8_logits, float_logits)
        check(bool(torch.isfinite(int8_logits).all()),
              f"{MOE_ARCH}: int8 cache decode logits are not finite")
        out[MOE_ARCH]["graph_vs_eager"] = {"float": rec, "int8": rec8}
        del params, cache, q8, prompt, extra, float_logits, int8_logits
        free_card()
        # (c) the f32 gates at MOE_F32_LAYERS layers
        f32 = cfg.with_(dtype="float32", n_layers=MOE_F32_LAYERS)
        params = launch_serve.init_params(f32, seed, DEVICE)
        cases = []
        for batch, prompt_len, capacity in MOE_GATE_CASES:
            ccfg = (f32.with_(capacity_factor=f32.n_experts / f32.top_k)
                    if capacity == "no_drop" else f32)
            model32 = lm_mod.LM(ccfg)
            prompt = launch_serve.make_prompt(
                f32, batch, prompt_len + GRAPH_STEPS, seed, DEVICE)
            max_len = prompt_len + GRAPH_STEPS
            with moe.count_drops(DEVICE) as dropped:
                _, cache = serve_lib.prefill(
                    model32, params, {"tokens": prompt[:, :prompt_len]},
                    max_len)
                path_drops = int(dropped)
                steps = []
                for j in range(GRAPH_STEPS):
                    n = prompt_len + j
                    dropped.zero_()
                    dec, cache = serve_lib.decode_step(model32, params, cache,
                                                       prompt[:, n:n + 1])
                    path_drops += int(dropped)
                    dropped.zero_()
                    ref, _ = serve_lib.prefill(model32, params,
                                               {"tokens": prompt[:, :n + 1]},
                                               max_len)
                    ref_drops = int(dropped)
                    err = scaled_err(dec, ref)
                    gated = path_drops == 0 and ref_drops == 0
                    check(not gated or err <= LOGITS_TOL,
                          f"{MOE_ARCH} f32, {MOE_F32_LAYERS} layers, batch "
                          f"{batch}, prompt {prompt_len}, step {j}: decode "
                          f"against prefill {err} > {LOGITS_TOL}")
                    check(bool(torch.isfinite(dec).all()),
                          f"{MOE_ARCH} f32 step {j}: logits are not finite")
                    if batch * (n + 1) <= 4 or capacity == "no_drop":
                        check(gated, f"{MOE_ARCH} f32: {batch} x {n + 1} "
                              f"tokens, capacity {capacity}, dropped "
                              f"({path_drops}, {ref_drops})")
                    steps.append({"err": err, "decode_path_drops": path_drops,
                                  "prefill_drops": ref_drops, "gated": gated})
            cases.append({"batch": batch, "prompt": prompt_len,
                          "capacity_factor": ccfg.capacity_factor,
                          "capacity_prefill": moe._capacity(
                              batch * prompt_len, ccfg), "steps": steps})
            del cache, prompt, dec, ref
        gated = [st["err"] for c in cases for st in c["steps"] if st["gated"]]
        check(bool(gated), f"{MOE_ARCH} f32: no gated step: {cases}")
        out[MOE_ARCH]["f32_gates"] = {
            "layers": MOE_F32_LAYERS, "tol": LOGITS_TOL, "gated_steps":
            len(gated), "worst_gated_err": max(gated), "cases": cases}
        del params
    free_card()
    # (d) kimi-k2-1t-a32b at full width, the depth that fits
    big = ARCHS[MOE_BIG_ARCH]
    per_layer, rest = layer_bytes(big, 2)
    free = torch.cuda.mem_get_info()[0]
    head32 = big.d_model * big.vocab * 4
    layers = int((free - rest - head32 - KIMI_HEADROOM) // per_layer)
    check(layers >= 1, f"{MOE_BIG_ARCH}: no layer fits in {free} B")
    kcfg = big.with_(n_layers=layers)
    served = serve_both(kcfg, seed, batch=KIMI_BATCH, prompt_len=KIMI_PROMPT,
                        gen=KIMI_GEN)
    out[MOE_BIG_ARCH] = {
        "dtype": kcfg.dtype, "layers": layers, "of_layers": big.n_layers,
        "d_model": big.d_model, "experts": big.n_experts,
        "moe_d_ff": big.moe_d_ff, "shared_experts": big.n_shared_experts,
        "layer_param_bytes": per_layer, "other_param_bytes": rest,
        "param_bytes": kcfg.param_count() * 2, "free_bytes_before": free,
        "serve": served_record(kcfg, served, batch=KIMI_BATCH,
                               prompt=KIMI_PROMPT, generated=KIMI_GEN)}
    del served
    free_card()
    out["phase_seconds"] = round(time.perf_counter() - t_phase, 3)
    emit(out)
    return out


def attention_bytes(cfg) -> int:
    """What the plain chunked attention keeps for its backward when one
    layer is recomputed, at the train step's batch and full sequence (the
    vlm family's prefix included): for every chunk pair the f32 scores,
    the f32 probabilities and their bf16 and f32 casts, 14 bytes a score
    (23 GB for llava-next-34b's 2 x 3392 tokens)."""
    s = TRAIN_SEQ + (cfg.prefix_len if cfg.family == "vlm" else 0)
    pad_q = -(-s // min(cfg.q_chunk, s)) * min(cfg.q_chunk, s)
    pad_k = -(-s // min(cfg.kv_chunk, s)) * min(cfg.kv_chunk, s)
    return TRAIN_BATCH * cfg.n_heads * pad_q * pad_k * 14


def train_depth(cfg, budget: float) -> int:
    """The most layers (from ``cfg.n_layers`` down, whole xLSTM
    super-blocks) whose parameters at TRAIN_BYTES_PER_PARAM fit in
    ``budget`` bytes."""
    step = cfg.slstm_every if cfg.family == "ssm" else 1
    for n in range(cfg.n_layers, 0, -step):
        if TRAIN_BYTES_PER_PARAM * cfg.with_(n_layers=n).param_count() <= budget:
            return n
    raise AssertionError(f"{cfg.name}: no depth fits {budget} B")


RESUME_CODE = """
import json, sys
import torch
torch.use_deterministic_algorithms(True)
sys.path.insert(0, sys.argv[1])
from repro_torch.configs.archs import ARCHS
from repro_torch.kernels import mec_conv1d as C
from repro_torch.launch import train
args = train.parse_args(sys.argv[2:])
res = train.train(args, ARCHS[args.arch].with_(conv_impl="fused"))
print("RESUME " + json.dumps({"start": res["start"], "losses": res["losses"],
                              "step_s": res["step_s"],
                              "k5_launches": C.mec_conv1d.launches}))
"""


def resume_run(ckpt_dir: Path) -> dict:
    """``launch.train.train`` on xlstm-125m at full size (fused conv) in a
    process of its own, deterministic algorithms on and cuBLAS's workspace
    pinned before its first CUDA call, checkpointing into ``ckpt_dir``."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run(
        [sys.executable, "-c", RESUME_CODE, str(ROOT / "src"),
         "--arch", "xlstm-125m", "--steps", str(RESUME_STEPS),
         "--ckpt-dir", str(ckpt_dir), "--ckpt-every", str(RESUME_AT),
         "--lr", str(RESUME_LR), "--log-every", "5"],
        capture_output=True, text=True, env=env, timeout=600)
    print(proc.stdout[-2000:], proc.stderr[-4000:], sep="\\n", file=sys.stderr)
    check(proc.returncode == 0, f"launch.train exited {proc.returncode}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESUME ")]
    check(len(line) == 1, "launch.train printed no result")
    return json.loads(line[0][len("RESUME "):])


def traced_train_step(step, params, opt, batch, conv1d) -> dict:
    """One train step under ``torch.profiler``: its device time, and K5's
    in it, the device time of the kernels named in K5_KERNELS summed over
    the trace, their count beside the wrapper's launches in that step (the
    trace may miss a kernel: 129 of 130 on an H100 80GB HBM3, where the
    wrapper's count is exact)."""
    from torch.profiler import ProfilerActivity, profile
    conv1d.mec_conv1d.launches = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, met = step(params, opt, batch)
        loss = float(met["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = conv1d.mec_conv1d.launches
    k5 = [e for e in device_kernels(prof)
          if any(n in e.key for n in K5_KERNELS)]
    out = {"loss": loss, "k5_launches": launches,
           "k5_kernels": sum(e.count for e in k5),
           "k5_device_ms": sum(dev_us(e) for e in k5) / 1e3,
           **device_breakdown(prof, wall, top=8)}
    check(math.isfinite(loss) and 0 < out["k5_kernels"] <= launches,
          f"traced train step: loss {loss}, {out['k5_kernels']} K5 kernels "
          f"in the trace for {launches} launches")
    return out


def train_lm_phase(seed: int, tmp_dir: Path) -> dict:
    """LM training on the card (phase 6h).  (a) One ``make_train_step``
    step per family at full width (bf16, remat, AdamW in place), at the
    largest depth whose 12 bytes a parameter fit beside 14 GB and what one
    layer's plain attention keeps for its backward
    (:func:`attention_bytes`): xlstm-125m,
    whisper-tiny and qwen3-4b at full size, zamba2-7b, qwen3-moe-30b-a3b
    and llava-next-34b cut (each depth printed); batch 2 x 512 tokens from
    ``SyntheticLMData``; two steps, the second timed; finite loss and grad
    norm, the parameters moved; peak bytes.  xlstm-125m and zamba2-7b run
    ``conv_impl="fused"``: K5 in every block's forward (twice a step with
    remat: the forward and its recompute), its counts read around the
    step.  (b) Their gradients at full width and 2 (zamba2) or 4 (one
    xLSTM super-block) layers in f32 through the fused conv against the
    lowered conv, each leaf within 1e-4.  (c) The chunked loss at 8 x 2048
    tokens of qwen3-4b's head (vocab 151,936, bf16): forward and backward
    peak near one chunk's f32 logits (plus the head's f32 copy and its f32
    gradient), beside the same loss in one chunk.  (d) ``launch.train`` on
    xlstm-125m at full size, 20 steps with a checkpoint at 10, then a new
    process from that checkpoint alone: its losses for steps 10-19 equal
    the uninterrupted run's to the bit; the loss falls (the last five
    steps' mean below the first five's, all finite: at this rate no more
    than the batches differ).  (e) The optimizer learns: xlstm-125m on
    one repeated batch of (8, 128) tokens, its loss falls by at least 10
    times the spread of the initial loss over 8 batches in 6 steps.  The
    zamba2-7b step is traced once more (:func:`traced_train_step`): K5's
    device time in a train step."""
    from repro_torch.configs.archs import ARCHS
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import mec_conv as K, mec_conv1d as C
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import lm as lm_mod
    from repro_torch.models.layers import f32_accumulation
    from repro_torch.optim.adamw import AdamWConfig, tree_leaves as leaves_of
    from repro_torch.training import steps as steps_lib
    from repro_torch.training.loss import chunked_softmax_xent

    t_phase = time.perf_counter()
    out = {"phase": "train_lm", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "bytes_per_param": TRAIN_BYTES_PER_PARAM,
           "headroom_bytes": TRAIN_HEADROOM, "runs": {}}
    for arch in TRAIN_ARCHS:
        free_card()
        full = ARCHS[arch]
        budget = (torch.cuda.mem_get_info()[0] - TRAIN_HEADROOM
                  - attention_bytes(full))
        layers = train_depth(full, budget)
        cfg = full.with_(n_layers=layers)
        if arch in TRAIN_FUSED:
            cfg = cfg.with_(conv_impl="fused")
        model = lm_mod.LM(cfg)
        params = launch_serve.init_params(cfg, seed, DEVICE)
        n_params = sum(t.numel() for t in leaves_of(params))
        opt = steps_lib.init_opt_state(params)
        data = SyntheticLMData(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=seed,
                               device=DEVICE)
        # warmup 1: the first step at the full rate, which moves bf16
        # embeddings (a 1e-6 step would round away)
        step = steps_lib.make_train_step(
            model, AdamWConfig(warmup_steps=1, total_steps=10))
        before = params["emb"].clone()
        rec = {"layers": layers, "of_layers": full.n_layers,
               "conv_impl": cfg.conv_impl, "params": n_params,
               "state_bytes": sum(t.numel() * t.element_size()
                                  for t in leaves_of(params) + leaves_of(opt))}
        with f32_accumulation():
            for i in range(2):
                batch = data.next_batch()
                K.reset_launch_counts()
                C.mec_conv1d.launches = 0
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                params, opt, met = step(params, opt, batch)
                loss = float(met["loss"])
                torch.cuda.synchronize()
                rec[f"step{i}_seconds"] = time.perf_counter() - t0
                rec[f"step{i}_loss"] = loss
        rec["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
        rec["grad_norm"] = float(met["grad_norm"])
        rec["launches"] = {**K.launch_counts(),
                           "mec_conv1d": C.mec_conv1d.launches}
        if arch == TRAIN_TRACED:
            with f32_accumulation():
                rec["traced_step"] = traced_train_step(
                    step, params, opt, data.next_batch(), C)
        check(math.isfinite(rec["step1_loss"]) and math.isfinite(rec["grad_norm"]),
              f"{arch}: train step loss {rec['step1_loss']}, grad norm "
              f"{rec['grad_norm']}")
        check(not torch.equal(before, params["emb"]),
              f"{arch}: the train step left the parameters unchanged")
        # one K5 call a Mamba2 layer or xLSTM block, and again in its
        # recompute under remat
        want = (2 if cfg.remat else 1) * layers if arch in TRAIN_FUSED else 0
        check(rec["launches"] == {"mec_conv_fused": 0, "mec_lower": 0,
                                  "mec_gemm": 0, "mec_conv_fused2": 0,
                                  "mec_weight_grad": 0, "mec_conv1d": want},
              f"{arch} train step launched {rec['launches']}, not {want} K5")
        rec["roofline"] = roofline_reading(
            "train_lm step", cfg, "train", TRAIN_BATCH, TRAIN_SEQ,
            rec["step1_seconds"], "host")
        out["runs"][arch] = rec
        emit({"phase": "train_lm", "arch": arch, **rec}, sys.stderr)
        del params, opt, data, step, batch, met, before
    free_card()
    # (b) fused against lowered gradients, f32, full width
    grads = {}
    for arch, layers in TRAIN_GRAD_LAYERS.items():
        cfg = ARCHS[arch].with_(n_layers=layers, dtype="float32")
        params = launch_serve.init_params(cfg, seed, DEVICE)
        batch = SyntheticLMData(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=seed,
                                device=DEVICE).next_batch()
        got = {}
        with f32_accumulation():
            for impl in ("fused", "lowered"):
                p = lm_mod.tree_map(lambda t: t.detach().clone()
                                    .requires_grad_(True), params)
                C.mec_conv1d.launches = 0
                loss, _ = steps_lib.make_loss_fn(
                    lm_mod.LM(cfg.with_(conv_impl=impl)))(p, batch)
                loss.backward()
                torch.cuda.synchronize()
                got[impl] = ({n: t.grad for n, t in tree_leaves(p).items()},
                             C.mec_conv1d.launches, float(loss.detach()))
        # leaves the cut depth leaves unused (zamba2-7b's shared block
        # below attn_every layers) have no gradient on either path
        unused = {n for n, g in got["fused"][0].items() if g is None}
        check(unused == {n for n, g in got["lowered"][0].items() if g is None},
              f"{arch}: the two conv paths reach other leaves")
        errs = {n: scaled_err(g, got["lowered"][0][n])
                for n, g in got["fused"][0].items() if n not in unused}
        worst = max(errs, key=errs.get)
        check(errs[worst] <= TRAIN_GRAD_TOL,
              f"{arch} f32 {layers} layers: fused against lowered gradient "
              f"of {worst}: {errs[worst]} > {TRAIN_GRAD_TOL}")
        check(got["fused"][1] > 0 and got["lowered"][1] == 0,
              f"{arch}: K5 launched {got['fused'][1]} (fused) and "
              f"{got['lowered'][1]} (lowered) times")
        grads[arch] = {"layers": layers, "leaves": len(errs),
                       "unused_leaves": sorted(unused),
                       "worst_leaf": worst, "worst_err": errs[worst],
                       "conv_w_err": max(e for n, e in errs.items()
                                         if n.endswith("conv_w")),
                       "k5_launches": got["fused"][1],
                       "loss": {i: got[i][2] for i in got},
                       "tol": TRAIN_GRAD_TOL}
        del params, batch, got, p, loss
        free_card()
    out["fused_vs_lowered_grads"] = grads
    # (c) the chunked loss's memory
    lcfg = ARCHS[LOSS_ARCH]
    g = torch.Generator(device=DEVICE).manual_seed(seed + 8)
    b, s = LOSS_TOKENS
    h0 = torch.randn((b, s, lcfg.d_model), generator=g, device=DEVICE,
                     dtype=torch.bfloat16)
    w0 = (torch.randn((lcfg.d_model, lcfg.vocab), generator=g, device=DEVICE)
          * 0.02).to(torch.bfloat16)
    labels = torch.randint(0, lcfg.vocab, (b, s), generator=g, device=DEVICE)
    chunk_bytes = b * LOSS_CHUNK * lcfg.vocab * 4
    head32 = lcfg.d_model * lcfg.vocab * 4
    loss_mem = {"tokens": [b, s], "vocab": lcfg.vocab,
                "chunk_logits_bytes": chunk_bytes, "head_f32_bytes": head32}
    with f32_accumulation():
        for name, chunk in (("chunked", LOSS_CHUNK), ("one_chunk", s)):
            h = h0.clone().requires_grad_(True)
            w = w0.clone().requires_grad_(True)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss, met = chunked_softmax_xent(h, w, labels, chunk=chunk)
            torch.cuda.synchronize()
            fwd_peak = torch.cuda.max_memory_allocated() - base
            loss.backward()
            torch.cuda.synchronize()
            loss_mem[name] = {"chunk": chunk, "loss": float(loss),
                              "seconds": time.perf_counter() - t0,
                              "forward_peak_bytes": fwd_peak,
                              "peak_bytes": torch.cuda.max_memory_allocated()
                              - base}
            check(math.isfinite(float(loss)) and bool(torch.isfinite(w.grad).all()),
                  f"chunked loss ({name}): not finite")
            del h, w, loss, met
    grad_bytes = (h0.numel() + w0.numel()) * 2 + h0.numel() * 4
    bound = chunk_bytes + 2 * head32 + grad_bytes
    loss_mem["bound_bytes"] = bound
    check(loss_mem["chunked"]["peak_bytes"] <= 1.1 * bound,
          f"chunked loss peak {loss_mem['chunked']['peak_bytes']} B > 1.1 x "
          f"(one chunk's logits + the head's f32 copy and gradient + the "
          f"input gradients) {bound} B")
    check(abs(loss_mem["chunked"]["loss"] - loss_mem["one_chunk"]["loss"])
          <= 1e-4 * abs(loss_mem["one_chunk"]["loss"]),
          f"chunked loss {loss_mem['chunked']['loss']} against one chunk "
          f"{loss_mem['one_chunk']['loss']}")
    out["loss_memory"] = loss_mem
    del h0, w0, labels
    free_card()
    # (d) launch.train: 20 steps, then a restart from step 10's checkpoint
    first_dir, second_dir = tmp_dir / "resume_a", tmp_dir / "resume_b"
    first = resume_run(first_dir)
    second_dir.mkdir()
    shutil.copytree(first_dir / f"step_{RESUME_AT:08d}",
                    second_dir / f"step_{RESUME_AT:08d}")
    second = resume_run(second_dir)
    check(first["start"] == 0 and len(first["losses"]) == RESUME_STEPS,
          f"the first run took {len(first['losses'])} steps from {first['start']}")
    check(second["start"] == RESUME_AT
          and second["losses"] == first["losses"][RESUME_AT:],
          f"the resumed run's losses {second['losses']} differ from the "
          f"uninterrupted run's {first['losses'][RESUME_AT:]}")
    head, tail = first["losses"][:5], first["losses"][-5:]
    check(all(map(math.isfinite, first["losses"]))
          and statistics.mean(tail) < statistics.mean(head),
          f"xlstm-125m loss did not fall (the last five steps' mean against "
          f"the first five's): {first['losses']}")
    out["resume"] = {"arch": "xlstm-125m", "steps": RESUME_STEPS,
                     "checkpoint_at": RESUME_AT, "lr": RESUME_LR,
                     "losses": first["losses"],
                     "first_five_mean": statistics.mean(head),
                     "last_five_mean": statistics.mean(tail),
                     "resumed_losses_equal": True,
                     "step_seconds_median": statistics.median(first["step_s"]),
                     "k5_launches": {"uninterrupted": first["k5_launches"],
                                     "resumed": second["k5_launches"]}}
    # (e) the optimizer learns: the train step on one repeated batch
    ocfg = ARCHS["xlstm-125m"].with_(conv_impl="fused")
    model = lm_mod.LM(ocfg)
    params = launch_serve.init_params(ocfg, seed, DEVICE)
    data = SyntheticLMData(ocfg, *OVERFIT_SHAPE, seed=seed, device=DEVICE)
    batches = [data.next_batch() for _ in range(OVERFIT_BATCHES)]
    with torch.no_grad(), f32_accumulation():
        initial = [float(steps_lib.make_loss_fn(model)(params, b)[0])
                   for b in batches]
    spread = statistics.pstdev(initial)
    step = steps_lib.make_train_step(model, AdamWConfig(
        lr=RESUME_LR, warmup_steps=2, total_steps=OVERFIT_STEPS))
    opt = steps_lib.init_opt_state(params)
    losses = []
    with f32_accumulation():
        for _ in range(OVERFIT_STEPS):
            params, opt, met = step(params, opt, batches[0])
            losses.append(float(met["loss"]))
    fall = losses[0] - losses[-1]
    check(all(map(math.isfinite, losses)) and fall >= OVERFIT_SPREADS * spread,
          f"xlstm-125m on one repeated batch: the loss fell {fall} "
          f"({losses}), not {OVERFIT_SPREADS} x the batches' spread {spread}")
    out["repeated_batch"] = {"arch": "xlstm-125m", "shape": list(OVERFIT_SHAPE),
                             "lr": RESUME_LR, "losses": losses, "fall": fall,
                             "initial_losses": initial, "spread": spread,
                             "fall_over_spread": fall / spread}
    del params, opt, data, batches, step, met
    free_card()
    out["phase_seconds"] = round(time.perf_counter() - t_phase, 3)
    emit(out)
    return out


# ---------------------------------------------------------------- 6i. dist
# Distributed execution on ranks that share the one card: NCCL refuses two
# ranks on one device, so the ranks are processes under gloo, collectives
# staged through host memory.  The rank bodies below are module-level so
# launch.mesh.spawn can send them to fresh processes (which import this
# file as their main module, without running main()).

DIST_WORLD = 4
DIST_BACKEND = "gloo"
DIST_TIMEOUT_S = 180          # a collective's wait for a peer
DIST_JOIN_S = 900             # a spawn's whole run
DIST_ALGOS = ("mec_fused", "mec_lowered")
DIST_K4_SPLIT = 2             # K4 (mec_fused2) joins the 2-rank splits
# the precision-flow cells: a declared precision over the kernels' and the
# plain bodies, f32 and bf16 (analysis.shardcheck / numcheck)
DIST_PRECISION_ALGOS = ("mec_fused", "mec_fused2", "mec_lowered", "mec")
DIST_PRECISION_DTYPES = ("float32", "bfloat16")
DIST_COMPOSITE_BATCH = 8
DIST_LM_ARCH = "xlstm-125m"
DIST_LM_STEPS = 4             # 10 before the tp phase, 6 before the
                              # shardcheck suite; cut for the time limit
DIST_LM_ARGS = ["--global-batch", "8", "--seq-len", "128", "--lr", "5e-4",
                "--conv-impl", "fused", "--log-every", "5"]
DIST_LM_GAP = 0.35            # tests/test_distribution.py:119
DIST_GRAD_LAYERS = 4          # xlstm-125m at full width, f32, for the
DIST_GRAD_BATCH = (4, 64)     # data-parallel gradient check
DIST_GRAD_TOL = 1e-5
DIST_INT8_TOL = 1e-6          # the int8 reduction against its f64 formula
DIST_OVERFIT_STEPS = 6
PIPE_SHAPE = (8, 16, 12)      # tests/test_pipeline.py: L, D, B
PIPE_TOLS = (1e-5, 1e-4)


def dist_table2_cases():
    """(layer, batch, partition, n_dev, mesh shape, mesh axes, algorithm):
    Table 2 at batch 1 under spatial and channel over 2 and 4 ranks where
    viable (K4 too on the 2-rank splits), and at batch 8 under the three
    composites over 2 x 2."""
    from repro_torch.bench.scenarios import CV_LAYERS, layer_spec
    from repro_torch.parallel.conv import (COMPOSITE_PARTITIONS,
                                           partition_viable)
    cases = []
    for name in CV_LAYERS:
        spec = layer_spec(name)
        for part in ("spatial", "channel"):
            for n in (2, 4):
                if partition_viable(spec, part, n):
                    algs = DIST_ALGOS + (("mec_fused2",)
                                         if n == DIST_K4_SPLIT else ())
                    cases += [(name, 1, part, n, (n,), ("data",), alg)
                              for alg in algs]
        spec8 = layer_spec(name, batch=DIST_COMPOSITE_BATCH)
        for comp in COMPOSITE_PARTITIONS:
            if partition_viable(spec8, comp, (2, 2)):
                cases += [(name, DIST_COMPOSITE_BATCH, comp, (2, 2), (2, 2),
                           ("data", "model"), alg) for alg in DIST_ALGOS]
    return cases


def _scaled(a, ref) -> float:
    return float((a.double() - ref.double()).abs().max()
                 / ref.double().abs().max().clamp_min(1e-30))


def _checksum(*ts) -> list:
    return [float(t.double().sum()) for t in ts]


class BodyAudit:
    """Wraps ``parallel.conv._single_device``, the body every rank runs
    inside ``sharded_conv2d``, so that its own call is measured: the
    operands it receives (after the shard, the halo concat and the
    staging) and the bytes a call on them requests (memaudit's
    measurement, ``_temp_bytes``: the second of two calls without
    autograd, on detached copies of those operands).  The body then runs
    as it would."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.analysis.memaudit import _temp_bytes
        from repro_torch.parallel import conv as pconv
        self._mod, self._real = pconv, pconv._single_device
        real = self._real

        def audited(x, kernel, stride, algorithm, solution):
            xd, kd = x.detach(), kernel.detach()
            with torch.no_grad():
                temp = _temp_bytes(lambda: real(xd, kd, stride, algorithm,
                                                solution))[0]
            self.calls.append({"x": tuple(x.shape), "k": tuple(kernel.shape),
                               "stride": tuple(stride), "temp_bytes": temp,
                               "x_bytes": x.numel() * x.element_size()})
            return real(x, kernel, stride, algorithm, solution)

        pconv._single_device = audited
        return self

    def __exit__(self, *exc):
        self._mod._single_device = self._real


def dist_table2_rank(seed: int) -> list:
    """Every Table-2 case on this rank, through ``check_sharding``
    (``analysis.shardcheck``): the collective contract counted on the
    ranks, exact per kind at the busiest rank; output and gradients of
    its ``sum(out^2)`` probe against the single-device conv (rank 0); the
    body's requested bytes against Eq. 3 on the local geometry.  Every
    rank takes part in each case (the check gathers the counts over the
    world); a rank outside the case's mesh records None."""
    import torch.distributed as dist
    from repro_torch.analysis.memaudit import gate
    from repro_torch.analysis.shardcheck import check_sharding
    from repro_torch.bench.scenarios import CV_LAYERS
    from repro_torch.core import memory
    from repro_torch.core.conv_api import conv2d
    from repro_torch.core.convspec import spec_of
    from repro_torch.core.numerics import fwd_tolerance, grad_tolerance
    from repro_torch.launch.costmodel import conv_partition_costs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.conv import normalize_partition
    rank = dist.get_rank()
    meshes, out = {}, []
    for i, (name, batch, part, n_dev, shape, axes, alg) in \
            enumerate(dist_table2_cases()):
        if (shape, axes) not in meshes:
            meshes[(shape, axes)] = make_host_mesh(shape=shape, axes=axes)
        mesh = meshes[(shape, axes)]
        ih, iw, ic, kh, kw, kc, s = CV_LAYERS[name]
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(seed + i)
        x = torch.randn((batch, ih, iw, ic), generator=gen, device=DEVICE)
        k = torch.randn((kh, kw, ic, kc), generator=gen,
                        device=DEVICE) * (kh * kw * ic) ** -0.5
        spec = spec_of(x, k, (s, s))
        with BodyAudit() as audit:
            chk = check_sharding(spec, part, mesh=mesh, axes=axes[:len(
                normalize_partition(part))], algorithm=alg,
                device=DEVICE, operands=(x, k))
        torch.cuda.synchronize()
        if chk.outputs is None:
            out.append(None)
            continue
        y, dx, dk = chk.outputs
        parts = normalize_partition(part)
        cost = conv_partition_costs(spec, n_dev)[
            parts if len(parts) > 1 else parts[0]]
        # the body's own call: its operands and requested bytes
        check(len(audit.calls) == 1,
              f"dist {name}/{part}/{alg}: the body ran "
              f"{len(audit.calls)} times")
        body = audit.calls[0]
        lspec = spec_of(torch.empty(body["x"], device="meta"),
                        torch.empty(body["k"], device="meta"),
                        body["stride"])
        temp = body["temp_bytes"]
        predicted = memory.algorithm_overhead(lspec, alg) * 4
        verdict, fails = gate(f"dist/{name}/{part}", alg, predicted, temp)
        rec = {"case": i, "layer": name, "batch": batch,
               "partition": "+".join(parts), "n_dev": n_dev,
               "algorithm": alg,
               "shardcheck": {k_: chk.record[k_] for k_ in (
                   "verdict", "violations", "directions", "precision_flow")},
               "halo_bytes_model": cost["halo_bytes_per_device"],
               "bwd_bytes_model": cost["comm_bytes_bwd_per_device"],
               "local_spec": [lspec.i_n, lspec.i_h, lspec.i_w, lspec.i_c,
                              lspec.k_c],
               "temp_bytes": temp, "predicted_bytes": predicted,
               "eq3_bytes": cost["per_device_overhead_elems"] * 4,
               "halo_concat_bytes": (body["x_bytes"]
                                     if "spatial" in parts else 0),
               "memory_verdict": verdict["verdict"], "memory_fails": fails,
               "checksum": _checksum(y, dx, dk)}
        if rank == 0:
            xr, kr = x.clone().requires_grad_(), k.clone().requires_grad_()
            yr = conv2d(xr, kr, stride=s, algorithm=alg, partition="none")
            (yr * yr).sum().backward()
            rec.update(
                fwd_err=_scaled(y, yr.detach()),
                dx_err=_scaled(dx, xr.grad),
                dk_err=_scaled(dk, kr.grad),
                equal_bits=bool(torch.equal(y, yr.detach())),
                fwd_tol=fwd_tolerance(alg, "float32", kh * kw * ic),
                dx_tol=grad_tolerance(alg, "float32", kh * kw * kc),
                dk_tol=grad_tolerance(alg, "float32",
                                      batch * spec.o_h * spec.o_w))
        out.append(rec)
        del x, k, y, dx, dk, chk
    return out


def dist_precision_rank() -> list:
    """The precision flow under a declared ``HIGHEST`` precision, f32 and
    bf16, over the kernels' bodies and the plain one, on the smoke spatial
    cell over 2 ranks (every rank takes part): each record's verdict and
    tally."""
    from repro_torch.analysis.shardcheck import check_sharding
    from repro_torch.core.convspec import ConvSpec
    spec = ConvSpec(2, 16, 16, 8, 3, 3, 16, 1, 1)
    out = []
    for dtype in DIST_PRECISION_DTYPES:
        for alg in DIST_PRECISION_ALGOS:
            rec = check_sharding(spec, "spatial", 2, dtype=dtype,
                                 algorithm=alg, precision="HIGHEST",
                                 device=DEVICE).record
            out.append({"dtype": dtype, "algorithm": alg,
                        "verdict": rec["verdict"],
                        "violations": rec["violations"],
                        "precision_flow": rec["precision_flow"]})
    return out


def dist_stack_rank(seed: int) -> dict:
    """The ResNet-101 Table-3 stack (34 convs, batch 16) under
    ``partition="auto"`` on a 2 x 2 mesh, f32 and bf16, through
    rules-aware ``conv2d``: picks, plans and errors against the
    single-device stack (rank 0)."""
    import torch.distributed as dist
    from repro_torch.bench.scenarios import CV_LAYERS
    from repro_torch.bench.scenarios import RESNET101_WEIGHTS as RESNET101
    from repro_torch.core.conv_api import conv2d, conv2d_spec
    from repro_torch.core.numerics import fwd_tolerance
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.axes import default_rules, use_rules
    from repro_torch.parallel.conv import partition_name
    from repro_torch.plan import plan_conv2d
    rules = default_rules(make_host_mesh(shape=(2, 2),
                                         axes=("data", "model")))
    rank = dist.get_rank()
    out = {}
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(seed)
        worst, picks, plans, convs = 0.0, {}, {}, 0
        for name, count in RESNET101.items():
            ih, iw, ic, kh, kw, kc, s = CV_LAYERS[name]
            x = torch.randn((SLICE_BATCH, ih, iw, ic), generator=gen,
                            device=DEVICE).to(dtype)
            for _ in range(count):
                w = (torch.randn((kh, kw, ic, kc), generator=gen,
                                 device=DEVICE)
                     * (kh * kw * ic) ** -0.5).to(dtype)
                with use_rules(rules), torch.no_grad():
                    y = conv2d(x, w, stride=s)
                    if name not in plans:
                        plan = plan_conv2d(conv2d_spec(x, w, stride=s),
                                           dtype=dname, backend="cuda",
                                           partition="auto")
                        picks[name] = (partition_name(plan.partition)
                                       if plan.partition else None)
                        plans[name] = plan.explain() if rank == 0 else None
                if rank == 0:
                    with torch.no_grad():
                        ref = conv2d(x, w, stride=s, partition="none")
                    err = _scaled(y, ref)
                    check(err <= fwd_tolerance("mec_fused", dname,
                                               kh * kw * ic),
                          f"dist stack {name} {dname}: sharded against one "
                          f"device {err}")
                    worst = max(worst, err)
                convs += 1
                del y
        out[dname] = {"convs": convs, "picks": picks, "plans": plans,
                      "max_scaled_err": worst}
    return out


def dist_pipeline_rank(seed: int) -> dict:
    """GPipe: 4 stages on the 4 ranks, 4 microbatches, against the
    sequential stack on this rank."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.pipeline import pipeline_apply
    n_layers, width, batch = PIPE_SHAPE
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    w = torch.randn((n_layers, width, width), generator=gen,
                    device=DEVICE) * width ** -0.5
    b = torch.randn((n_layers, width), generator=gen, device=DEVICE) * 0.1
    x = torch.randn((batch, width), generator=gen, device=DEVICE)

    def block(p, h):
        return torch.tanh(h @ p["w"] + p["b"]) + h

    mesh = make_host_mesh(shape=(dist.get_world_size(),), axes=("pipe",))
    p1 = {"w": w.clone().requires_grad_(), "b": b.clone().requires_grad_()}
    x1 = x.clone().requires_grad_()
    out = pipeline_apply(block, p1, x1, mesh, "pipe", 4)
    (out ** 2).sum().backward()
    p2 = {"w": w.clone().requires_grad_(), "b": b.clone().requires_grad_()}
    x2 = x.clone().requires_grad_()
    h = x2
    for i in range(n_layers):
        h = block({"w": p2["w"][i], "b": p2["b"][i]}, h)
    (h ** 2).sum().backward()
    err = float((out - h).detach().abs().max())
    gerr = max(float((a.grad - c.grad).abs().max())
               for a, c in ((x1, x2), (p1["w"], p2["w"]), (p1["b"], p2["b"])))
    return {"err": err, "gerr": gerr}


def dist_rank_main(seed: int) -> dict:
    """The 4-rank body of the dist phase."""
    import torch.distributed as dist
    from repro_torch.bench import harness
    from repro_torch.kernels import mec_conv as K
    from repro_torch.parallel import comm
    entered = time.time()
    rank = dist.get_rank()
    K.reset_launch_counts()
    staged0 = comm.stage_to_host.bytes + comm.stage_to_device.bytes
    t0 = time.perf_counter()
    table2 = dist_table2_rank(seed)
    t_table2 = time.perf_counter() - t0
    table2_launches = K.launch_counts()
    precision = dist_precision_rank()
    stack = dist_stack_rank(seed)
    t_stack = time.perf_counter() - t0 - t_table2
    K.reset_launch_counts()
    # Four ranks share the card and a host-staged wire: the Table-2
    # cells' times would be the wire's, and the table2 cases above
    # already run those geometries; they keep their analytics.
    suite = harness.run_suite("dist", iters=3, device="cuda",
                              time_only="smoke*")
    suite_launches = K.launch_counts()
    gpipe = dist_pipeline_rank(seed)
    return {"rank": rank, "entered": entered,
            "backend": dist.get_backend(), "world": dist.get_world_size(),
            "device": str(torch.cuda.current_device()),
            "table2": table2, "table2_launches": table2_launches,
            "precision": precision,
            "table2_s": t_table2, "stack": stack, "stack_s": t_stack,
            "suite": suite if rank == 0 else None,
            "suite_launches": suite_launches, "gpipe": gpipe,
            "staged_bytes": (comm.stage_to_host.bytes
                             + comm.stage_to_device.bytes - staged0)}


def dist_dp_rank(seed: int) -> dict:
    """Two ranks: one data-parallel gradient of xlstm-125m (full width,
    DIST_GRAD_LAYERS layers, f32, K5) against the single-rank gradient of
    the whole batch (rank 0), then the compressed step on one repeated
    batch."""
    import torch.distributed as dist
    from repro_torch.configs.archs import ARCHS
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import mec_conv1d as C
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamWConfig, tree_leaves
    from repro_torch.parallel.axes import default_rules
    from repro_torch.training import steps
    cfg = ARCHS[DIST_LM_ARCH].with_(n_layers=DIST_GRAD_LAYERS,
                                    dtype="float32", conv_impl="fused")
    model = LM(cfg)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    params = model.init(gen, device=DEVICE)
    rules = default_rules(make_host_mesh())
    rank, world = dist.get_rank(), dist.get_world_size()
    batch, seq = DIST_GRAD_BATCH
    local = SyntheticLMData(cfg, batch, seq, host_id=rank, num_hosts=world,
                            device=DEVICE).next_batch()
    k5 = C.mec_conv1d.launches
    loss2, _, grads2 = steps.make_grad_fn(model, rules)(params, local)
    out = {"rank": rank, "k5_launches_dp_grad": C.mec_conv1d.launches - k5}
    if rank == 0:
        whole = SyntheticLMData(cfg, batch, seq, device=DEVICE).next_batch()
        loss1, _, grads1 = steps.make_grad_fn(model)(params, whole)
        errs = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for a, b in zip(tree_leaves(grads2), tree_leaves(grads1))]
        out.update(loss_dp=float(loss2), loss_one=float(loss1),
                   max_leaf_err=max(errs), leaves=len(errs))
    del grads2
    out.update(int8_reduction_errors(seed))
    step = steps.make_compressed_train_step(
        model, AdamWConfig(lr=1e-3, total_steps=DIST_OVERFIT_STEPS,
                           warmup_steps=1), rules)
    opt = steps.init_opt_state(params, compressed=True)
    losses = []
    for _ in range(DIST_OVERFIT_STEPS):
        params, opt, m = step(params, opt, local)
        losses.append(float(m["loss"]))
    out["repeated_batch_losses"] = losses
    return out


def _int8_case(seed: int, rank: int):
    """Rank ``rank``'s seeded gradient and ef trees on the card, its
    gradients at 10**rank times the scale of rank 0's."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 100 + rank)
    g = {"a": torch.randn((257, 33), generator=gen, device=DEVICE),
         "b": torch.randn((1000,), generator=gen, device=DEVICE)}
    g = {k: v * 10.0 ** rank for k, v in g.items()}
    e = {k: torch.randn(v.shape, generator=gen, device=DEVICE) * 0.01
         for k, v in g.items()}
    return g, e


def int8_reduction_errors(seed: int) -> dict:
    """``compression.compressed_psum`` over the world on the card, against
    its formula on rank 0 (every rank's seeded trees regenerated there;
    the int8 values and scales in f32 as the JAX package makes them, the
    mean over ranks and the ef in f64): the mean over ranks of each rank's
    per-leaf int8 quantisation of its folded gradient, and rank 0's new
    ef.  Largest errors scaled by each leaf's largest |value| (of the
    folded gradient for the ef)."""
    import torch.distributed as dist
    from repro_torch.parallel import compression
    rank, world = dist.get_rank(), dist.get_world_size()
    g, e = _int8_case(seed, rank)
    reduced, new_ef = compression.compressed_psum(g, e)
    if rank:
        return {}
    errs = {"int8_reduce_err": 0.0, "int8_ef_err": 0.0}
    for name in g:
        total, own = 0.0, None
        for r in range(world):
            gr, er = _int8_case(seed, r)
            folded = gr[name] + er[name]
            scale = folded.abs().max() / 127.0 + 1e-12
            q = torch.clamp(torch.round(folded / scale), -127, 127)
            deq = q.double() * scale.double()
            total = total + deq
            if r == 0:
                own = (folded.double(), folded.double() - deq)
        ref = total / world
        errs["int8_reduce_err"] = max(errs["int8_reduce_err"], float(
            (reduced[name].double() - ref).abs().max() / ref.abs().max()))
        errs["int8_ef_err"] = max(errs["int8_ef_err"], float(
            (new_ef[name].double() - own[1]).abs().max()
            / own[0].abs().max()))
    return errs


def dist_nccl_rank(seed: int) -> dict:
    """NCCL at world size 1: an all-reduce and ``sharded_conv2d`` over a
    1-way mesh against the single-device conv, to the bit."""
    import torch.distributed as dist
    from repro_torch.core.conv_api import conv2d
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.conv import sharded_conv2d
    t = torch.full((4,), 3.0, device=DEVICE)
    dist.all_reduce(t)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    x = torch.randn((2, 56, 56, 64), generator=gen, device=DEVICE)
    k = torch.randn((3, 3, 64, 64), generator=gen, device=DEVICE) / 24.0
    mesh = make_host_mesh()
    equal = {}
    for part in ("batch", "channel"):
        y = sharded_conv2d(x, k, algorithm="mec_fused", partition=part,
                           mesh=mesh)
        equal[part] = bool(torch.equal(
            y, conv2d(x, k, algorithm="mec_fused", partition="none")))
    return {"backend": dist.get_backend(), "all_reduce": t.tolist(),
            "equal_bits": equal}


class Background(threading.Thread):
    """``fn()`` in a thread from construction; :meth:`result` joins it and
    returns its value or raises its exception."""

    def __init__(self, fn):
        super().__init__(daemon=True)
        self.fn, self.value, self.error = fn, None, None
        self.start()

    def run(self):
        try:
            self.value = self.fn()
        except BaseException as e:  # raised again in the caller's thread
            self.error = e

    def result(self):
        self.join()
        if self.error is not None:
            raise self.error
        return self.value


def start_dist_lm(compress: bool) -> dict:
    """Start ``launch.train --mesh host`` on xlstm-125m at full size
    through ``torch.distributed.run`` over 2 ranks sharing the card
    (gloo), in the background (each ``--standalone`` run takes a free
    port of its own); :func:`finish_dist_lm` collects it."""
    logs = Path(tempfile.mkdtemp(prefix="dist-lm-"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "--log-dir", str(logs), "--redirects",
           "1", "-m", "repro_torch.launch.train",
           "--arch", DIST_LM_ARCH, "--mesh", "host", "--backend",
           DIST_BACKEND, "--steps", str(DIST_LM_STEPS), *DIST_LM_ARGS]
    if compress:
        cmd.append("--compress-grads")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    err = open(logs / "torchrun.err", "w")
    proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=err,
                            env=env, cwd=ROOT)
    err.close()
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return {"proc": proc, "logs": logs, "compress": compress,
            "t0": time.perf_counter()}


def finish_dist_lm(run: dict) -> list:
    """Wait for a :func:`start_dist_lm` run: each rank's summary line, read
    from the rank's own standard output file (two ranks writing one pipe
    can interleave their lines)."""
    try:
        rc = run["proc"].wait(timeout=600)
    except subprocess.TimeoutExpired:
        run["proc"].kill()
        rc = run["proc"].wait()
    wall = time.perf_counter() - run["t0"]
    logs = run["logs"]
    outs = sorted(logs.rglob("stdout.log"))
    texts = [out.read_text() for out in outs]
    err = (logs / "torchrun.err").read_text()
    shutil.rmtree(logs, ignore_errors=True)
    print(*(t[-3000:] for t in texts), err[-4000:], sep="\n",
          file=sys.stderr)
    check(rc == 0, f"torchrun launch.train (compress={run['compress']}) "
                   f"exited {rc}")
    lines = [json.loads(ln.split("summary ", 1)[1])
             for text in texts for ln in text.splitlines()
             if ln.startswith("[train] summary ")]
    check(sorted(s["rank"] for s in lines) == [0, 1],
          f"torchrun launch.train printed {len(lines)} rank summaries")
    for s in lines:
        s["wall_s"] = wall
    return sorted(lines, key=lambda s: s["rank"])


def shardcheck_suite_rank(dist_path: str) -> dict:
    """One rank of ``--suite shardcheck``: every cell's record and this
    rank's kernel launches."""
    from repro_torch.analysis.shardcheck import suite_cells, suite_rank
    from repro_torch.kernels import mec_conv as K
    K.reset_launch_counts()
    t0 = time.perf_counter()
    results = suite_rank(suite_cells(dist_path), DEVICE)
    return {"results": results, "launches": K.launch_counts(),
            "seconds": time.perf_counter() - t0}


def dist_shardcheck_suite() -> dict:
    """``python -m repro_torch.analysis --suite shardcheck`` over the dist
    baseline on 8 gloo ranks sharing cuda:0 (its largest cell's ranks):
    verdicts and skip reasons equal to the committed
    ``BENCH_shardcheck.json`` cell by cell, none failing.  Returns the
    ranks' kernel launches."""
    import json as json_mod
    from repro_torch.analysis.shardcheck import SHARDCHECK_MAX_RANKS
    from repro_torch.launch.mesh import spawn
    dist_path = str(ROOT / "benchmarks" / "baselines" / "dist.json")
    t0 = time.perf_counter()
    ranks = spawn(shardcheck_suite_rank, SHARDCHECK_MAX_RANKS,
                  args=(dist_path,), backend=DIST_BACKEND, device="cuda",
                  timeout_s=DIST_TIMEOUT_S, join_timeout_s=DIST_JOIN_S)
    mine = ranks[0]["results"]
    ref = json_mod.loads((ROOT / "BENCH_shardcheck.json").read_text())[
        "results"]
    check(len(mine) == len(ref) == 65, f"shardcheck: {len(mine)} cells")
    differ = [f"{a['scenario']}/{a['algorithm']}: {a['verdict']} "
              f"({a['skipped_reason']}) against {b['verdict']}"
              for a, b in zip(mine, ref)
              if (a["verdict"], a["skipped_reason"])
              != (b["verdict"], b["skipped_reason"])]
    failed = [f"{a['scenario']}/{a['algorithm']}: {a['violations']}"
              for a in mine if a["verdict"] == "fail"]
    check(not failed, f"shardcheck suite failures: {failed}")
    check(not differ, f"shardcheck verdicts against BENCH_shardcheck.json: "
                      f"{differ}")
    counts = {v: sum(a["verdict"] == v for a in mine)
              for v in ("pass", "skipped", "fail")}
    emit({"phase": "dist", "step": "shardcheck_suite", "ranks": len(ranks),
          "verdicts": counts,
          "busiest_grad_bytes": {
              f"{a['scenario']}/{a['algorithm']}":
                  a["directions"]["grad"]["observed"]
              for a in mine if a["verdict"] == "pass"},
          "precision_flow": [a["precision_flow"] for a in mine
                             if a["verdict"] == "pass"][:1],
          "seconds": time.perf_counter() - t0,
          "rank_seconds": max(r["seconds"] for r in ranks)})
    return {n: sum(r["launches"][n] for r in ranks)
            for n in ranks[0]["launches"]}


def dist_phase(seed: int) -> dict:
    """Phase 6i; returns each kernel's launches on the ranks."""
    import json as json_mod
    from repro_torch.bench import check as bench_check
    from repro_torch.launch.mesh import spawn
    free_card()
    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    emit({"phase": "dist", "step": "world", "backend": DIST_BACKEND,
          "world_size": DIST_WORLD, "cards": cards,
          "ranks_per_card": DIST_WORLD / cards,
          "why": "NCCL refuses two ranks on one device; gloo stages "
                 "collectives through host memory; one card shows no "
                 "scaling"})
    # NCCL refuses more ranks than cards: a choice, never a fallback.
    try:
        spawn(dist_nccl_rank, cards + 1, args=(seed,), backend="nccl",
              device="cuda")
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused is not None and "--backend gloo" in refused,
          f"nccl over {cards + 1} ranks on {cards} card(s) did not raise")
    nccl = spawn(dist_nccl_rank, 1, args=(seed,), backend="nccl",
                 device="cuda", timeout_s=DIST_TIMEOUT_S,
                 join_timeout_s=300)[0]
    check(nccl["backend"] == "nccl" and nccl["all_reduce"] == [3.0] * 4
          and all(nccl["equal_bits"].values()),
          f"NCCL at world size 1: {nccl}")
    emit({"phase": "dist", "step": "nccl_world1", **nccl,
          "refused_two_ranks": refused})

    # the launcher's two runs and the shardcheck suite's 8 ranks go on
    # beside the phase's ranks (nothing of the phase is timed against a
    # limit)
    lm_runs = [start_dist_lm(False), start_dist_lm(True)]
    shardcheck_bg = Background(dist_shardcheck_suite)
    t_spawn = time.time()
    ranks = spawn(dist_rank_main, DIST_WORLD, args=(seed,),
                  backend=DIST_BACKEND, device="cuda",
                  timeout_s=DIST_TIMEOUT_S, join_timeout_s=DIST_JOIN_S)
    spawn_init_s = max(r["entered"] for r in ranks) - t_spawn
    check(all(r["backend"] == DIST_BACKEND and r["world"] == DIST_WORLD
              and r["device"] == "0" for r in ranks),
          f"ranks: {[(r['backend'], r['world'], r['device']) for r in ranks]}")
    # Table 2 under every viable partition
    cases = dist_table2_cases()
    worst = {"fwd": 0.0, "dx": 0.0, "dk": 0.0}
    bits = {}
    for i, case in enumerate(cases):
        recs = [r["table2"][i] for r in ranks if r["table2"][i] is not None]
        lead = recs[0]
        tag = f"dist {case[0]} b{case[1]} {lead['partition']} {case[3]} {case[6]}"
        check(len(recs) == math.prod(case[4]), f"{tag}: {len(recs)} ranks ran")
        for f in ("fwd", "dx", "dk"):
            check(lead[f"{f}_err"] <= lead[f"{f}_tol"],
                  f"{tag}: {f} scaled error {lead[f + '_err']} > "
                  f"{lead[f + '_tol']}")
            worst[f] = max(worst[f], lead[f"{f}_err"])
        check(all(r["checksum"] == lead["checksum"] for r in recs),
              f"{tag}: ranks returned different global answers")
        # the collective contract, exact per kind at the busiest rank
        # (check_sharding); every rank computed the same record
        sc = lead["shardcheck"]
        check(sc["verdict"] == "pass", f"{tag}: shardcheck {sc['violations']}")
        check(all(r["shardcheck"] == sc for r in recs),
              f"{tag}: the ranks' shardcheck records differ")
        fwd_b = sc["directions"]["fwd"]["observed"]["collective-permute"]
        grad = sc["directions"]["grad"]["observed"]
        check(fwd_b == lead["halo_bytes_model"],
              f"{tag}: halo sent {fwd_b} B, cost model "
              f"{lead['halo_bytes_model']} B")
        check(grad["all-reduce"]
              == lead["bwd_bytes_model"] - lead["halo_bytes_model"],
              f"{tag}: cotangent sums {grad['all-reduce']} B, cost model "
              f"{lead['bwd_bytes_model'] - lead['halo_bytes_model']} B")
        for r in recs:
            check(r["memory_verdict"] == "pass",
                  f"{tag} rank memory: {r['memory_fails']}")
            if case[6] == "mec_lowered":
                check(r["predicted_bytes"] == r["eq3_bytes"],
                      f"{tag}: local Eq. 3 {r['predicted_bytes']} != the "
                      f"cost model's {r['eq3_bytes']}")
        if "batch" in lead["partition"]:
            bits[f"{case[0]}/{lead['partition']}/{case[6]}"] = \
                lead["equal_bits"]
        emit({"phase": "dist", "step": "table2", "layer": case[0],
              "batch": case[1], "partition": lead["partition"],
              "n_dev": case[3], "algorithm": case[6],
              "fwd_err": lead["fwd_err"], "dx_err": lead["dx_err"],
              "dk_err": lead["dk_err"], "equal_bits": lead["equal_bits"],
              "halo_bytes": fwd_b, "grad_observed": grad,
              "rank_temp_bytes": [r["temp_bytes"] for r in recs],
              "eq3_bytes": lead["eq3_bytes"],
              "halo_concat_bytes": lead["halo_concat_bytes"],
              "local_spec": lead["local_spec"]})
    for name, k in (("mec_conv_fused", "K1"), ("mec_lower", "K2"),
                    ("mec_gemm", "K3")):
        check(all(r["table2_launches"][name] > 0 for r in ranks),
              f"{k} did not launch in every rank's body")
    # K4 runs on the 2-rank splits: the world's first two ranks
    check(all(r["table2_launches"]["mec_conv_fused2"] > 0
              for r in ranks[:DIST_K4_SPLIT]),
          "K4 did not launch in the 2-rank splits' bodies")
    # the precision flow under a declared HIGHEST, f32 and bf16
    for rec in ranks[0]["precision"]:
        check(rec["verdict"] == "pass"
              and rec["precision_flow"]["unannotated_dot_ops"] == 0,
              f"dist precision flow {rec['dtype']}/{rec['algorithm']}: "
              f"{rec['violations']}")
    emit({"phase": "dist", "step": "precision_flow",
          "cells": ranks[0]["precision"]})
    emit({"phase": "dist", "step": "table2_summary", "cases": len(cases),
          "max_scaled_err": worst, "batch_equal_bits": bits,
          "seconds": max(r["table2_s"] for r in ranks),
          "launches": [r["table2_launches"] for r in ranks]})
    # the ResNet-101 stack under partition="auto"
    stack = ranks[0]["stack"]
    check(all(stack[d]["convs"] == 34 for d in stack),
          f"the stack ran {[stack[d]['convs'] for d in stack]} convs")
    emit({"phase": "dist", "step": "resnet101_auto",
          "seconds": max(r["stack_s"] for r in ranks), **stack})
    # the dist bench suite
    suite = ranks[0]["suite"]
    base = json_mod.loads((ROOT / "benchmarks" / "baselines" /
                           "dist.json").read_text())
    check(len(suite["results"]) == len(base["results"]) == 65,
          f"dist suite: {len(suite['results'])} records")
    exact = ("partition", "n_dev", "n_dev_axes", "halo_bytes_per_device",
             "per_device_overhead_elems", "comm_bytes_per_device",
             "auto_partition")
    for mine, ref in zip(suite["results"], base["results"]):
        for f in exact:
            check(mine[f] == ref[f],
                  f"dist suite {mine['scenario']}: {f} {mine[f]} != "
                  f"{ref[f]}")
        check((mine["us_per_call"] is not None)
              == mine["scenario"].startswith("smoke"),
              f"dist suite {mine['scenario']}: timed {mine['us_per_call']}")
    fails, _ = bench_check.compare(suite, base, schema_only_on_timing=True)
    extra = [f for f in fails if not any(
        k in f for k in ("shardcheck", "run_spec", "out_shape", "run_flops"))]
    check(not extra, f"dist suite against the baseline: {extra}")
    verdicts = {f"{r['scenario']}/{r['algorithm']}": r["shardcheck"]["verdict"]
                for r in suite["results"] if "shardcheck" in r}
    check(len(verdicts) == 12 and set(verdicts.values()) == {"pass"},
          f"dist suite shardcheck fields: {verdicts}")
    emit({"phase": "dist", "step": "bench_dist", "records": 65,
          "smoke_us_on_this_card_not_scaling": {
              f"{r['scenario']}/{r['algorithm']}": r["us_per_call"]
              for r in suite["results"] if r["us_per_call"] is not None},
          "launches": [r["suite_launches"] for r in ranks]})
    # GPipe
    for r in ranks:
        check(r["gpipe"]["err"] < PIPE_TOLS[0]
              and r["gpipe"]["gerr"] < PIPE_TOLS[1],
              f"GPipe rank {r['rank']}: {r['gpipe']}")
    emit({"phase": "dist", "step": "gpipe",
          "per_rank": [r["gpipe"] for r in ranks]})
    shardcheck_launches = shardcheck_bg.result()

    # data-parallel training: the gradient, the repeated batch, the launcher
    dp = spawn(dist_dp_rank, 2, args=(seed,), backend=DIST_BACKEND,
               device="cuda", timeout_s=DIST_TIMEOUT_S,
               join_timeout_s=DIST_JOIN_S)
    check(dp[0]["max_leaf_err"] <= DIST_GRAD_TOL,
          f"data-parallel gradient against the whole batch's: "
          f"{dp[0]['max_leaf_err']}")
    check(dp[0]["int8_reduce_err"] <= DIST_INT8_TOL
          and dp[0]["int8_ef_err"] <= DIST_INT8_TOL,
          f"int8 reduction on the card against its formula: "
          f"{dp[0]['int8_reduce_err']}, ef {dp[0]['int8_ef_err']}")
    for r in dp:
        ls = r["repeated_batch_losses"]
        check(all(math.isfinite(v) for v in ls) and ls[-1] < ls[0],
              f"compressed step on a repeated batch, rank {r['rank']}: {ls}")
    emit({"phase": "dist", "step": "dp_gradient", **dp[0],
          "rank1_losses": dp[1]["repeated_batch_losses"]})
    plain, comp = (finish_dist_lm(run) for run in lm_runs)
    for run, label in ((plain, "plain"), (comp, "compressed")):
        for s in run:
            check(all(math.isfinite(v) for v in s["losses"]),
                  f"{label} rank {s['rank']}: {s['losses']}")
            check(s["k5_launches_per_step"] == 24,
                  f"{label} rank {s['rank']}: K5 {s['k5_launches_per_step']}"
                  " launches a step, not 24")
            check(s["world"] == 2 and s["backend"] == DIST_BACKEND,
                  f"{label}: {s['world']} ranks on {s['backend']}")
    gap = abs(comp[0]["losses"][-1] - plain[0]["losses"][-1])
    check(gap < DIST_LM_GAP, f"compressed against plain last loss: {gap}")
    emit({"phase": "dist", "step": "lm_train", "arch": DIST_LM_ARCH,
          "steps": DIST_LM_STEPS, "args": DIST_LM_ARGS,
          "plain": plain, "compressed": comp, "last_loss_gap": gap})
    emit({"phase": "dist", "step": "timings",
          "phase_s": time.perf_counter() - t_phase,
          "spawn_init_s": spawn_init_s,
          "dp_staged_bytes_per_step": {
              "plain": plain[0]["staged_bytes_per_step"],
              "compressed": comp[0]["staged_bytes_per_step"]},
          "rank_staged_bytes": [r["staged_bytes"] for r in ranks]})
    launches = {n: sum(r["table2_launches"][n] + r["suite_launches"][n]
                       for r in ranks) + shardcheck_launches[n]
                for n in ranks[0]["table2_launches"]}
    launches["mec_conv1d"] = sum(s["k5_launches_per_step"] * DIST_LM_STEPS
                                 for s in plain + comp)
    return launches



# ---------------------------------------------------------------- tp phase
# Tensor and expert parallelism of the LMs (parallel.tensor): ranks share
# cuda:0 under gloo, as in the dist phase.  The (1, 2) "data" x "model"
# mesh serves and trains at full width; f32 gates at a reduced depth hold
# the ranks to one rank.
TP_MESH = (1, 2)
TP_DENSE = "qwen3-4b"
TP_SERVE_BATCH, TP_SERVE_PROMPT, TP_DECODE = 4, 512, 8
TP_GATE_LAYERS = 4           # f32 gates at full width
TP_GATE_BATCH, TP_GATE_PROMPT = 2, 64
TP_GATE_TOL = 1e-5
TP_ZAMBA_GATE_LAYERS = 7     # one attention segment and a tail layer
TP_ZAMBA_TRAIN_LAYERS = 12   # two attention segments
TP_TRAIN_STEPS = 3
TP_TRAIN_BATCH = (2, 512)
TP_MOE = "qwen3-moe-30b-a3b"
TP_KIMI = "kimi-k2-1t-a32b"
TP_KIMI_LAYERS = 1          # two ranks of 2 layers hold 73.0 GB
TP_MOE_BATCH, TP_MOE_PROMPT = 4, 128
TP_MOE_GATE_TOKENS = (2, 64)
TP_DP_MOE_LAYERS = 2         # 4 layers' f32 gradient and its flat f32
                             # reduction buffer overrun the card on 2 ranks
TP_DP_MOE_BATCH = (4, 64)    # global: 2 rows a rank
TP_XLSTM_STEPS = 3            # 10 before the ZeRO-1 steps joined the phase
TP_XLSTM_BATCH = (8, 64)     # global
TP_XLSTM_GAP = 0.3           # tests/test_distribution.py:169's bar
TP_XLSTM_GRAD_LAYERS = 4
TP_ZERO1_STEPS = 3            # ZeRO-1 steps of xlstm-125m at full size
TP_ZERO1_BATCH = (8, 128)     # global, bf16
TP_ZERO1_GATE_STEPS = 2       # ZeRO-1 against plain, f32, 4 layers
TP_ZERO1_TOL = 1e-5
TP_YI = "yi-6b"
TP_YI_LAYERS = 4
TP_YI_STEPS = 3
TP_SP_RTOL = 2e-4            # tests/test_perf_features.py:35
TP_RESTORE_TOL = 1e-6
TP_RESTORE_LAYERS = 4        # one super-block at full width (12: 32 s)
TP_TIMEOUT_S = 600           # a collective's wait while rank 0 runs alone
# the shapes a rank gives K5 at tp 2: zamba2-7b's xBC (3584 x channels +
# B + C) of its local in_proj output (7352 wide); xlstm-125m's mLSTM x_in
# (768 channels) of its local up output (1536 wide)
ZAMBA2_TP_CONV = (SERVE_BATCH, SERVE_PROMPT, 7352, 3584, 7296)
SSM_TP_CONV = (SSM_BATCH, SSM_PROMPT, 1536, 0, 768)


def _tp_rules(shape):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.axes import default_rules
    return default_rules(make_host_mesh(shape, ("data", "model")))


def _leaf_bytes(tree) -> int:
    return sum(t.nbytes for t in tree_leaves(tree).values())


def _seeded_gen(seed: int):
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    return gen


def tp_gate(cfg, seed: int, rules) -> dict:
    """f32 at reduced depth: the rank-local init against the slice of the
    one-rank init (bits), the rank's bytes against ``local_param_bytes``,
    and the prefill's logits (gathered) against one rank's (rank 0)."""
    import torch.distributed as dist
    from repro_torch.models.lm import LM
    from repro_torch.parallel import tensor
    from repro_torch.parallel.axes import use_rules
    from repro_torch.training import steps
    model = LM(cfg)
    whole = model.init(_seeded_gen(seed), device=DEVICE)
    local = model.init(_seeded_gen(seed), device=DEVICE, mesh=rules.mesh)
    rank = tensor.model_rank(rules.mesh)
    sliced = tensor.shard_params(whole, rules.mesh, cfg, rank)
    a, b = tree_leaves(local), tree_leaves(sliced)
    init_bits = all(torch.equal(a[k], b[k]) for k in a)
    del sliced
    gen = _seeded_gen(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (TP_GATE_BATCH, TP_GATE_PROMPT),
                           generator=gen, device=DEVICE)
    batch = {"tokens": tokens}
    max_len = TP_GATE_PROMPT + 1
    with f32_acc():
        logits, _ = steps.make_prefill_step(model, max_len, rules)(local,
                                                                    batch)
        with use_rules(rules):
            logits = tensor.gather_vocab(logits, model.vocab_tp())
        err = None
        if dist.get_rank() == 0:
            one, _ = steps.make_prefill_step(model, max_len)(whole, batch)
            err = scaled_err(logits, one)
    out = {"init_equals_slice": init_bits, "rank_bytes": _leaf_bytes(local),
           "counted_bytes": tensor.local_param_bytes(whole, rules.mesh, cfg),
           "spec_bytes": tensor.spec_local_bytes(whole, rules.mesh, cfg),
           "logits_err": err, "layers": cfg.n_layers}
    del whole, local
    free_card()
    return out


def fake_params(cfg) -> dict:
    """The model's whole parameter tree as fake tensors (shapes and dtypes,
    no storage)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models.lm import LM
    with FakeTensorMode():
        return LM(cfg).init(torch.Generator(), device="cpu")


def f32_acc():
    from repro_torch.models.layers import f32_accumulation
    return f32_accumulation()


def tp_serve_full(cfg, seed: int, rules, batch: int, prompt: int,
                  gen: int) -> dict:
    """``launch.serve.serve`` on the rank's mesh (bf16, eager decode), its
    K5 launches; then rank 0 serves the same on one rank: the greedy
    tokens of each."""
    import torch.distributed as dist
    from repro_torch.kernels import mec_conv1d as C
    from repro_torch.launch import serve as launch_serve
    free_card()
    torch.cuda.reset_peak_memory_stats()
    C.mec_conv1d.launches = 0
    t0 = time.perf_counter()
    run = launch_serve.serve(cfg, batch=batch, prompt_len=prompt, gen=gen,
                             device=DEVICE, seed=seed, rules=rules)
    out = {"seconds": time.perf_counter() - t0,
           "k5_launches": C.mec_conv1d.launches,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "prefill_s": run["prefill_s"], "decode_s": run["decode_s"],
           "decode_graph": run["decode_graph"], "drops": run["drops"],
           "finite": bool(torch.isfinite(run["logits"]).all())}
    tokens = run["tokens"].cpu()
    del run
    free_card()
    dist.barrier()
    if dist.get_rank() == 0:
        one = launch_serve.serve(cfg, batch=batch, prompt_len=prompt,
                                 gen=gen, device=DEVICE, seed=seed)
        out["tokens_equal_one_rank"] = bool(torch.equal(one["tokens"].cpu(),
                                                        tokens))
        out["tokens_agree"] = float((one["tokens"].cpu() == tokens)
                                    .float().mean())
        del one
        free_card()
    dist.barrier()
    return out


def tp_train(cfg, seed: int, rules, n_steps: int, batch_shape,
             compressed: bool = False, lr: float = 1e-4,
             zero1: bool = False) -> dict:
    """``n_steps`` train steps on the rank's mesh from the rank-local
    init (``zero1``: the ZeRO-1 step, its moments the rank's slices):
    losses, grad norms, K5 launches a step, peak bytes, moment bytes."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import mec_conv1d as C
    from repro_torch.models.lm import LM
    from repro_torch.launch.mesh import axis_sizes
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training import steps
    free_card()
    torch.cuda.reset_peak_memory_stats()
    model = LM(cfg)
    params = model.init(_seeded_gen(seed), device=DEVICE, mesh=rules.mesh)
    opt = steps.init_opt_state(params, compressed=compressed,
                               model=model if zero1 else None,
                               rules=rules if zero1 else None)
    fn = (steps.make_zero1_train_step if zero1
          else steps.make_compressed_train_step if compressed
          else steps.make_train_step)(model, AdamWConfig(
              lr=lr, total_steps=n_steps, warmup_steps=2), rules)
    n_data = axis_sizes(rules.mesh)["data"]
    data = SyntheticLMData(cfg, *batch_shape,
                           host_id=rules.mesh.get_local_rank("data"),
                           num_hosts=n_data, device=DEVICE)
    losses, norms, secs = [], [], []
    C.mec_conv1d.launches = 0
    with f32_acc():
        for _ in range(n_steps):
            t0 = time.perf_counter()
            params, opt, m = fn(params, opt, data.next_batch())
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            secs.append(time.perf_counter() - t0)
    out = {"losses": losses, "grad_norms": norms, "step_s": secs,
           "k5_launches_per_step": C.mec_conv1d.launches / n_steps,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "rank_param_bytes": _leaf_bytes(params),
           "moment_bytes": _leaf_bytes({"m": opt["m"], "v": opt["v"]}),
           "layers": cfg.n_layers}
    del params, opt
    free_card()
    return out


def tp_moe_serve(cfg, seed: int, rules) -> dict:
    """qwen3-moe / kimi-k2 expert parallel on the rank's mesh through the
    prefill and decode steps, with the float and the int8 dispatch on the
    same parameters: the greedy tokens, the all-to-all bytes each sends,
    the peak."""
    from repro_torch.models.lm import LM
    from repro_torch.parallel import comm, tensor
    from repro_torch.parallel.axes import use_rules
    from repro_torch.training import steps
    free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = LM(cfg).init(_seeded_gen(seed), device=DEVICE, mesh=rules.mesh)
    init_s = time.perf_counter() - t0
    batch, prompt = TP_MOE_BATCH, TP_MOE_PROMPT
    tokens = torch.randint(0, cfg.vocab, (batch, prompt),
                           generator=_seeded_gen(seed + 1), device=DEVICE)
    out = {"init_s": init_s, "rank_param_bytes": _leaf_bytes(params),
           "layers": cfg.n_layers}
    for int8 in (False, True):
        model = LM(cfg.with_(moe_dispatch_int8=int8))
        prefill = steps.make_prefill_step(model, prompt + TP_DECODE + 1,
                                          rules)
        decode = steps.make_decode_step(model, rules)
        sent = comm.all_to_all.bytes
        t0 = time.perf_counter()
        with f32_acc():
            logits, cache = prefill(params, {"tokens": tokens})
            with use_rules(rules):
                tp = model.vocab_tp()
                tok = tensor.argmax_vocab(logits, tp)[:, None]
            seq = [tok]
            for _ in range(TP_DECODE):
                logits, cache = decode(params, cache, tok)
                with use_rules(rules):
                    tok = tensor.argmax_vocab(logits, tp)[:, None]
                seq.append(tok)
        torch.cuda.synchronize()
        out["int8" if int8 else "float"] = {
            "seconds": time.perf_counter() - t0,
            "a2a_bytes_sent": comm.all_to_all.bytes - sent,
            "tokens": torch.cat(seq, 1).cpu().tolist(),
            "finite": bool(torch.isfinite(logits).all())}
        del cache, logits
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    del params
    free_card()
    return out


def tp_moe_gate(seed: int, rules) -> dict:
    """One qwen3-moe layer at full width in f32: expert parallel (the
    rank's 64 experts, its sequence half routed) against rank 0's local
    dispatch on each half with all 128 experts (the same per-shard
    routing), gathered output within TP_GATE_TOL."""
    import torch.distributed as dist
    from repro_torch.configs.archs import ARCHS
    from repro_torch.models import moe
    from repro_torch.parallel import tensor
    from repro_torch.parallel.axes import use_rules
    cfg = ARCHS[TP_MOE].with_(dtype="float32")
    p = moe.init_moe(_seeded_gen(seed), cfg, torch.float32, device=DEVICE)
    rank = tensor.model_rank(rules.mesh)
    e = cfg.n_experts // 2
    local = dict(p, **{k: p[k][rank * e:(rank + 1) * e].contiguous()
                       for k in ("wg", "wu", "wd")})
    b, s = TP_MOE_GATE_TOKENS
    x = torch.randn((b, s, cfg.d_model), generator=_seeded_gen(seed + 1),
                    device=DEVICE)
    with f32_acc(), use_rules(rules):
        y, _ = moe.moe_ffn(local, cfg, x)
    err = None
    if dist.get_rank() == 0:
        with f32_acc():
            ref = torch.cat([moe._moe_local(p, cfg, x[:, :s // 2])[0],
                             moe._moe_local(p, cfg, x[:, s // 2:])[0]], 1)
        err = scaled_err(y, ref)
    del p, local
    free_card()
    return {"err": err}


def tp_moe_dp(seed: int) -> dict:
    """The moe family's data-parallel gradient on the world's 1-D data
    mesh (qwen3-moe full width, TP_DP_MOE_LAYERS layers, f32, local
    dispatch routing the global batch) against rank 0's one-rank gradient
    of the global batch; the dropped assignments of both."""
    import torch.distributed as dist
    from repro_torch.configs.archs import ARCHS
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.models.lm import LM
    from repro_torch.parallel import comm
    from repro_torch.parallel.axes import default_rules
    from repro_torch.training import steps
    free_card()
    cfg = ARCHS[TP_MOE].with_(n_layers=TP_DP_MOE_LAYERS, dtype="float32",
                             moe_impl="local", capacity_factor=1.0)
    model = LM(cfg)
    params = model.init(_seeded_gen(seed), device=DEVICE)
    rules = default_rules(make_host_mesh())
    rank, world = dist.get_rank(), dist.get_world_size()
    whole = SyntheticLMData(cfg, *TP_DP_MOE_BATCH,
                            device=DEVICE).next_batch()
    rows = TP_DP_MOE_BATCH[0] // world
    local = {k: v[rank * rows:(rank + 1) * rows] for k, v in whole.items()}
    with f32_acc(), moe.count_drops(DEVICE) as drops:
        loss2, _, grads2 = steps.make_grad_fn(model, rules)(params, local)
    total = int(comm.all_reduce_sum(drops.reshape(1))[0])
    out = {"drops_ranks": total}
    if rank == 0:
        g2 = tree_leaves(grads2)
        with f32_acc(), moe.count_drops(DEVICE) as drops1:
            loss1, _, grads1 = steps.make_grad_fn(model)(params, whole)
        g1 = tree_leaves(grads1)
        out.update(drops_one=int(drops1), loss_dp=float(loss2),
                   loss_one=float(loss1),
                   max_leaf_err=max(scaled_err(g2[k], g1[k]) for k in g1))
    del params
    free_card()
    return out


def tp_rank_two(seed: int) -> dict:
    """The 2-rank body of the tp phase."""
    import torch.distributed as dist
    from repro_torch.configs.archs import ARCHS
    from repro_torch.kernels import mec_conv as K
    from repro_torch.launch import serve as launch_serve
    from repro_torch.parallel import comm
    entered = time.time()
    rules = _tp_rules(TP_MESH)
    staged0 = comm.stage_to_host.bytes + comm.stage_to_device.bytes
    out = {"rank": dist.get_rank(), "entered": entered,
           "backend": dist.get_backend(), "world": dist.get_world_size(),
           "device": str(torch.cuda.current_device()), "seconds": {},
           "staged": {}}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        staged = comm.stage_to_host.bytes + comm.stage_to_device.bytes
        out[name] = fn(*a, **kw)
        out["seconds"][name] = time.perf_counter() - t0
        out["staged"][name] = (comm.stage_to_host.bytes
                               + comm.stage_to_device.bytes - staged)
        emit({"phase": "tp", "rank": out["rank"], "done": name,
              "seconds": out["seconds"][name],
              "staged_bytes": out["staged"][name],
              "peak_bytes": torch.cuda.max_memory_allocated()}, sys.stderr)

    dense = ARCHS[TP_DENSE]
    timed("dense_gate", tp_gate, dense.with_(n_layers=TP_GATE_LAYERS,
                                            dtype="float32"), seed, rules)
    timed("dense_serve", tp_serve_full, dense, seed, rules, TP_SERVE_BATCH,
          TP_SERVE_PROMPT, TP_DECODE + 1)
    zamba = ARCHS[SERVE_ARCH].with_(conv_impl="fused")
    timed("hybrid_gate", tp_gate, zamba.with_(
        n_layers=TP_ZAMBA_GATE_LAYERS, dtype="float32"), seed, rules)
    timed("hybrid_serve", tp_serve_full, zamba, seed, rules, TP_SERVE_BATCH,
          TP_SERVE_PROMPT, TP_DECODE + 1)
    timed("hybrid_train", tp_train, zamba.with_(
        n_layers=TP_ZAMBA_TRAIN_LAYERS), seed, rules, TP_TRAIN_STEPS,
          TP_TRAIN_BATCH)
    # the audio family's conv frontend: K1 on each rank (every rank holds
    # the whole batch), the model tensor parallel
    K.reset_launch_counts()
    free_card()
    t0 = time.perf_counter()
    whisper = launch_serve.serve(ARCHS[WHISPER_ARCH], batch=4, prompt_len=16,
                                 gen=5, device=DEVICE, seed=seed,
                                 warm_plans=True, rules=rules)
    out["whisper"] = {"k1_launches": K.launch_counts()["mec_conv_fused"],
                      "finite": bool(torch.isfinite(whisper["logits"]).all()),
                      "frontend_replays": whisper["frontend_replays"]}
    out["seconds"]["whisper"] = time.perf_counter() - t0
    del whisper
    timed("moe_gate", tp_moe_gate, seed, rules)
    timed("moe_serve", tp_moe_serve, ARCHS[TP_MOE], seed, rules)
    timed("kimi_serve", tp_moe_serve, ARCHS[TP_KIMI].with_(
        n_layers=TP_KIMI_LAYERS), seed, rules)
    timed("moe_dp", tp_moe_dp, seed)
    out["staged_bytes"] = (comm.stage_to_host.bytes
                           + comm.stage_to_device.bytes - staged0)
    return out


def tp_restore(seed: int, ckpt_dir: str) -> dict:
    """xlstm-125m at full width (f32, TP_RESTORE_LAYERS layers): two steps
    on (1, 2), saved with the shardings;
    restored onto (1, 2), onto (2, 1) and onto one rank: every leaf equal
    to the saved whole arrays, and the next step's loss of each."""
    import torch.distributed as dist
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.configs.archs import ARCHS
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import tensor
    from repro_torch.training import steps
    cfg = ARCHS[SSM_ARCH].with_(n_layers=TP_RESTORE_LAYERS, dtype="float32",
                                conv_impl="fused")
    model = LM(cfg)
    opt_cfg = AdamWConfig(lr=5e-4, total_steps=8, warmup_steps=1)
    data = SyntheticLMData(cfg, 4, 64, device=DEVICE)
    batches = [data.next_batch() for _ in range(3)]
    mgr = CheckpointManager(ckpt_dir)
    meshes = {"1x2": _tp_rules((1, 2)), "2x1": _tp_rules((2, 1))}
    rank = dist.get_rank()
    inside = rank < 2

    def run(rules, restore: bool):
        mesh = rules.mesh
        params = model.init(_seeded_gen(seed), device=DEVICE, mesh=mesh)
        opt = steps.init_opt_state(params)
        sh = tensor.shardings(params, mesh, cfg)
        shard = {"params": sh, "opt": {"m": sh, "v": sh}}
        fn = steps.make_train_step(model, opt_cfg, rules)
        d, nd = mesh.get_local_rank("data"), mesh.shape[0]

        def rows(b):
            r = b["tokens"].shape[0] // nd
            return {k: v[d * r:(d + 1) * r] for k, v in b.items()}
        if restore:
            got = mgr.restore(2, {"params": params, "opt": opt},
                              shardings=shard)
            params, opt = got["params"], got["opt"]
        else:
            for b in batches[:2]:
                params, opt, _ = fn(params, opt, rows(b))
            mgr.save(2, {"params": params, "opt": opt}, shardings=shard)
        whole = {k: v.detach().to("cpu", copy=True) for k, v in tree_leaves(
            tensor.gather_params(params, mesh, cfg)).items()}
        with f32_acc():
            _, _, m = fn(params, opt, rows(batches[2]))
        return whole, float(m["loss"])

    out = {}
    with f32_acc():
        if inside:
            saved, _ = run(meshes["1x2"], False)
        dist.barrier()
        for name in ("1x2", "2x1"):
            if inside:
                whole, loss = run(meshes[name], True)
                out[name] = {"bits": all(torch.equal(whole[k], saved[k])
                                         for k in saved), "loss": loss}
        dist.barrier()
        if rank == 0:
            params = model.init(_seeded_gen(seed), device=DEVICE)
            opt = steps.init_opt_state(params)
            got = mgr.restore(2, {"params": params, "opt": opt})
            leaves = tree_leaves(got["params"])
            bits = all(torch.equal(leaves[k].cpu(), saved[k]) for k in saved)
            fn = steps.make_train_step(model, opt_cfg)
            _, _, m = fn(got["params"], got["opt"], batches[2])
            out["world1"] = {"bits": bits, "loss": float(m["loss"])}
    free_card()
    return out


def tp_xlstm_grad(seed: int) -> dict:
    """xlstm-125m at full width, TP_XLSTM_GRAD_LAYERS layers, f32, K5: the
    gradient on (2, 2) (each data rank its contiguous rows), gathered
    whole, against rank 0's one-rank gradient of the global batch."""
    import torch.distributed as dist
    from repro_torch.configs.archs import ARCHS
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.lm import LM
    from repro_torch.parallel import tensor
    from repro_torch.training import steps
    cfg = ARCHS[SSM_ARCH].with_(n_layers=TP_XLSTM_GRAD_LAYERS,
                                dtype="float32", conv_impl="fused")
    model = LM(cfg)
    rules = _tp_rules((2, 2))
    whole = model.init(_seeded_gen(seed), device=DEVICE)
    local = model.init(_seeded_gen(seed), device=DEVICE, mesh=rules.mesh)
    batch = SyntheticLMData(cfg, 4, 64, device=DEVICE).next_batch()
    d = rules.mesh.get_local_rank("data")
    mine = {k: v[2 * d:2 * d + 2] for k, v in batch.items()}
    with f32_acc():
        loss2, _, grads = steps.make_grad_fn(model, rules)(local, mine)
    g2 = tree_leaves(tensor.gather_params(grads, rules.mesh, cfg))
    out = {"loss_tp": float(loss2)}
    if dist.get_rank() == 0:
        with f32_acc():
            loss1, _, g1 = steps.make_grad_fn(model)(whole, batch)
        g1 = tree_leaves(g1)
        out.update(loss_one=float(loss1),
                   max_leaf_err=max(scaled_err(g2[k], g1[k]) for k in g1))
    del whole, local, grads, g2
    free_card()
    return out


def tp_zero1_gate(seed: int) -> dict:
    """xlstm-125m at full width, TP_XLSTM_GRAD_LAYERS layers, f32, K5: the
    ZeRO-1 step against the plain step on (2, 2) from one rank-local init
    and the same batches, the parameters gathered whole after
    TP_ZERO1_GATE_STEPS steps: the largest absolute difference over the
    leaves (and each leaf's scaled error, reported)."""
    from repro_torch.configs.archs import ARCHS
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import tensor
    from repro_torch.training import steps
    cfg = ARCHS[SSM_ARCH].with_(n_layers=TP_XLSTM_GRAD_LAYERS,
                                dtype="float32", conv_impl="fused")
    model = LM(cfg)
    rules = _tp_rules((2, 2))
    d = rules.mesh.get_local_rank("data")
    data = SyntheticLMData(cfg, 4, 64, seed=seed, device=DEVICE)
    batches = [{k: v[2 * d:2 * d + 2] for k, v in data.next_batch().items()}
               for _ in range(TP_ZERO1_GATE_STEPS)]
    whole = {}
    for run, zero in (("plain", False), ("zero1", True)):
        params = model.init(_seeded_gen(seed), device=DEVICE,
                            mesh=rules.mesh)
        opt = steps.init_opt_state(params, model=model if zero else None,
                                   rules=rules if zero else None)
        fn = (steps.make_zero1_train_step if zero else
              steps.make_train_step)(model, AdamWConfig(
                  lr=5e-4, total_steps=10, warmup_steps=2), rules)
        with f32_acc():
            for b in batches:
                params, opt, _ = fn(params, opt, b)
        whole[run] = tree_leaves(tensor.gather_params(params, rules.mesh,
                                                      cfg))
        del params, opt
    # absolute, as tests/test_torch_tensor_parallel_steps.py holds it: a
    # leaf that starts at zero (a bias) is a few steps' lr in size, so
    # its scaled error reads Adam's sign steps at gradients near eps
    out = {"steps": TP_ZERO1_GATE_STEPS, "layers": cfg.n_layers,
           "max_abs_err": max(float((whole["zero1"][k].double()
                                     - whole["plain"][k].double()).abs()
                                    .max()) for k in whole["plain"]),
           "max_leaf_scaled_err": max(
               scaled_err(whole["zero1"][k], whole["plain"][k])
               for k in whole["plain"])}
    del whole
    free_card()
    return out


def zero1_share_bytes(cfg, shape) -> int:
    """A rank's AdamW moment bytes (m and v, f32) under ZeRO-1 over "data"
    on a ``shape`` ("data", "model") mesh: each of the rank's leaves
    (``parallel.tensor``'s placement) over the data ranks where
    ``sharding.opt_state_specs`` splits it.  Where the rank holds
    ``param_specs``' bytes (no leaf kept whole), this is the share
    ``opt_state_specs`` gives."""
    from repro_torch.launch.mesh import AbstractMesh, axis_sizes
    from repro_torch.optim.adamw import tree_map
    from repro_torch.parallel import sharding, tensor
    mesh = AbstractMesh(shape, ("data", "model"))
    params = fake_params(cfg)
    specs = sharding.opt_state_specs(sharding.param_specs(params, mesh),
                                     params, mesh, zero_axes=("data",))["m"]
    placements = tensor.local_placement(params, mesh, cfg)
    dp = axis_sizes(mesh)["data"]
    shares = []

    def one(spec, pl, leaf):
        local = math.prod(pl.local_shape(leaf.shape))
        shares.append(local // dp if any(
            ax == "data" or (isinstance(ax, tuple) and "data" in ax)
            for ax in spec) else local)

    tree_map(one, specs, placements, params)
    return 2 * 4 * sum(shares)


def tp_rank_four(seed: int, ckpt_dir: str) -> dict:
    """The 4-rank body of the tp phase: xlstm-125m on (2, 2) (plain,
    compressed, ZeRO-1 and the ZeRO-1 gate), yi-6b's SP
    and dots against base on (1, 2), the elastic restore."""
    import torch.distributed as dist
    from repro_torch.configs.archs import ARCHS
    from repro_torch.parallel import comm
    entered = time.time()
    out = {"rank": dist.get_rank(), "entered": entered, "seconds": {},
           "staged": {}}
    staged0 = comm.stage_to_host.bytes + comm.stage_to_device.bytes

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        staged = comm.stage_to_host.bytes + comm.stage_to_device.bytes
        out[name] = fn(*a, **kw)
        out["seconds"][name] = time.perf_counter() - t0
        out["staged"][name] = (comm.stage_to_host.bytes
                               + comm.stage_to_device.bytes - staged)
        emit({"phase": "tp", "rank": out["rank"], "done": name,
              "seconds": out["seconds"][name],
              "staged_bytes": out["staged"][name],
              "peak_bytes": torch.cuda.max_memory_allocated()}, sys.stderr)

    rules = _tp_rules((2, 2))
    xlstm = ARCHS[SSM_ARCH].with_(conv_impl="fused")
    for compressed in (False, True):
        timed("xlstm_" + ("compressed" if compressed else "plain"), tp_train,
              xlstm, seed, rules, TP_XLSTM_STEPS, TP_XLSTM_BATCH,
              compressed=compressed, lr=5e-4)
    timed("xlstm_zero1", tp_train, xlstm, seed, rules, TP_ZERO1_STEPS,
          TP_ZERO1_BATCH, lr=5e-4, zero1=True)
    timed("xlstm_zero1_gate", tp_zero1_gate, seed)
    timed("xlstm_grad", tp_xlstm_grad, seed)
    yi_rules = _tp_rules((1, 2))
    yi = ARCHS[TP_YI].with_(n_layers=TP_YI_LAYERS, dtype="float32",
                            remat=True)
    for name, over in (("base", {}), ("dots", {"remat_policy": "dots"}),
                       ("sp", {"seq_parallel": True})):
        if dist.get_rank() < 2:
            timed("yi_" + name, tp_train, yi.with_(**over), seed, yi_rules,
                  TP_YI_STEPS, (2, 256))
        dist.barrier()
    timed("restore", tp_restore, seed, ckpt_dir)
    out["staged_bytes"] = (comm.stage_to_host.bytes
                           + comm.stage_to_device.bytes - staged0)
    return out


def tp_phase(seed: int, tmp_dir: Path, C, ref, grad_tolerance) -> dict:
    """Phase 6j: tensor and expert parallelism on ranks that share the
    card; returns each kernel's launches on the ranks' main paths and
    K5's checks at the shapes a rank gives it."""
    from repro_torch.configs.archs import ARCHS
    from repro_torch.launch.mesh import AbstractMesh, spawn
    from repro_torch.parallel.tensor import excess_bytes
    free_card()
    t_phase = time.perf_counter()
    # K5 on the rank's channel slices, forward and backward, against its
    # plain version (strided views of the rank's projections)
    k5_cases = k5_gradient_case(C, ref, torch.Generator(device=DEVICE)
                                .manual_seed(seed), grad_tolerance,
                                cases={"zamba2-7b tp2": ZAMBA2_TP_CONV,
                                       "xlstm-125m tp2": SSM_TP_CONV})
    emit({"phase": "tp", "step": "k5_slices", "cases": k5_cases})
    t_spawn = time.time()
    two = spawn(tp_rank_two, 2, args=(seed,), backend=DIST_BACKEND,
                device="cuda", timeout_s=TP_TIMEOUT_S,
                join_timeout_s=DIST_JOIN_S)
    spawn_s = max(r["entered"] for r in two) - t_spawn
    check(all(r["backend"] == DIST_BACKEND and r["world"] == 2
              and r["device"] == "0" for r in two),
          f"tp ranks: {[(r['backend'], r['world'], r['device']) for r in two]}")
    lead = two[0]
    for fam in ("dense", "hybrid"):
        g = lead[f"{fam}_gate"]
        check(g["logits_err"] <= TP_GATE_TOL,
              f"tp {fam} f32 prefill logits against one rank: "
              f"{g['logits_err']} > {TP_GATE_TOL}")
        for r in two:
            rg = r[f"{fam}_gate"]
            check(rg["init_equals_slice"],
                  f"tp {fam} rank {r['rank']}: rank-local init is not the "
                  f"slice of the one-rank init")
            check(rg["rank_bytes"] == rg["counted_bytes"],
                  f"tp {fam} rank {r['rank']}: {rg['rank_bytes']} B held, "
                  f"{rg['counted_bytes']} B counted")
        serve = [r[f"{fam}_serve"] for r in two]
        check(all(s["finite"] and not s["decode_graph"] for s in serve),
              f"tp {fam} serve: {[(s['finite'], s['decode_graph']) for s in serve]}")
    n_mamba = ARCHS[SERVE_ARCH].n_layers
    check(all(r["hybrid_serve"]["k5_launches"] == n_mamba for r in two),
          f"tp zamba2-7b serve: K5 {[r['hybrid_serve']['k5_launches'] for r in two]}"
          f" launches a rank, not {n_mamba}")
    for r in two:
        tr = r["hybrid_train"]
        check(all(math.isfinite(v) for v in tr["losses"] + tr["grad_norms"])
              and tr["k5_launches_per_step"] >= TP_ZAMBA_TRAIN_LAYERS,
              f"tp zamba2-7b train rank {r['rank']}: {tr}")
        check(r["whisper"]["finite"] and r["whisper"]["k1_launches"] > 0,
              f"tp whisper-tiny rank {r['rank']}: {r['whisper']}")
    check(lead["moe_gate"]["err"] <= TP_GATE_TOL,
          f"tp expert-parallel layer against local dispatch: "
          f"{lead['moe_gate']['err']}")
    for name in ("moe_serve", "kimi_serve"):
        for r in two:
            m = r[name]
            check(m["float"]["finite"] and m["int8"]["finite"],
                  f"tp {name} rank {r['rank']}: not finite")
            check(0 < m["int8"]["a2a_bytes_sent"]
                  < m["float"]["a2a_bytes_sent"],
                  f"tp {name} rank {r['rank']}: all-to-all bytes "
                  f"{m['int8']['a2a_bytes_sent']} (int8) against "
                  f"{m['float']['a2a_bytes_sent']} (float)")
    dp = lead["moe_dp"]
    check(dp["max_leaf_err"] <= DIST_GRAD_TOL,
          f"tp moe data-parallel gradient: {dp['max_leaf_err']}")
    check(dp["drops_ranks"] == dp["drops_one"] and dp["drops_one"] > 0,
          f"tp moe data-parallel drops {dp['drops_ranks']} against one "
          f"rank's {dp['drops_one']}")
    tp2 = AbstractMesh(TP_MESH, ("data", "model"))
    emit({"phase": "tp", "step": "two_ranks", "spawn_s": spawn_s,
          "ranks": [{k: v for k, v in r.items() if k != "entered"}
                    for r in two],
          "replicated_excess_bytes_tp2": {
              a: excess_bytes(fake_params(ARCHS[a]), tp2, ARCHS[a])
              for a in (TP_DENSE, SERVE_ARCH, TP_MOE, SSM_ARCH)}})
    free_card()
    four = spawn(tp_rank_four, 4, args=(seed, str(tmp_dir / "tp_ckpt")),
                 backend=DIST_BACKEND, device="cuda", timeout_s=TP_TIMEOUT_S,
                 join_timeout_s=DIST_JOIN_S)
    lead4 = four[0]
    plain, comp = lead4["xlstm_plain"], lead4["xlstm_compressed"]
    gap = abs(plain["losses"][-1] - comp["losses"][-1])
    check(all(math.isfinite(v) for v in plain["losses"] + comp["losses"])
          and gap < TP_XLSTM_GAP,
          f"tp xlstm-125m on (2, 2): compressed against plain {gap}")
    z1 = lead4["xlstm_zero1"]
    share = zero1_share_bytes(ARCHS[SSM_ARCH], (2, 2))
    for r in four:
        rz = r["xlstm_zero1"]
        check(all(math.isfinite(v) for v in rz["losses"]),
              f"tp xlstm-125m ZeRO-1 rank {r['rank']}: {rz['losses']}")
        check(rz["moment_bytes"] == share,
              f"tp xlstm-125m ZeRO-1 rank {r['rank']}: moments "
              f"{rz['moment_bytes']} B, opt_state_specs' share {share} B")
        check(rz["k5_launches_per_step"] == 24,
              f"tp xlstm-125m ZeRO-1 rank {r['rank']}: K5 "
              f"{rz['k5_launches_per_step']} a step, not 24")
    check(lead4["xlstm_zero1_gate"]["max_abs_err"] <= TP_ZERO1_TOL,
          f"tp xlstm-125m ZeRO-1 against the plain step: "
          f"{lead4['xlstm_zero1_gate']}")
    emit({"phase": "tp", "step": "zero1", "arch": SSM_ARCH,
          "batch": TP_ZERO1_BATCH, "losses": z1["losses"],
          "step_s": z1["step_s"], "moment_bytes": z1["moment_bytes"],
          "share_bytes": share, "plain_moment_bytes":
              lead4["xlstm_plain"]["moment_bytes"],
          "gate": lead4["xlstm_zero1_gate"]})
    check(lead4["xlstm_grad"]["max_leaf_err"] <= DIST_GRAD_TOL,
          f"tp xlstm-125m gradient on (2, 2): "
          f"{lead4['xlstm_grad']['max_leaf_err']}")
    base = lead4["yi_base"]["losses"]
    for name in ("dots", "sp"):
        other = lead4[f"yi_{name}"]["losses"]
        check(all(abs(a - b) <= TP_SP_RTOL * abs(b)
                  for a, b in zip(other, base)),
              f"tp yi-6b {name} against base: {other} {base}")
    rs = lead4["restore"]
    losses = [rs[k]["loss"] for k in ("1x2", "2x1", "world1")]
    check(all(rs[k]["bits"] for k in ("1x2", "2x1", "world1")),
          f"tp restore: leaves not equal to the bit {rs}")
    check(max(losses) - min(losses) <= TP_RESTORE_TOL * abs(losses[0]),
          f"tp restore: next-step losses {losses}")
    emit({"phase": "tp", "step": "four_ranks",
          "ranks": [{k: v for k, v in r.items() if k != "entered"}
                    for r in four], "xlstm_last_loss_gap": gap})
    emit({"phase": "tp", "step": "timings",
          "phase_s": time.perf_counter() - t_phase})
    launches = {n: 0 for n in KERNEL_ROWS}
    launches["mec_conv_fused"] = sum(r["whisper"]["k1_launches"] for r in two)
    launches["mec_conv1d"] = sum(
        r["hybrid_serve"]["k5_launches"]
        + r["hybrid_train"]["k5_launches_per_step"] * TP_TRAIN_STEPS
        for r in two) + sum(
        (r["xlstm_plain"]["k5_launches_per_step"]
         + r["xlstm_compressed"]["k5_launches_per_step"]) * TP_XLSTM_STEPS
        + r["xlstm_zero1"]["k5_launches_per_step"] * TP_ZERO1_STEPS
        for r in four)
    return {"launches": launches, "k5_slices": k5_cases,
            "hybrid_serve_k5_per_rank": lead["hybrid_serve"]["k5_launches"]}


def profile_decode(model, params, cache, tok, steps: int = 4) -> dict:
    """Device time and idle share of ``steps`` decode steps from ``cache``
    (batch ``tok``), eagerly and through the captured program, each after
    two untraced steps, each on its own clone of the cache."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import serve as serve_lib
    from repro_torch.models.lm import tree_map
    from repro_torch.serving import DecodeProgram
    out = {}
    for mode, graph in (("eager", False), ("graph", True)):
        c = tree_map(torch.clone, cache)
        prog = DecodeProgram(
            lambda cc, t: serve_lib.decode_step(model, params, cc, t), c,
            tok.clone(), graph=graph)
        for _ in range(2):
            prog()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                prog()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out[mode] = {"steps": steps, **device_breakdown(prof, wall, top=8)}
        del prog, c
    return out


DRYRUN_LM = ("whisper-tiny", "train_4k")   # the fake group's LM cell
DRYRUN_TIMEOUT_S = 600
DRYRUN_CODE = """
import sys
import torch
torch.set_num_threads(1)   # beside the phases, on one core
from repro_torch.launch import dryrun
out = sys.argv[1]
dryrun.main(["--arch", sys.argv[2], "--shape", sys.argv[3], "--out", out])
dryrun.main(["--conv", "all", "--out", out])
"""


def start_dryrun(out_dir: Path):
    """``launch.dryrun`` on the host, in a process of its own (the fake
    process group of 256 ranks must not meet the phases' groups) and in
    the background, with no card: one LM cell (:data:`DRYRUN_LM`) and the
    three conv cells.  Returns the process; its log is ``out_dir/log``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    log = open(out_dir / "log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", DRYRUN_CODE, str(out_dir), *DRYRUN_LM],
        env=env, stdout=log, stderr=subprocess.STDOUT,
        preexec_fn=lambda: os.nice(10))
    log.close()
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def finish_dryrun(proc, out_dir: Path, t_start: float) -> dict:
    """Wait for :func:`start_dryrun`'s process and gate its records: the
    LM cell's parameter bytes a device equal ``local_param_bytes`` and its
    moment bytes the ZeRO-1 share, both exact; each conv cell's contract
    held; every count finite.  Counts on fake tensors, not measurements."""
    from repro_torch.configs.archs import ARCHS
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.parallel.tensor import local_param_bytes
    try:
        rc = proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S
                                   - (time.perf_counter() - t_start)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    tail = (out_dir / "log").read_text()[-3000:]
    check(rc == 0, f"dry run: exit {rc}\n{tail}")
    arch, shape = DRYRUN_LM
    lm = json.loads((out_dir / f"{arch}__{shape}__pod.json").read_text())
    cfg = ARCHS[arch]
    mesh = AbstractMesh((16, 16), ("data", "model"))
    want_params = local_param_bytes(fake_params(cfg), mesh, cfg)
    want_moments = zero1_share_bytes(cfg, (16, 16))
    dev = lm["per_device"]
    check(dev["param_bytes"] == want_params,
          f"dry run {arch}: {dev['param_bytes']} parameter bytes a device, "
          f"local_param_bytes {want_params}")
    check(dev["moment_bytes"] == want_moments,
          f"dry run {arch}: {dev['moment_bytes']} moment bytes a device, "
          f"the ZeRO-1 share {want_moments}")
    check(math.isfinite(dev["flops"]) and dev["flops"] > 0
          and dev["collectives"]["total"] > 0,
          f"dry run {arch}: flops {dev['flops']}, collectives "
          f"{dev['collectives']}")
    conv = {}
    for name in ("conv_channel", "conv_spatial", "conv_batch_spatial"):
        rec = json.loads((out_dir / f"{name}__pod.json").read_text())
        check(rec["shardcheck"]["verdict"] == "pass",
              f"dry run {name}: {rec['shardcheck']['violations']}")
        conv[name] = {"busiest_grad": rec["shardcheck"]["directions"][
            "grad"]["observed"], "replicated_ways":
            rec["shardcheck"]["replicated_ways"]}
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch.costmodel import MeshShape, cell_cost
    cell = SHAPES[shape]
    cost = cell_cost(cfg, cell.kind, cell.global_batch, cell.seq_len,
                     MeshShape())
    out = {"phase": "dryrun", "torch": torch.__version__,
           "what": "counts on fake tensors for a 16 x 16 mesh of H100s; "
                   "not measured",
           "lm": {"cell": f"{arch}/{shape}", "param_bytes": dev["param_bytes"],
                  "moment_bytes": dev["moment_bytes"], "flops": dev["flops"],
                  "cell_cost_flops_per_chip": cost["flops"] / 256,
                  "collectives": dev["collectives"], "memory": dev["memory"]},
           "conv": conv, "seconds_after_start": time.perf_counter() - t_start}
    emit(out)
    return out


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
    # one set of constants: the package's roofline reads the H100 SXM's
    from repro_torch.launch import hlo_analysis
    if peak_label == hlo_analysis.SOURCE:
        check((peak_bf16, peak_bw) == (hlo_analysis.PEAK_FLOPS,
                                       hlo_analysis.HBM_BW),
              f"PEAKS {peak_bf16, peak_bw} against launch.hlo_analysis "
              f"{hlo_analysis.PEAK_FLOPS, hlo_analysis.HBM_BW}")
    t_dryrun = time.perf_counter()
    dryrun_dir = Path(plan_dir) / "dryrun"
    dryrun = start_dryrun(dryrun_dir)
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

    # K5's gradient (fault F10)
    emit({"phase": "kernels", "kernel": "K5",
          "gradient": k5_gradient_case(C, ref, gen, grad_tolerance)})

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
    del outs, outs_low

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
          and train_counts["mec_gemm"] == 0
          and train_counts["mec_weight_grad"] == len(stack),
          f"mec_fused2 stack launched {train_counts}: K4, and K6 once a conv")
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
                         "mec_conv_fused2": 3 * TRAIN_STEPS,
                         "mec_weight_grad": 3 * TRAIN_STEPS},
          f"train_cnn launched {cnn_counts}, not 3 x {TRAIN_STEPS} K4 and K6")
    emit({"phase": "train", "batch": SLICE_BATCH, "grad_check": grad_err,
          "stack_convs": len(stack), "stack_launches": train_counts,
          "stack_forward_seconds": round(t1 - t0, 4),
          "stack_backward_seconds": round(t2 - t1, 4),
          "train_cnn": {"args": TRAIN_ARGS, "steps": TRAIN_STEPS, "final_acc": acc,
                        "launches": cnn_counts, "seconds": round(train_s, 3),
                        "seconds_per_step": train_s / TRAIN_STEPS}})

    # 5b. k6: the MEC weight gradient against its plain version, timed -----
    k6 = k6_phase(args.seed, grad_tolerance, peak_tf32, peak_bw)

    # 6. serve: zamba2-7b at full width and depth ---------------------------
    cfg = ARCHS[SERVE_ARCH].with_(conv_impl="fused")
    n_mamba = cfg.n_layers
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    served = serve_both(cfg, args.seed, batch=SERVE_BATCH,
                        prompt_len=SERVE_PROMPT, gen=SERVE_GEN)
    serve_s = time.perf_counter() - t0
    for mode in ("graph", "eager"):
        counts = served[mode]["launches"]
        check(counts == {"mec_conv_fused": 0, "mec_lower": 0, "mec_gemm": 0,
                         "mec_conv_fused2": 0, "mec_weight_grad": 0,
                         "mec_conv1d": n_mamba},
              f"serve ({mode}) launched {counts}, not {n_mamba} K5 and no "
              "K1-K4")
    serve_counts = served["graph"]["launches"]
    serve_peak = served["graph"]["peak_allocated_bytes"]
    fused_logits = served["graph"]["prefill_logits"]
    serve_times = {"prefill_seconds": served["graph"]["prefill_seconds"],
                   "decode_seconds": served["graph"]["decode_seconds"],
                   "decode_tokens_per_s": served["graph"]["decode_tokens_per_s"],
                   "graph": public(served["graph"]),
                   "eager": public(served["eager"])}
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
            if dname == "bfloat16":
                graph_check, _, _ = graph_vs_eager(
                    model, params, lm_mod.tree_map(torch.clone, cache),
                    prompt[:, DECODE_FROM:DECODE_FROM + GRAPH_STEPS])
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
            # p0 and conv_x are views: they would keep the Mamba2 weights
            # and the in_proj output alive
            del y, plain, zxbcdt, h, params, full, p0, conv_x, conv_w
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
          "graph_vs_eager": graph_check,
          "memory": {"conv_out_bytes": out_b, "conv_l_bytes": low_b,
                     "fused_extra_bytes": extra["fused"],
                     "lowered_extra_bytes": extra["lowered"]}})

    # 6b. serve_conv: plan-driven conv serving --------------------------------
    serve_conv = serve_conv_phase(args.seed, fwd_tolerance, peak_tf32, peak_bw)

    # 6c. serve_whisper: whisper-tiny through the warmed frontend ------------
    whisper_launches = serve_whisper_phase(args.seed)

    # 6d. serve_dense: qwen3-4b, the batcher, the int8 cache, the triangle ---
    serve_dense_phase(args.seed)

    # 6e. serve_vlm: llava-next-34b through the warmed patch embed -----------
    vlm = serve_vlm_phase(args.seed)

    # 6f. serve_ssm: xlstm-125m at full size, K5 in every block's prefill ---
    ssm = serve_ssm_phase(args.seed)

    # 6g. serve_moe: qwen3-moe-30b-a3b at full size, kimi-k2 at full width --
    serve_moe_phase(args.seed)

    # 6h. train_lm: a train step per family, K5's gradient, the resume ------
    train_lm = train_lm_phase(args.seed, Path(plan_dir))

    # 6i. dist: ranks that share the card, every kernel in their bodies ----
    dist_launches = dist_phase(args.seed)

    # 6j. tp: the LMs' tensor and expert parallelism on ranks sharing it ---
    tp = tp_phase(args.seed, Path(plan_dir), C, ref, grad_tolerance)

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

    # K2 against its library call, alternating rounds on the L2-cold timer
    k2_rounds = k2_against_library(K, gen, RESNET101)
    emit({"phase": "timing", "kernel": "mec_lower", "vs_library": k2_rounds})

    # K5 at the zamba2-7b conv input in bf16, a column slice of the in_proj
    # output as the model passes it, on the L2-cold timer (a prefill's
    # in_proj output, 59.7 MB, is not in the L2 when K5 reads it).
    k5 = conv1d_timing(C, gen, cfg.conv_width, peak_flops, peak_bw)
    emit({"phase": "timing", "kernel": "mec_conv1d", **k5})
    # and at the xlstm-125m mLSTM conv input (x_in, a strided view of the
    # up projection), its second caller
    k5_ssm = conv1d_timing(C, gen, ARCHS[SSM_ARCH].conv_width, peak_flops,
                           peak_bw, shape=SSM_CONV)
    emit({"phase": "timing", "kernel": "mec_conv1d", "model": SSM_ARCH,
          **k5_ssm})
    # and at its training caller's input: zamba2-7b's conv input at the
    # train step's batch and sequence
    k5_train = conv1d_timing(C, gen, cfg.conv_width, peak_flops, peak_bw,
                             shape=(TRAIN_BATCH, TRAIN_SEQ, IN_PROJ, CONV_LO,
                                    CONV_HI))
    emit({"phase": "timing", "kernel": "mec_conv1d", "caller": "train_lm",
          **k5_train})
    # and its runtime-k_w path at the same shape (no model reaches it)
    k5_any = conv1d_timing(C, gen, ANY_KW_TIMED, peak_flops, peak_bw)
    emit({"phase": "timing", "kernel": "mec_conv1d", "path": "runtime k_w",
          **k5_any})
    # and at the channel slices a rank gives it at tp 2 (the tp phase)
    k5_tp = {name: conv1d_timing(C, gen, cfg.conv_width, peak_flops,
                                 peak_bw, shape=shape)
             for name, shape in (("zamba2-7b", ZAMBA2_TP_CONV),
                                 ("xlstm-125m", SSM_TP_CONV))}
    for name, rec in k5_tp.items():
        emit({"phase": "timing", "kernel": "mec_conv1d",
              "caller": f"{name} tp 2", **rec})

    # 8. profile ------------------------------------------------------------
    prof = profile_serving(cfg, args.seed)
    emit({"phase": "profile", **prof})
    roofline_reading("profile zamba2-7b decode (graph)", cfg, "decode",
                     SERVE_BATCH, SERVE_PROMPT + 2 + GRAPH_STEPS,
                     prof["decode"]["graph"]["device_busy_s"] / GRAPH_STEPS,
                     "device")

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
                                                     "library_ms")}},
                # the second caller, read around its own runs
                "xlstm_125m": {
                    "launches_served": ssm["k5_launches_served"],
                    "launches_per_prefill": ssm["k5_launches"]["prefill"],
                    "launches_per_decode_step": ssm["k5_launches"]["decode"],
                    "shape": k5_ssm["shape"],
                    "input_row_stride": k5_ssm["input_row_stride"],
                    **{f: k5_ssm[f] for f in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms",
                                              "copy_ms", "memcpy_ms")}},
                # the training caller: launches a train step (forward and
                # remat recompute), read around the step, and K5 at the
                # step's conv input
                "train_lm": {
                    "launches_per_step": {
                        a: train_lm["runs"][a]["launches"]["mec_conv1d"]
                        for a in TRAIN_FUSED},
                    "layers": {a: train_lm["runs"][a]["layers"]
                               for a in TRAIN_FUSED},
                    "shape": k5_train["shape"],
                    **{f: k5_train[f] for f in ("ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")},
                    # one zamba2-7b step traced: K5's device time in it
                    "traced_step": {
                        f: train_lm["runs"][TRAIN_TRACED]["traced_step"][f]
                        for f in ("k5_launches", "k5_kernels", "k5_device_ms",
                                  "device_busy_s", "wall_s")}},
                # the tensor-parallel caller (tp phase): launches summed
                # over its ranks, and K5 at the slices a rank gives it
                "tensor_parallel": {
                    "launches": tp["launches"]["mec_conv1d"],
                    "zamba2_7b_prefill_launches_per_rank":
                        tp["hybrid_serve_k5_per_rank"],
                    "slice_gradient_checks": len(tp["k5_slices"]),
                    **{name: {f: rec[f] for f in (
                        "shape", "input_row_stride", "ms", "plain_ms",
                        "bound_ms", "bound_by", "library_ms")}
                       for name, rec in k5_tp.items()}}})
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
    # K6: the 34-conv stack's weight gradients at the training batch (k6
    # phase); it replaces no TPU kernel
    rows.append({
        "name": "mec_weight_grad", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mec_wgrad.cu", "replaces": None,
        "launches": train_counts["mec_weight_grad"], "batch": K6_BATCH,
        **{f: sum(w * k6["timing"][n][f] for n, w in RESNET101.items())
           for f in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": "operations", "train_cnn_launches": cnn_counts["mec_weight_grad"]})
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
                "whisper_tiny_served": whisper_launches[row["name"]],
                "llava_next_34b_served": (vlm["k1_launches"]
                                          if row["name"] == "mec_conv_fused"
                                          else 0)}
    for row in rows:
        row["dist_launches"] = dist_launches[row["name"]]
        row["tp_launches"] = tp["launches"][row["name"]]
    rows[list(KERNEL_ROWS).index("mec_conv_fused")]["whisper_frontend"] = \
        serve_conv["whisper_k1"]
    rows[list(KERNEL_ROWS).index("mec_lower")]["vs_library_rounds"] = k2_rounds
    rows[list(KERNEL_ROWS).index("mec_gemm")]["lowered_pair"] = {
        "ms": sum(pair[(n, SLICE_BATCH)]["ms"] for n in RESNET101),
        "library_ms": sum(pair[(n, SLICE_BATCH)]["library_ms"] for n in RESNET101)}
    finish_dryrun(dryrun, dryrun_dir, t_dryrun)
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
