"""Static launch-geometry and shared-memory checker for the MEC CUDA
kernels K1-K4 (counterpart of ``repro.analysis.pallas_check``).

Given a resolved plan (anything with ``.spec``, ``.algorithm``,
``.w_blk``, ``.dtype``; duck-typed, so this module never imports
``repro_torch.plan``) and the card's limits (:class:`DeviceLimits`, the
H100's by default), mirror what the launchers of
``kernels/csrc/mec_conv.cu`` would choose, with no build and no launch:
the Python side's blocks (``kernels.ops`` ``default_w_blk``,
``pick_oh_blk``, ``mec_conv.gemm_core``), then ``mma_config``'s launch
for K1, K4 and K3 (``fused2_tile``, the MMA tile, the compact or
channel-chunked reduction, the chunk, the cluster split of the
reduction, the shared memory, the grid) and K2's row blocking
(``launch_lower``).  :func:`launcher_fields` is that mirror field for
field ``mec_conv.fused_config``'s; ``chip_smoke.py`` holds the two equal
on every geometry it launches.  Violations, in the reference's five
kinds, translated to the card:

``w-blk-out-of-range``        w_blk outside [1, o_w] (the executor's own
                              precondition).
``block-index-out-of-bounds`` a CTA at the grid's last corner reads past
                              its operand: K1/K4's input row h*s_h + r
                              and column, K4's staged rows (its halo),
                              K3's L row h*s_h + r, K2's window.
``grid-not-covering``         the grid leaves part of the output
                              unwritten, or it (or its cluster) exceeds
                              what the card launches, so the covering
                              grid cannot run.
``smem-budget-overrun``       the cp.async ring (stages x stage bytes)
                              exceeds the card's opt-in shared memory a
                              block (replaces ``vmem-budget-overrun``).
``accumulator-overrun``       the chosen MMA tile's f32 accumulator
                              fragment a thread (twice that for f32
                              operands, whose step sums are kept apart)
                              exceeds :data:`ACC_REGISTERS`.

And one the TPU kernels do not have: ``dtype-without-instance``, a
dtype the kernels are not compiled for (they take float32, bfloat16 and
float16).  ``plan_conv2d`` refuses a kernel plan that fails
(:func:`assert_plan`), and the measured race skips such a candidate.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

KERNEL_ALGORITHMS = ("mec_lowered", "mec_fused", "mec_fused2")

#: the launcher's constants (csrc/mec_mma.cuh, csrc/mec_conv.cu)
STAGES = 3                 # kStages: the cp.async ring
BN = 64                    # kBN: output channels a CTA
BNP = BN + 8               # kBNP: a staged kernel row, elements
MAX_BM = 128               # kMaxBM: positions of the largest MMA tile
FUSED2_MAX_ROWS = 16       # kFused2MaxRows
MMA_SMEM = 113 * 1024      # kMmaSmem: what a CTA aims at (two an SM)
MAX_SPLIT = 4              # kMaxSplit: CTAs of a cluster
K2_THREADS = 256           # kThreads
K2_ELEMS = 4096            # elements of L a K2 CTA copies
INT_MAX = 2 ** 31 - 1
#: f32 accumulator registers a thread may hold: half of the 128 that
#: ``__launch_bounds__(256, 2)`` leaves an 8-warp tile
ACC_REGISTERS = 64

_ELEM = {"float32": 4, "bfloat16": 2, "float16": 2}
#: K1, K3, K4 by the number ``mec_conv.fused_config`` knows them by
KIND = {"mec_fused": 1, "mec_gemm": 3, "mec_fused2": 4}


class LaunchCheckError(ValueError):
    """A plan failed the static launch check."""


@dataclasses.dataclass(frozen=True)
class DeviceLimits:
    """What the launchers size a launch by, the H100 SXM's by default:
    opt-in shared memory a block, SMs, grid and cluster limits."""

    smem_optin: int = 227 * 1024
    sms: int = 132
    max_grid_x: int = INT_MAX
    max_grid_yz: int = 65535
    max_cluster: int = 8


H100 = DeviceLimits()


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    kernel: str
    message: str

    def render(self) -> str:
        return f"[{self.rule}] {self.kernel}: {self.message}"


@dataclasses.dataclass(frozen=True)
class KernelGeometry:
    """One kernel launch, mirrored: its grid, threads a CTA, dynamic
    shared memory and the launcher's fields (``fused_config``'s for K1,
    K3 and K4; K2's rows a CTA)."""

    name: str
    grid: Tuple[int, int, int]
    threads: int
    smem_bytes: int
    config: Dict[str, int]
    #: a CTA's block, (rows, columns) of the output in the core's terms
    #: (K3: output columns w, rows h); K2: (rows of L, 1)
    block: Tuple[int, int] = (1, 1)


@dataclasses.dataclass(frozen=True)
class PlanCheck:
    algorithm: str
    kernel: bool                      # False => trivially accepted
    w_blk: Optional[int]
    kernels: Tuple[KernelGeometry, ...]
    smem_budget: int
    acc_budget: int
    violations: Tuple[Violation, ...]

    @property
    def ok(self) -> bool:
        return not self.violations

    @property
    def smem_bytes(self) -> int:
        """The largest shared memory a block of the plan's kernels takes."""
        return max((k.smem_bytes for k in self.kernels), default=0)

    def render(self) -> str:
        head = (f"{self.algorithm} w_blk={self.w_blk} "
                f"smem={self.smem_bytes}/{self.smem_budget}B: "
                f"{'ok' if self.ok else 'REJECTED'}")
        return "\n".join([head] + ["  " + v.render()
                                   for v in self.violations])


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _ceil_div(a, b) * b


def _copy_width(row_bytes: int) -> int:
    """``copy_width`` on a 16-byte-aligned base: the widest of 16, 8 and
    4 bytes dividing the run, else 2."""
    for v in (16, 8, 4):
        if row_bytes % v == 0:
            return v
    return 2


def fused2_tile(oh_blk: int, w_blk: int, k_w: int, s_w: int,
                optin: int) -> Tuple[int, int, bool]:
    """``fused2_tile``: K4's (and K3's) tr x tc sub-tile of an oh_blk x
    w_blk block, and whether its smallest ring fits ``optin``."""
    def min_ring(tr, tc):
        return STAGES * (tr * ((tc - 1) * s_w + k_w) * 48 + k_w * 2304)
    tr = min(oh_blk, FUSED2_MAX_ROWS)
    tc = min(MAX_BM // tr, w_blk)
    while min_ring(tr, tc) > optin and (tr > 1 or tc > 1):
        if tc > 1:
            tc = (tc + 1) // 2
        else:
            tr = (tr + 1) // 2
    return tr, tc, min_ring(tr, tc) <= optin


def mma_launch(kind: int, dtype: str, i_n: int, i_h: int, i_w: int,
               i_c: int, k_h: int, k_w: int, k_c: int, s_h: int, s_w: int,
               o_h: int, o_w: int, w_blk: int, oh_blk: int,
               limits: DeviceLimits = H100
               ) -> Tuple[Optional[KernelGeometry], List[Tuple[str, str]]]:
    """``mma_config`` for K1 (``kind`` 1), K4 (4) or K3 (3, in the core's
    terms: ``mec_conv.gemm_core``'s geometry), with 16-byte-aligned
    operands: the launch and the (rule, reason) of each limit it breaks.
    The launch is None where the launcher refuses before it has one."""
    name = {1: "K1 fused_kernel", 3: "K3 gemm_kernel",
            4: "K4 fused2_kernel"}[kind]
    problems: List[Tuple[str, str]] = []
    elem = _ELEM[dtype]
    optin = limits.smem_optin
    if kind == 1:
        tr, tc, oh_blk = 1, min(w_blk, MAX_BM), 1
    else:
        tr, tc, fits = fused2_tile(oh_blk, w_blk, k_w, s_w, optin)
        if not fits:
            problems.append((
                "smem-budget-overrun",
                f"the smallest ring of a 1 x 1 sub-tile (k_w={k_w}) exceeds "
                f"the opt-in {optin} B"))
            return None, problems
    n_hblk = _ceil_div(o_h, oh_blk)
    tile = tr * tc
    bm = 16 if tile <= 16 else 32 if tile <= 32 else 64 if tile <= 64 \
        else 128
    threads = 256 if bm == 128 else 128
    depth = 8 if elem == 4 else 16
    vec = 16 // elem
    kwic = k_w * i_c
    compact, cc, nchunk, stage, vin = 0, 0, 0, 0, 16
    if i_c <= 16:                 # the compact path: the k_w*i_c run
        kp = _round_up(kwic, depth)
        real = ((tc - 1) * s_w + k_w) * i_c
        run = _round_up(vec - 1 + real + kp - kwic, vec)
        stage = (tr * run + kp * BNP) * elem
        if STAGES * stage <= optin:
            compact, cc, nchunk = 1, kp, 1
    if not compact:               # the channel path: chunks of cc channels
        span = (tc - 1) * s_w + k_w

        def stage_of(c):
            return (tr * span * (c + vec) + k_w * c * BNP) * elem
        cap = 128 // elem
        lcc = 0
        while (1 << lcc) < depth:
            lcc += 1
        while (1 << lcc) < i_c and (1 << lcc) < cap:
            lcc += 1
        while (1 << lcc) > depth and STAGES * stage_of(1 << lcc) > MMA_SMEM:
            lcc -= 1
        cc = 1 << lcc
        stage = stage_of(cc)
        if STAGES * stage > optin:
            problems.append((
                "smem-budget-overrun",
                f"a ring of {STAGES} stages of {stage} B (chunk {cc}, "
                f"{tr} x {tc} sub-tile, k_w={k_w}) exceeds the opt-in "
                f"{optin} B"))
            return None, problems
        nchunk = _ceil_div(i_c, cc)
        vin = _copy_width(i_c * elem)
    tiles = i_n * n_hblk * _ceil_div(o_w, w_blk) * _ceil_div(k_c, BN)
    steps = k_h * nchunk
    split = 1
    while (split < MAX_SPLIT and tiles * split * (threads // 32)
           < 8 * limits.sms and steps >= 4 * split):
        split *= 2
    smem = STAGES * stage
    if split > 1:
        smem = max(smem, threads * 32 * 4)   # the leader's partial sums
    grid = (i_n * n_hblk * split, _ceil_div(o_w, w_blk), _ceil_div(k_c, BN))
    if grid[0] > limits.max_grid_x or max(grid[1:]) > limits.max_grid_yz:
        problems.append(("grid-not-covering",
                         f"grid {grid} exceeds the card's ({limits.max_grid_x}"
                         f", {limits.max_grid_yz}, {limits.max_grid_yz})"))
    if split > limits.max_cluster:
        problems.append(("grid-not-covering",
                         f"a cluster of {split} exceeds {limits.max_cluster}"))
    if smem > optin:
        problems.append(("smem-budget-overrun",
                         f"{smem} B exceed the opt-in {optin} B"))
    acc = bm * BN // threads * (2 if elem == 4 else 1)
    if acc > ACC_REGISTERS:
        problems.append(("accumulator-overrun",
                         f"{acc} accumulator registers a thread for a "
                         f"{bm} x {BN} tile exceed {ACC_REGISTERS}"))
    # the CTA at the grid's last corner: its last output row and column
    h_end = min(n_hblk * oh_blk, o_h)
    w_end = min(grid[1] * w_blk, o_w)
    if (h_end - 1) * s_h + k_h > i_h:
        problems.append(("block-index-out-of-bounds",
                         f"input row {(h_end - 1) * s_h + k_h - 1} (output "
                         f"row h*s_h + r, with the rows staged for it) past "
                         f"{i_h} rows"))
    if (w_end - 1) * s_w + k_w > i_w:
        problems.append(("block-index-out-of-bounds",
                         f"input column {(w_end - 1) * s_w + k_w - 1} past "
                         f"{i_w} columns"))
    if n_hblk * oh_blk < o_h or grid[1] * w_blk < o_w or grid[2] * BN < k_c:
        problems.append(("grid-not-covering",
                         f"grid {grid} of {oh_blk} x {w_blk} x {BN} blocks "
                         f"short of ({o_h}, {o_w}, {k_c})"))
    config = {"tr": tr, "tc": tc, "mma_rows": bm, "compact": compact,
              "chunk": cc, "chunks": nchunk, "split": split,
              "smem_bytes": smem, "input_copy_bytes": 16 if compact else vin,
              "kernel_copy_bytes": _copy_width(k_c * elem)}
    return KernelGeometry(name, grid, threads, smem, config,
                          (oh_blk, w_blk)), problems


def _lower_launch(i_n, i_h, i_w, i_c, k_w, s_w, o_w, limits):
    """``launch_lower``: K2's rows of L a CTA and its grid."""
    problems = []
    kwic = k_w * i_c
    rows = min(max(K2_ELEMS // kwic, 1), i_h)
    if rows * kwic > INT_MAX:
        problems.append(("grid-not-covering",
                         f"{rows} rows of {kwic} elements a CTA past 2^31"))
    grid = (i_n * o_w, _ceil_div(i_h, rows), 1)
    if grid[0] > limits.max_grid_x or grid[1] > limits.max_grid_yz:
        problems.append(("grid-not-covering",
                         f"grid {grid} exceeds the card's"))
    if (o_w - 1) * s_w + k_w > i_w:
        problems.append(("block-index-out-of-bounds",
                         f"window column {(o_w - 1) * s_w + k_w - 1} past "
                         f"{i_w} columns"))
    return KernelGeometry("K2 lower_kernel", grid, K2_THREADS, 0,
                          {"rows": rows}, (rows, 1)), problems


def launcher_fields(algorithm: str, dtype: str, spec, w_blk: int,
                    limits: DeviceLimits = H100) -> Optional[Dict[str, int]]:
    """What ``ops.launch_config`` reads from the launcher
    (``mec_conv.fused_config``'s fields) for K1 (``mec_fused``), K4
    (``mec_fused2``) or K3 (``mec_lowered``) on this geometry at this
    ``w_blk``; None where the launcher would refuse it."""
    result = check_geometry(spec, algorithm, w_blk, dtype, limits=limits)
    if not result.ok:
        return None
    return dict(result.kernels[-1].config)


def check_geometry(spec, algorithm: str, w_blk: Optional[int],
                   dtype: str = "float32", *,
                   limits: DeviceLimits = H100) -> PlanCheck:
    """Statically check one (spec, algorithm, w_blk) kernel geometry on
    a card of ``limits``.  ``spec`` needs the ConvSpec fields
    (``i_n..s_w`` and ``o_h``/``o_w``); ``w_blk`` None is the executor's
    own pick (``ops.default_w_blk``).  Non-kernel algorithms are
    trivially accepted (``kernel=False``)."""
    from repro_torch.kernels import mec_conv, ops
    acc_budget = ACC_REGISTERS
    if algorithm not in KERNEL_ALGORITHMS:
        return PlanCheck(algorithm, False, w_blk, (), limits.smem_optin,
                         acc_budget, ())
    i_n, i_h, i_w, i_c = spec.i_n, spec.i_h, spec.i_w, spec.i_c
    k_h, k_w, k_c, s_h, s_w = spec.k_h, spec.k_w, spec.k_c, spec.s_h, \
        spec.s_w
    o_h, o_w = spec.o_h, spec.o_w
    mode = algorithm[len("mec_"):]
    shapes = ((i_n, i_h, i_w, i_c), (k_h, k_w, i_c, k_c), (s_h, s_w))
    if w_blk is None:
        w_blk = ops.default_w_blk(mode, *shapes)

    def result(kernels, violations):
        return PlanCheck(algorithm, True, w_blk, tuple(kernels),
                         limits.smem_optin, acc_budget, tuple(violations))

    if str(dtype) not in _ELEM:
        return result((), [Violation(
            "dtype-without-instance", algorithm,
            f"no instance for {dtype} (the kernels take float32, "
            f"bfloat16, float16)")])
    if not 1 <= w_blk <= max(o_w, 1):
        return result((), [Violation("w-blk-out-of-range", algorithm,
                                     f"w_blk={w_blk} outside [1, o_w={o_w}]")])
    kernels: List[KernelGeometry] = []
    problems: List[Tuple[str, str, str]] = []
    if mode == "lowered":
        geo, probs = _lower_launch(i_n, i_h, i_w, i_c, k_w, s_w, o_w, limits)
        kernels.append(geo)
        problems += [(geo.name, r, m) for r, m in probs]
        kwic = k_w * i_c
        core = mec_conv.gemm_core((i_n, o_w, i_h, kwic), (k_h, kwic, k_c),
                                  k_h, s_h, w_blk)
        c_n, c_ih, c_iw, c_ic = core["inp"]
        c_kh, c_kw, _, c_kc = core["kernel"]
        c_sh, c_sw = core["stride"]
        c_oh, c_ow = core["out_shape"][1:3]
        geo, probs = mma_launch(3, dtype, c_n, c_ih, c_iw, c_ic, c_kh, c_kw,
                                c_kc, c_sh, c_sw, c_oh, c_ow, core["w_blk"],
                                core["oh_blk"], limits)
        name = "K3 gemm_kernel"
    else:
        w_blk_c = min(w_blk, o_w)
        oh_blk = min(ops.pick_oh_blk(o_h, o_w, w_blk, k_c, i_n), o_h)
        kind = KIND["mec_" + ("fused" if mode == "fused" else "fused2")]
        geo, probs = mma_launch(kind, dtype, i_n, i_h, i_w, i_c, k_h, k_w,
                                k_c, s_h, s_w, o_h, o_w, w_blk_c, oh_blk,
                                limits)
        name = "K1 fused_kernel" if kind == 1 else "K4 fused2_kernel"
    if geo is not None:
        kernels.append(geo)
    problems += [(name, r, m) for r, m in probs]
    return result(kernels, [Violation(r, k, m) for k, r, m in problems])


def check_plan(plan, *, limits: DeviceLimits = H100) -> PlanCheck:
    """Check a resolved plan (duck-typed: ``.spec``, ``.algorithm``,
    ``.w_blk``, ``.dtype``)."""
    return check_geometry(plan.spec, plan.algorithm, plan.w_blk, plan.dtype,
                          limits=limits)


def assert_plan(plan, *, limits: DeviceLimits = H100) -> PlanCheck:
    """:func:`check_plan`, raising :class:`LaunchCheckError` on a
    rejection: what ``plan_conv2d`` calls, so that no policy returns (and
    no cache stores) a kernel geometry the launcher would refuse."""
    result = check_plan(plan, limits=limits)
    if not result.ok:
        raise LaunchCheckError(
            "static launch check rejected the plan:\n" + result.render())
    return result
