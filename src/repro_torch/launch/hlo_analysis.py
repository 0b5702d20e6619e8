"""The card's constants, the roofline terms, and what a program moves and
computes (counterpart of ``repro.launch.hlo_analysis``).

PyTorch compiles no HLO, so the two counts the JAX package reads from
partitioned HLO are taken from the program as it runs:

* :func:`collective_bytes` is a context manager that tallies the
  collectives this rank hands ``torch.distributed`` through
  ``parallel.comm`` (every collective of the port goes through it), by the
  JAX package's kinds and with its operand-size convention: an all-gather
  counts its operand (the rank's part, not the result), a reduce-scatter
  its whole operand, the others the tensor they move; point-to-point sends
  are ``collective-permute``.
* :func:`flops_bytes` runs a program under
  ``torch.utils.flop_counter.FlopCounterMode``, with a formula for
  ``repro_torch::kernel_call``, so a K1-K6 launch traced on meta tensors
  counts its own arithmetic (K2 moves bytes and counts none).

The constants are the H100 SXM's data sheet: nothing here measures them.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, Iterator

#: dense bf16 tensor-core peak, FLOP/s (H100 SXM data sheet)
PEAK_FLOPS = 989e12
#: device-memory bandwidth, bytes/s (H100 SXM data sheet)
HBM_BW = 3.35e12
#: NVLink bandwidth in each direction, bytes/s (H100 SXM data sheet)
ICI_BW = 450e9
#: where the three constants come from
SOURCE = "H100 SXM data sheet"

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")


def _empty() -> Dict[str, int]:
    out = {k: 0 for k in COLLECTIVE_KINDS}
    out["count"] = 0
    return out


@contextlib.contextmanager
def collective_bytes() -> Iterator[Dict[str, int]]:
    """``with collective_bytes() as c:`` tallies into ``c`` the operand
    bytes of each collective kind this rank starts inside the block, and
    their ``count``; on exit ``c["total"]`` is the sum over kinds.
    Counters nest: each open one sees every collective."""
    from repro_torch.parallel import comm
    counter = _empty()
    comm.COUNTERS.append(counter)
    try:
        yield counter
    finally:
        comm.COUNTERS.remove(counter)
        counter["total"] = sum(counter[k] for k in COLLECTIVE_KINDS)


def kernel_flops(name: str, operands, out) -> int:
    """The arithmetic of one kernel launch (multiply and add counted
    apart), from its operands' and output's shapes: K1, K4 and K3
    2·N·o_h·o_w·k_h·k_w·i_c·k_c (K3 over its o_h shifted GEMMs, the same
    sum), K6 the same over its dW and cotangent, K2 0, K5 2·n·t·c·k_w."""
    if name == "mec_wgrad":
        g = operands[1]           # (n, o_h, o_w, k_c); out dW (k_h, k_w, i_c, k_c)
        return 2 * out.numel() * (g.numel() // g.shape[-1])
    if name in ("mec_fused", "mec_fused2"):
        k_h, k_w, i_c, _ = operands[1].shape
        return 2 * out.numel() * k_h * k_w * i_c
    if name == "mec_gemm":
        low, kernel = operands
        # L (n, o_w, i_h, k_w*i_c), K (k_h, k_w*i_c, k_c) -> (n, o_h, o_w, k_c)
        return 2 * out.numel() * kernel.shape[0] * low.shape[-1]
    if name == "mec_conv1d":
        return 2 * out.numel() * operands[1].shape[0]
    if name == "mec_lower":
        return 0
    raise ValueError(f"no flop formula for kernel {name!r}")


@functools.lru_cache(maxsize=None)
def _register_kernel_formula() -> None:
    """Give ``FlopCounterMode`` the kernels' formula, once a process."""
    import torch
    from torch.utils.flop_counter import register_flop_formula

    import repro_torch.kernels.mec_conv  # noqa: F401  (defines the op)

    # get_raw: the op's own arguments (its name is a string), and the
    # counter's out_val, which a launch's arithmetic does not need
    @register_flop_formula(torch.ops.repro_torch.kernel_call, get_raw=True)
    def _kernel_call_flops(name, operands, out, *args, **kwargs):
        return kernel_flops(name, operands, out)


def flops_bytes(program: Callable[[], object]) -> Dict[str, float]:
    """``{flops, bytes_accessed}`` of running ``program()`` (the
    counterpart of ``hlo_flops_bytes``): FLOPs by ``FlopCounterMode``
    (matmuls, convolutions, attention and the kernels' launches on meta
    tensors).  ``bytes_accessed`` is 0.0: no op-level byte count exists
    here, as the JAX package reports 0.0 where its backend has no cost
    model."""
    from torch.utils.flop_counter import FlopCounterMode
    _register_kernel_formula()
    mode = FlopCounterMode(display=False)
    with mode:
        program()
    return {"flops": float(mode.get_total_flops()), "bytes_accessed": 0.0}


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   n_chips: int) -> Dict[str, float]:
    """The three roofline terms in seconds at the card's constants, and the
    dominant one: whole-program totals over ``n_chips`` (per-chip inputs
    with ``n_chips=1``)."""
    t_compute = flops / (n_chips * PEAK_FLOPS)
    t_memory = hbm_bytes / (n_chips * HBM_BW)
    t_coll = coll_bytes / (n_chips * ICI_BW)
    dominant = max((t_compute, "compute"), (t_memory, "memory"),
                   (t_coll, "collective"))[1]
    return {"t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": t_coll, "dominant": dominant}
