"""Numerics contract checker: dtype flow and accumulation (counterpart of
``repro.analysis.numcheck``).

The paper's Table 2 trades memory and speed, never the result: im2col,
FFT, Winograd, the compact-L GEMMs and the CUDA kernels must compute the
same convolution.  For one algorithm x dtype this module extracts the
computation's **numeric signature** and holds it to the algorithm's
declared contract (``repro_torch.core.numerics.CONTRACTS``).

The JAX package reads the signature from a jaxpr.  Here one ``conv2d``
forward (``fwd``), and the gradient of ``sum(out^2)`` with it
(``grad``), are traced on meta tensors under a ``TorchDispatchMode``:
every aten contraction (``mm``, ``bmm``, ``addmm``, ``convolution``,
``convolution_backward``, ``_fft_*``) with its operand and output dtypes,
and every cast edge (``_to_copy``, and ``copy_`` between two dtypes),
each with the Python line that made it.  A loop runs one line many
times; like a jaxpr's equation, a line counts once (``scan`` bodies are
one equation there).  The kernels K1-K4 are called through ``ctypes``
and are opaque to the trace: on meta tensors their launch is the op
``repro_torch::kernel_call`` (``kernels.mec_conv``), recorded as one
contraction node with the accumulator their source instantiates (f32:
``csrc/mec_mma.cuh`` keeps every sum in f32, three TF32 products a
multiply-add for f32 operands) and, where the output is narrower, the
one in-kernel cast that writes it.  The casts around the launch are
traced like any other.  The rules:

* **disallowed-dtype** / **f64-leak**: a float or complex dtype outside
  the contract's set ({input dtype, f32}, complex64 for FFT).
* **accumulation**: a contraction with sub-f32 operands whose output is
  also sub-f32.
* **kernel-accum** (the JAX package's ``pallas-accum``): a kernel node
  whose declared accumulator is narrower than the contract's.
* **narrow-widen**: a value narrowed, then widened again with only
  data movement between (taint flows through views, copies and
  concatenation, never through arithmetic).
* **output-cast-count**: the forward narrows to a sub-f32 input dtype at
  exactly ``fwd_output_narrows`` lines.
* **error-budget**: a measured probe, forward and both gradients against
  an f64 oracle on fixed seeds (:func:`error_probe`).

Not ported here: the JAX package's HLO precision-flow pass
(``precision_flow_findings``) reads XLA's optimised HLO, which belongs
with the collective checker, ``shardcheck`` (ROADMAP Queue 1 item 11).
Every precision name computes alike in the port (f32 at f32 accuracy).

Wiring, as in the JAX package: ``plan_conv2d`` asserts the static
contract (:func:`assert_plan_numerics`, memoised); bench records carry a
reduced ``numcheck`` field (:func:`cell_numcheck`) that ``bench.check``
gates; ``python -m repro_torch.analysis --suite numcheck`` sweeps every
algorithm x {f32, bf16, f16} x {fwd, grad}.  Never imports
``repro_torch.plan`` (plans are duck-typed).
"""
from __future__ import annotations

import dataclasses
import functools
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.launch_check import KERNEL_ALGORITHMS
from repro_torch.core.numerics import (CONTRACT_DTYPES, NumericContract,
                                       contract_for, float_bits,
                                       fwd_tolerance, grad_tolerance)

DIRECTIONS = ("fwd", "grad")

#: executor algorithms the CLI suite sweeps (``conv2d``'s minus "auto")
NUMCHECK_ALGORITHMS = ("direct", "im2col", "fft", "winograd", "mec",
                       "mec_lowered", "mec_fused", "mec_fused2")
NUMCHECK_DTYPES = CONTRACT_DTYPES
#: the algorithms that run K1-K4 (whose geometry the launch check gates)
KERNEL_PATHS = KERNEL_ALGORITHMS

#: the accumulator each kernel's source instantiates, by C entry name
#: (``csrc/mec_mma.cuh``: f32 sums; ``mec_lower`` moves bytes)
KERNEL_ACCUM = {"mec_fused": "float32", "mec_fused2": "float32",
                "mec_gemm": "float32", "mec_lower": None}


def probe_spec():
    """The fixed geometry every contract budget is measured on: 3x3,
    stride 1 (so Winograd takes part), 27-long reductions."""
    from repro_torch.core.convspec import ConvSpec
    return ConvSpec(2, 16, 16, 3, 3, 3, 4, 1, 1)


#: aten ops that contract (their packet names)
_CONTRACTIONS = frozenset({
    "mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot", "vdot",
    "convolution", "convolution_backward", "_fft_r2c", "_fft_c2r",
    "_fft_c2c"})
#: aten ops that move data and keep a value's rounding history, the only
#: edges narrow-widen taint flows through
_STRUCTURAL = frozenset({
    "view", "_unsafe_view", "reshape", "permute", "transpose", "t",
    "expand", "squeeze", "unsqueeze", "slice", "select", "as_strided",
    "alias", "unfold", "clone", "contiguous", "cat", "stack", "flip",
    "constant_pad_nd", "copy_", "index_select", "split", "split_with_sizes",
    "unbind", "narrow", "detach", "lift_fresh"})

_COMPLEX_BITS = {"complex64": 64, "complex128": 128}


class NumCheckError(AssertionError):
    """An algorithm's trace broke its declared numeric contract."""


@dataclasses.dataclass(frozen=True)
class ContractViolation:
    rule: str          # disallowed-dtype | f64-leak | accumulation |
    #                    kernel-accum | narrow-widen | output-cast-count |
    #                    error-budget
    direction: str     # 'fwd' | 'grad' | 'static'
    message: str

    def render(self) -> str:
        return f"[{self.rule}] {self.direction}: {self.message}"


# ---------------------------------------------------------------------------
# numeric signature
# ---------------------------------------------------------------------------

def _is_complex(name: str) -> bool:
    return str(name) in _COMPLEX_BITS


def _is_inexact(name: str) -> bool:
    return float_bits(name) is not None or _is_complex(name)


def cast_kind(src: str, dst: str) -> str:
    """Classify one cast edge: narrow / widen / reformat (same-width
    float, e.g. bf16<->f16) / complexify / realify / complex-narrow /
    complex-widen / same / other (integer/bool)."""
    src, dst = str(src), str(dst)
    sb, db = float_bits(src), float_bits(dst)
    if sb is not None and db is not None:
        if db < sb:
            return "narrow"
        if db > sb:
            return "widen"
        return "same" if src == dst else "reformat"
    sc, dc = _is_complex(src), _is_complex(dst)
    if dc and not sc:
        return "complexify"
    if sc and not dc:
        return "realify"
    if sc and dc:
        s, d = _COMPLEX_BITS[src], _COMPLEX_BITS[dst]
        return "complex-narrow" if d < s else \
            "complex-widen" if d > s else "same"
    return "other"


def _dtype(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def _site() -> str:
    """The line a recorded op comes from: the innermost frame outside
    torch and this module."""
    import torch
    torch_dir = os.path.dirname(torch.__file__)
    f = sys._getframe(1)
    while f is not None:
        name = f.f_code.co_filename
        if not name.startswith(torch_dir) and name != __file__:
            return f"{name.rsplit('repro_torch', 1)[-1]}:{f.f_lineno}"
        f = f.f_back
    return "<torch>"


def _tensors(x):
    import torch
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _recorder_class():
    from torch.utils._python_dispatch import TorchDispatchMode

    class Recorder(TorchDispatchMode):
        """Every contraction, kernel launch and cast edge of a traced
        program, in order, with the narrow-widen taint carried along."""

        def __init__(self):
            super().__init__()
            self.dots: List[Dict] = []
            self.casts: List[Dict] = []
            self.narrow_widen: List[str] = []
            self._taint: Dict[int, Tuple[str, str]] = {}
            self._keep: list = []       # keeps ids of tainted tensors unique

        def _set_taint(self, tensors, hist):
            for t in tensors:
                self._taint[id(t)] = hist
                self._keep.append(t)

        def _cast(self, src, dst, site, tensor_in, tensors_out, kernel=False):
            kind = cast_kind(src, dst)
            self.casts.append({"src": src, "dst": dst, "kind": kind,
                               "site": site, "kernel": kernel})
            hist = None if tensor_in is None \
                else self._taint.get(id(tensor_in))
            if hist is not None and kind == "widen":
                self.narrow_widen.append(
                    f"a value narrowed {hist[0]}->{hist[1]} is widened back "
                    f"to {dst} at {site} with no compute between: the "
                    f"narrow rounded away what the widen cannot restore")
            if kind == "narrow":
                self._set_taint(tensors_out, (src, dst))
            elif kind in ("same", "reformat") and hist is not None:
                self._set_taint(tensors_out, hist)

        def __torch_dispatch__(self, func, _types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = func.overloadpacket.__name__
            outs = list(_tensors(out))
            if name == "kernel_call":
                self._kernel(args)
                return out
            if name in _CONTRACTIONS:
                ins = [t for t in _tensors((args, list(kwargs.values())))]
                self.dots.append({
                    "op": name, "operands": [_dtype(t) for t in ins],
                    "out": _dtype(outs[0]) if outs else None,
                    "kernel": False, "accum": None, "site": _site()})
            elif name == "_to_copy" and outs:
                self._cast(_dtype(args[0]), _dtype(outs[0]), _site(),
                           args[0], outs)
            elif name == "copy_" and args[0].dtype != args[1].dtype:
                self._cast(_dtype(args[1]), _dtype(args[0]), _site(),
                           args[1], [args[0]])
            elif name in _STRUCTURAL:
                ins = list(_tensors(args[1:] if name == "copy_" else args))
                hist = next((self._taint[id(t)] for t in ins
                             if id(t) in self._taint), None)
                if hist is not None:
                    self._set_taint(outs, hist)
            return out

        def _kernel(self, args):
            name, operands, out = args
            site = _site()
            accum = KERNEL_ACCUM[name]
            if accum is None:          # K2: data movement, no arithmetic
                hist = next((self._taint[id(t)] for t in operands
                             if id(t) in self._taint), None)
                if hist is not None:
                    self._set_taint([out], hist)
                return
            self.dots.append({
                "op": f"kernel:{name}",
                "operands": [_dtype(t) for t in operands], "out": accum,
                "kernel": True, "accum": accum, "site": site})
            if cast_kind(accum, _dtype(out)) == "narrow":
                # the kernel writes its f32 sums in the output's dtype
                self._cast(accum, _dtype(out), site, None, [out],
                           kernel=True)

    return Recorder


def trace(program) -> Dict:
    """The numeric signature of a nullary ``program`` (run on meta
    tensors): ``{dots, casts, narrow_widen}``, every record with the line
    that made it."""
    rec = _recorder_class()()
    with rec:
        program()
    return {"dots": rec.dots, "casts": rec.casts,
            "narrow_widen": rec.narrow_widen}


def trace_signature(spec, algorithm: str, dtype: str = "float32",
                    direction: str = "fwd", solution: str = "auto") -> Dict:
    """:func:`trace` of one direction of ``conv2d`` on ``spec``: the
    forward, or the forward with the gradient of ``sum(out^2)``."""
    import torch
    from repro_torch.core.conv_api import conv2d
    td = getattr(torch, dtype)
    grad = direction == "grad"

    def program():
        x = torch.empty((spec.i_n, spec.i_h, spec.i_w, spec.i_c), dtype=td,
                        device="meta", requires_grad=grad)
        k = torch.empty((spec.k_h, spec.k_w, spec.i_c, spec.k_c), dtype=td,
                        device="meta", requires_grad=grad)
        out = conv2d(x, k, stride=(spec.s_h, spec.s_w), algorithm=algorithm,
                     solution=solution)
        if grad:
            torch.autograd.grad((out * out).sum(), (x, k))

    # the gradient trace holds whatever the caller's grad mode (a plan made
    # inside a serving loop's inference mode)
    with torch.inference_mode(False), torch.enable_grad():
        return trace(program)


def _render_dot(d: Dict) -> str:
    return (f"{d['op']}({' x '.join(d['operands'])} -> {d['out']}) "
            f"at {d['site']}")


def _static_sites(records: Sequence[Dict], keys: Tuple[str, ...]):
    """One record per line and dtype flow: a loop's repeats count once."""
    seen = {}
    for r in records:
        seen.setdefault(tuple(r[k] if not isinstance(r[k], list)
                              else tuple(r[k]) for k in keys), r)
    return list(seen.values())


def signature_findings(sig: Dict, contract: NumericContract,
                       direction: str,
                       input_dtype: str) -> List[ContractViolation]:
    """The static rules over one direction's numeric signature."""
    out: List[ContractViolation] = []
    allowed = set(contract.allowed_dtypes(input_dtype))
    accum_bits = float_bits(contract.accum_dtype) or 32
    flagged = set()

    def check_dtype(name: str, where: str):
        if name is None or name in allowed or not _is_inexact(name):
            return
        if (where, name) in flagged:
            return
        flagged.add((where, name))
        if name in ("float64", "complex128") and not contract.allow_f64:
            out.append(ContractViolation(
                "f64-leak", direction,
                f"{where} touches {name}: the contract bans f64 (an "
                f"unintended promotion, not accuracy the backend claims)"))
        else:
            out.append(ContractViolation(
                "disallowed-dtype", direction,
                f"{where} touches {name}; a {input_dtype} "
                f"{contract.algorithm} program may only use "
                f"{sorted(allowed)}: a stray cast re-rounds the value"))

    dots = _static_sites(sig["dots"], ("site", "op", "operands", "out"))
    casts = _static_sites(sig["casts"], ("site", "src", "dst"))
    for d in dots:
        where = _render_dot(d)
        for o in d["operands"] + [d["out"]]:
            check_dtype(o, where)
        sub = [o for o in d["operands"] if (float_bits(o) or 99) < accum_bits]
        out_bits = float_bits(d["out"])
        if sub and out_bits is not None and out_bits < accum_bits:
            out.append(ContractViolation(
                "accumulation", direction,
                f"{where} accumulates below {contract.accum_dtype}: "
                f"sub-{contract.accum_dtype} operands must be summed in "
                f"{contract.accum_dtype}"))
        if d["kernel"] and (float_bits(d["accum"]) or 0) < accum_bits:
            out.append(ContractViolation(
                "kernel-accum", direction,
                f"{where}: the kernel's source keeps {d['accum']} sums, "
                f"below the contract's {contract.accum_dtype}"))
    for c in casts:
        where = f"cast({c['src']} -> {c['dst']}) at {c['site']}"
        check_dtype(c["src"], where)
        check_dtype(c["dst"], where)
    in_bits = float_bits(input_dtype)
    if direction == "fwd" and in_bits is not None and in_bits < accum_bits:
        narrows = [c for c in casts
                   if c["kind"] == "narrow" and c["dst"] == input_dtype]
        if len(narrows) != contract.fwd_output_narrows:
            sites = ", ".join(c["site"] for c in narrows) or "none"
            out.append(ContractViolation(
                "output-cast-count", direction,
                f"forward narrows to {input_dtype} at {len(narrows)} "
                f"line(s) ({sites}); the contract says exactly "
                f"{contract.fwd_output_narrows}: fewer means the sum never "
                f"narrowed, more means double rounding"))
    for msg in dict.fromkeys(sig["narrow_widen"]):
        out.append(ContractViolation("narrow-widen", direction, msg))
    return out


# ---------------------------------------------------------------------------
# f64 reference + error probe
# ---------------------------------------------------------------------------

def f64_conv2d(x64, k64, s_h: int, s_w: int):
    """The f64 numpy oracle: direct valid convolution, NHWC x HWIO ->
    NHWC (``repro.analysis.numcheck.f64_conv2d``, copied)."""
    import numpy as np
    i_h, i_w = x64.shape[1], x64.shape[2]
    k_h, k_w = k64.shape[0], k64.shape[1]
    o_h = (i_h - k_h) // s_h + 1
    o_w = (i_w - k_w) // s_w + 1
    out = np.zeros((x64.shape[0], o_h, o_w, k64.shape[3]), np.float64)
    for r in range(k_h):
        for c in range(k_w):
            xs = x64[:, r:r + s_h * (o_h - 1) + 1:s_h,
                     c:c + s_w * (o_w - 1) + 1:s_w, :]
            out += np.einsum("nhwc,co->nhwo", xs, k64[r, c])
    return out


def f64_conv2d_grads(x64, k64, g64, s_h: int, s_w: int):
    """``(dL/dx, dL/dk)`` for cotangent ``g64``, same oracle (copied)."""
    import numpy as np
    k_h, k_w = k64.shape[0], k64.shape[1]
    o_h, o_w = g64.shape[1], g64.shape[2]
    dx = np.zeros_like(x64)
    dk = np.zeros_like(k64)
    for r in range(k_h):
        for c in range(k_w):
            sl_h = slice(r, r + s_h * (o_h - 1) + 1, s_h)
            sl_w = slice(c, c + s_w * (o_w - 1) + 1, s_w)
            xs = x64[:, sl_h, sl_w, :]
            dk[r, c] = np.einsum("nhwc,nhwo->co", xs, g64)
            dx[:, sl_h, sl_w, :] += np.einsum("nhwo,co->nhwc", g64, k64[r, c])
    return dx, dk


def _rel_err(got, ref) -> float:
    import numpy as np
    got = np.asarray(got).astype(np.float64)
    denom = max(float(np.max(np.abs(ref))), 1e-30)
    return float(np.max(np.abs(got - ref)) / denom)


def _torch_oracle(x, k, stride):
    """The same oracle in f64 on the operands' device (``F.conv2d`` and
    its autograd), for geometries too large for numpy: output and the
    gradients for cotangent 2 * output."""
    import torch
    import torch.nn.functional as F
    x64 = x.detach().double().permute(0, 3, 1, 2).requires_grad_()
    k64 = k.detach().double().permute(3, 2, 0, 1).requires_grad_()
    out = F.conv2d(x64, k64, stride=stride)
    dx, dk = torch.autograd.grad(out, (x64, k64), 2.0 * out.detach())
    return (out.detach().permute(0, 2, 3, 1).cpu().numpy(),
            dx.permute(0, 2, 3, 1).cpu().numpy(),
            dk.permute(2, 3, 1, 0).cpu().numpy())


def error_probe(spec, algorithm: str, dtype: str = "float32", *,
                solution: str = "auto", device: str = "cpu", seed: int = 0,
                oracle: str = "numpy") -> Dict:
    """Measured forward and gradient error against the f64 oracle on
    fixed seeds, through ``repro_torch.core.conv2d`` on ``device``.

    The oracle consumes the dtype-quantised inputs widened to f64, so the
    error is the algorithm's, not the inputs' rounding.  The gradient is
    that of ``sum(out^2)``, its cotangent quantised at the input dtype.
    ``oracle``: "numpy" (:func:`f64_conv2d`, the JAX package's) or
    "torch" (the same in f64 on ``device``, for full widths).  Runs with
    gradients on whatever the caller's grad mode."""
    import torch
    with torch.inference_mode(False), torch.enable_grad():
        return _error_probe(spec, algorithm, dtype, solution, device, seed,
                            oracle)


def _error_probe(spec, algorithm, dtype, solution, device, seed, oracle):
    import numpy as np
    import torch
    from repro_torch.core.conv_api import conv2d
    from repro_torch.core.direct import ieee_f32_conv
    rng = np.random.RandomState(seed)
    td = getattr(torch, dtype)
    x = torch.from_numpy(rng.randn(spec.i_n, spec.i_h, spec.i_w, spec.i_c)
                         .astype(np.float32)).to(device, td)
    k = torch.from_numpy(rng.randn(spec.k_h, spec.k_w, spec.i_c, spec.k_c)
                         .astype(np.float32)).to(device, td)
    stride = (spec.s_h, spec.s_w)
    x.requires_grad_()
    k.requires_grad_()
    out = conv2d(x, k, stride=stride, algorithm=algorithm, solution=solution)
    din, dk = torch.autograd.grad((out * out).sum(), (x, k))
    got = [t.detach().float().cpu().numpy() for t in (out, din, dk)]
    if oracle == "torch":
        with ieee_f32_conv():
            out64, dx64, dk64 = _torch_oracle(x, k, stride)
    else:
        x64 = x.detach().double().cpu().numpy()
        k64 = k.detach().double().cpu().numpy()
        out64 = f64_conv2d(x64, k64, spec.s_h, spec.s_w)
        dx64, dk64 = f64_conv2d_grads(x64, k64, 2.0 * out64, spec.s_h,
                                      spec.s_w)
    return {"seed": seed,
            "fwd_err": _rel_err(got[0], out64),
            "din_err": _rel_err(got[1], dx64),
            "dk_err": _rel_err(got[2], dk64)}


def probe_budgets(spec, algorithm: str, dtype: str,
                  scaled: bool) -> Tuple[float, float, float]:
    """(fwd, d_input, d_kernel) budgets: the contract's own (``scaled``
    False, the probe spec's), or scaled to the spec's reduction lengths
    (``core.numerics.fwd_tolerance`` / ``grad_tolerance``)."""
    if not scaled:
        c = contract_for(algorithm)
        return (c.tolerance(dtype, "fwd"), c.tolerance(dtype, "grad"),
                c.tolerance(dtype, "grad"))
    return (fwd_tolerance(algorithm, dtype, spec.k_h * spec.k_w * spec.i_c),
            grad_tolerance(algorithm, dtype, spec.k_h * spec.k_w * spec.k_c),
            grad_tolerance(algorithm, dtype, spec.i_n * spec.o_h * spec.o_w))


# ---------------------------------------------------------------------------
# the checker
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class NumCheck:
    """Verdict of one (algorithm, dtype) numeric-contract check.
    ``record`` is the JSON-able evidence reports embed; ``skipped`` the
    reason a cell cannot be checked (no contract, a geometry the
    algorithm or the launcher refuses): a skip is not a pass."""

    algorithm: str
    dtype: str
    violations: List[ContractViolation]
    record: Dict
    skipped: Optional[str] = None

    @property
    def ok(self) -> bool:
        return not self.violations

    def render(self) -> str:
        lines = [f"numcheck {self.algorithm}/{self.dtype}: "
                 f"{self.record.get('verdict')}"]
        if self.skipped:
            lines.append(f"  skipped: {self.skipped}")
        lines += [f"  {v.render()}" for v in self.violations]
        return "\n".join(lines)


def check_numerics(spec, algorithm: str, dtype: str = "float32", *,
                   solution: str = "auto",
                   directions: Sequence[str] = DIRECTIONS,
                   probe: bool = True, device: str = "cpu", seed: int = 0,
                   oracle: str = "numpy", scaled: bool = False) -> NumCheck:
    """The numeric-contract check of one algorithm x dtype cell: the
    static rules over each direction's traced signature, then, with
    ``probe``, the measured error against the f64 oracle on ``device``
    (budgets: :func:`probe_budgets`)."""
    contract = contract_for(algorithm)
    record: Dict = {
        "algorithm": algorithm, "dtype": dtype,
        "contract": None if contract is None else contract.to_dict(),
        "directions": {}, "precision_flow": None, "probe": None,
        "verdict": "pass", "skipped_reason": None, "violations": []}

    def skipped(reason: str) -> NumCheck:
        record["verdict"] = "skipped"
        record["skipped_reason"] = reason
        return NumCheck(algorithm, dtype, [], record, skipped=reason)

    if contract is None:
        return skipped(f"no numeric contract declared for {algorithm!r} "
                       f"(repro_torch.core.numerics.CONTRACTS)")
    if dtype not in CONTRACT_DTYPES:
        return skipped(f"no contract dtype {dtype!r} (contract dtypes: "
                       f"{CONTRACT_DTYPES})")
    if algorithm == "winograd" and \
            (spec.k_h, spec.k_w, spec.s_h, spec.s_w) != (3, 3, 1, 1):
        return skipped("winograd F(2x2,3x3) requires a 3x3 kernel and "
                       "stride 1")
    if algorithm in KERNEL_PATHS:
        from repro_torch.analysis.launch_check import check_geometry
        geo = check_geometry(spec, algorithm, None, dtype)
        if not geo.ok:
            return skipped(f"launch check rejected: {geo.render()}")

    violations: List[ContractViolation] = []
    for direction in directions:
        sig = trace_signature(spec, algorithm, dtype, direction, solution)
        violations += signature_findings(sig, contract, direction, dtype)
        record["directions"][direction] = {
            "dots": len(_static_sites(sig["dots"],
                                      ("site", "op", "operands", "out"))),
            "kernel_dots": sum(1 for d in sig["dots"] if d["kernel"]),
            "casts": len(_static_sites(sig["casts"], ("site", "src", "dst"))),
            "narrows_to_input": len([
                c for c in _static_sites(sig["casts"], ("site", "src", "dst"))
                if c["kind"] == "narrow" and c["dst"] == dtype]),
        }
    if probe:
        errs = error_probe(spec, algorithm, dtype, solution=solution,
                           device=device, seed=seed, oracle=oracle)
        tol_fwd, tol_din, tol_dk = probe_budgets(spec, algorithm, dtype,
                                                 scaled)
        record["probe"] = dict(errs, budget_fwd=tol_fwd, budget_grad=tol_din,
                               budget_grad_kernel=tol_dk, device=device)
        for label, err, tol in (("fwd", errs["fwd_err"], tol_fwd),
                                ("grad(d_input)", errs["din_err"], tol_din),
                                ("grad(d_kernel)", errs["dk_err"], tol_dk)):
            if tol is not None and err > tol:
                violations.append(ContractViolation(
                    "error-budget", "fwd" if label == "fwd" else "grad",
                    f"{label} error {err:.3e} against the f64 oracle exceeds "
                    f"the contract budget {tol:.1e} for {algorithm}/{dtype} "
                    f"(seed {errs['seed']}, {device})"))
    record["violations"] = [v.render() for v in violations]
    record["verdict"] = "pass" if not violations else "fail"
    return NumCheck(algorithm, dtype, violations, record)


# ---------------------------------------------------------------------------
# bench + plan wiring (duck-typed; repro_torch.plan imports this module,
# never the reverse)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def _static_check(spec, algorithm: str, dtype: str,
                  solution: str) -> NumCheck:
    return check_numerics(spec, algorithm, dtype, solution=solution,
                          probe=False)


def cell_numcheck(spec, algorithm: str, dtype: str, *,
                  solution: str = "auto") -> Dict:
    """The reduced static verdict of one bench cell (no probe: the bench
    pays no extra execution a cell), memoised: verdict, skip reason and
    rendered violations."""
    rec = _static_check(spec, algorithm, str(dtype), solution).record
    return {"verdict": rec["verdict"],
            "skipped_reason": rec["skipped_reason"],
            "violations": list(rec["violations"])}


def assert_plan_numerics(plan) -> None:
    """The ``plan_conv2d`` hook: raise :class:`NumCheckError` when the
    plan's algorithm x dtype breaks its static contract.  Static only
    (meta tensors, no probe) and memoised by (spec, dtype, algorithm,
    solution); a skipped check (no contract for the dtype) passes here,
    the CLI suite shows skips.  Every precision name computes alike in
    the port, so the precision is not part of the key."""
    algorithm = getattr(plan, "algorithm", None)
    if algorithm in (None, "auto"):
        return
    result = _static_check(plan.spec, algorithm,
                           str(getattr(plan, "dtype", "float32")),
                           getattr(plan, "solution", "auto"))
    if not result.ok:
        raise NumCheckError(result.render())
