"""Per-backend numeric contracts, copied from ``repro.core.numerics``.

Each backend declares the accumulation width its GEMMs keep, how often
its forward narrows back to the input dtype, and an error budget: a
scale-normalized max error (``max|y-ref| / max|ref|``) against an f64
reference, measured on the JAX package's probe spec (reduction length
k_h*k_w*i_c = 27).  The port's tests and ``chip_smoke.py`` take their
tolerances from these budgets; :func:`fwd_tolerance` scales them to
other reduction lengths.

Pure data + stdlib.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

#: dtypes every backend must hold a contract (and budget) for.
CONTRACT_DTYPES = ("float32", "bfloat16", "float16")

_FLOAT_BITS = {"float16": 16, "bfloat16": 16, "float32": 32, "float64": 64}

#: reduction length (k_h*k_w*i_c) of the spec the budgets were measured on
PROBE_REDUCTION = 27


@dataclasses.dataclass(frozen=True)
class NumericContract:
    """The declared dtype-flow rules for one conv backend.

    ``error_budget`` maps dtype -> {"fwd": tol, "grad": tol}; a dtype
    missing from the map means the backend makes no accuracy claim there.
    """

    algorithm: str
    #: minimum accumulation dtype for contractions with sub-f32 operands
    accum_dtype: str = "float32"
    #: complex64 admitted beside f32 compute (FFT round-trip only)
    complex_pair: bool = False
    #: narrowing casts back to the input dtype in the *forward* program
    #: when the input is sub-f32 (f32 inputs must narrow zero times)
    fwd_output_narrows: int = 1
    #: f64/complex128 are never part of the contract
    allow_f64: bool = False
    #: scale-normalized max-error budget vs the f64 reference
    error_budget: Mapping[str, Mapping[str, float]] = \
        dataclasses.field(default_factory=dict)

    def allowed_dtypes(self, input_dtype: str) -> Tuple[str, ...]:
        """Float/complex dtypes a program on ``input_dtype`` may touch."""
        allowed = {input_dtype, self.accum_dtype}
        if self.complex_pair:
            allowed.add("complex64")
        return tuple(sorted(allowed))

    def tolerance(self, dtype: str, direction: str) -> Optional[float]:
        budget = self.error_budget.get(dtype)
        return None if budget is None else budget.get(direction)

    def to_dict(self) -> Dict:
        return {
            "algorithm": self.algorithm,
            "accum_dtype": self.accum_dtype,
            "complex_pair": self.complex_pair,
            "fwd_output_narrows": self.fwd_output_narrows,
            "allow_f64": self.allow_f64,
            "error_budget": {d: dict(b)
                             for d, b in sorted(self.error_budget.items())},
        }


def float_bits(dtype: str) -> Optional[int]:
    """Float width in bits; None for non-float dtypes."""
    return _FLOAT_BITS.get(str(dtype))


# Budgets measured by the JAX package on its probe spec at seed 0, with
# ~4x headroom over the worst observed backend.
_F32 = {"fwd": 1e-6, "grad": 2e-6}
_F32_FFT = {"fwd": 2e-6, "grad": 4e-6}
_BF16 = {"fwd": 1.2e-2, "grad": 2.5e-2}
_F16 = {"fwd": 1.2e-3, "grad": 2e-3}

_MEC_BUDGET = {"float32": _F32, "bfloat16": _BF16, "float16": _F16}

CONTRACTS: Dict[str, NumericContract] = {
    "direct": NumericContract(
        "direct",
        error_budget={"float32": _F32, "bfloat16": _BF16, "float16": _F16}),
    "im2col": NumericContract(
        "im2col",
        error_budget={"float32": _F32, "bfloat16": _BF16, "float16": _F16}),
    "fft": NumericContract(
        "fft", complex_pair=True,
        error_budget={"float32": _F32_FFT, "bfloat16": _BF16,
                      "float16": _F16}),
    "winograd": NumericContract(
        "winograd",
        error_budget={"float32": _F32_FFT, "bfloat16": _BF16,
                      "float16": _F16}),
    "mec": NumericContract("mec", error_budget=_MEC_BUDGET),
    "mec_lowered": NumericContract("mec_lowered", error_budget=_MEC_BUDGET),
    "mec_fused": NumericContract("mec_fused", error_budget=_MEC_BUDGET),
    "mec_fused2": NumericContract("mec_fused2", error_budget=_MEC_BUDGET),
}


def contract_for(algorithm: str) -> Optional[NumericContract]:
    """The declared contract, or None for unregistered backends."""
    return CONTRACTS.get(algorithm)


def _scaled_budget(algorithm: str, dtype: str, direction: str,
                   reduction: int) -> float:
    budget = CONTRACTS[algorithm].tolerance(dtype, direction)
    if budget is None:
        raise KeyError(f"{algorithm} declares no {direction} budget for "
                       f"{dtype}")
    if dtype == "float32":
        return budget * max(1.0, math.sqrt(reduction / PROBE_REDUCTION))
    return budget


def fwd_tolerance(algorithm: str, dtype: str, reduction: int) -> float:
    """Forward tolerance against an f64 oracle for a conv whose reduction
    length is ``reduction`` (= k_h*k_w*i_c).

    f32 rounding in a K-term sum grows like sqrt(K), so the f32 budget is
    scaled by max(1, sqrt(K/27)).  For bf16/f16 the error is the final
    rounding to the input dtype, not the sum, so the budget stands as is
    (the oracle is computed from the same quantized inputs, upcast).
    """
    return _scaled_budget(algorithm, dtype, "fwd", reduction)


def grad_tolerance(algorithm: str, dtype: str, reduction: int) -> float:
    """Gradient tolerance against an f64 oracle, the contract's "grad"
    budget scaled as :func:`fwd_tolerance` scales "fwd": f32 by
    max(1, sqrt(R/27)), bf16/f16 as is.  R is the reduction length of
    that gradient: k_h*k_w*k_c for d_input, i_n*o_h*o_w for d_kernel.
    """
    return _scaled_budget(algorithm, dtype, "grad", reduction)
