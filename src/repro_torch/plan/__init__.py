"""Planner, plan cache and calibration (counterpart of ``repro.plan``).

``plan_conv2d`` turns a :class:`~repro_torch.core.convspec.ConvSpec` into a
frozen :class:`ConvPlan` under one of three policies (analytic, measured,
cached); ``conv2d(..., plan=)`` executes it exactly.  The process and
disk plan cache lives in :mod:`repro_torch.plan.cache`, the fitted
costmodel's store in :mod:`repro_torch.plan.calibrate`.
"""
from repro_torch.plan.cache import (PlanCache, global_plan_cache,
                                    plan_cache_dir, reset_global_plan_cache)
from repro_torch.plan.calibrate import (CALIBRATION_ENV, Calibration,
                                        CalibrationStore, calibration_path,
                                        current_calibration,
                                        reset_calibration_cache)
from repro_torch.plan.convplan import (MEASURED_NOISE_MARGIN, PLAN_MODES,
                                       PLAN_VERSION, ConvPlan,
                                       MeasuredCandidates,
                                       eligible_candidates,
                                       measure_candidates,
                                       measure_candidates_detailed,
                                       pick_measured, plan_cache_key,
                                       plan_conv2d, resolve_cached_plan,
                                       spec_key, tune_measured)

__all__ = [
    "ConvPlan", "plan_conv2d", "resolve_cached_plan", "measure_candidates",
    "measure_candidates_detailed", "MeasuredCandidates", "tune_measured",
    "pick_measured", "eligible_candidates", "spec_key", "plan_cache_key",
    "MEASURED_NOISE_MARGIN", "PLAN_MODES", "PLAN_VERSION",
    "PlanCache", "global_plan_cache", "plan_cache_dir",
    "reset_global_plan_cache",
    "Calibration", "CalibrationStore", "CALIBRATION_ENV",
    "calibration_path", "current_calibration", "reset_calibration_cache",
]
