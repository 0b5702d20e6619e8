"""Benchmark subsystem (counterpart of ``repro.bench``).

* :mod:`repro_torch.bench.scenarios`: the scenario registry (paper
  Table 2, the Table 3 ResNet-101 weighted set, the Fig 4(a) k/s sweep,
  batch/channel/dtype diversity, ``smoke``), timed at the paper's full
  widths;
* :mod:`repro_torch.bench.harness`: operands, the device timer, one
  record per (scenario, algorithm) cell, suites and the autotune
  comparison;
* :mod:`repro_torch.bench.report`: the report schema, environment
  fingerprint, validation and CSV;
* :mod:`repro_torch.bench.check`: comparison against a baseline.

CLI: ``python -m repro_torch.bench --suite smoke [--device cpu]``.
"""
from repro_torch.bench.harness import run_autotune, run_serve, run_suite
from repro_torch.bench.report import render_csv, validate_report, write_report
from repro_torch.bench.scenarios import (ALGORITHM_VARIANTS, CV_LAYERS,
                                         RESNET101_WEIGHTS, SUITES, Scenario,
                                         resolve_suite)

__all__ = [
    "ALGORITHM_VARIANTS", "CV_LAYERS", "RESNET101_WEIGHTS", "SUITES",
    "Scenario", "render_csv", "resolve_suite", "run_autotune", "run_serve",
    "run_suite", "validate_report", "write_report",
]
