"""Serving layer (counterpart of ``repro.serving``): plan-driven conv
serving, continuous batching and the captured decode step.

* :mod:`repro_torch.serving.conv_service`: bounded padded shape classes,
  one warm :class:`~repro_torch.plan.ConvPlan` per class, a class
  executor per class (a captured CUDA graph on the card), best-effort
  plan-cache warmup; the whisper mel and ViT patch-embed frontends.
* :mod:`repro_torch.serving.scheduler`: ``ContinuousBatcher`` and
  ``Request`` (dense and vlm families), the per-slot decode step and the
  pool.
* :mod:`repro_torch.serving.step_graph`: ``DecodeProgram``, a decode step
  over fixed buffers, one CUDA-graph replay a call on the card.

CLI::

  PYTHONPATH=src python -m repro_torch.serving --warmup-report \\
      --shape-classes 1x32x32,4x64x64 [--device cpu]
"""
from repro_torch.serving.conv_service import (ConvService, ShapeClass,
                                              WarmupReport, fit_prefix,
                                              parse_shape_classes,
                                              patch_embed_service,
                                              whisper_frontend_kernels,
                                              whisper_frontend_service)
from repro_torch.serving.scheduler import (ContinuousBatcher, Request,
                                           batched_decode_step, init_pool,
                                           insert_prefill)
from repro_torch.serving.step_graph import DecodeProgram

__all__ = [
    "ConvService", "ShapeClass", "WarmupReport", "parse_shape_classes",
    "fit_prefix", "whisper_frontend_kernels", "whisper_frontend_service",
    "patch_embed_service", "ContinuousBatcher", "Request",
    "batched_decode_step", "init_pool", "insert_prefill", "DecodeProgram",
]
