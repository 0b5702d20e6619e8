"""Serving layer (counterpart of ``repro.serving``): plan-driven conv
serving.

* :mod:`repro_torch.serving.conv_service`: bounded padded shape classes,
  one warm :class:`~repro_torch.plan.ConvPlan` per class, a class
  executor per class (a captured CUDA graph on the card), best-effort
  plan-cache warmup; the whisper mel and ViT patch-embed frontends.

The JAX package's continuous-batching scheduler (``ContinuousBatcher``,
``Request``, ``repro.serving.scheduler``) is ported with the dense and
vlm families (ROADMAP Queue 1 item 10).

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

__all__ = [
    "ConvService", "ShapeClass", "WarmupReport", "parse_shape_classes",
    "fit_prefix", "whisper_frontend_kernels", "whisper_frontend_service",
    "patch_embed_service",
]
