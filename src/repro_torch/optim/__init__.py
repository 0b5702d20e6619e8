"""Optimizers (counterpart of ``repro.optim``): AdamW."""
from repro_torch.optim import adamw

__all__ = ["adamw"]
