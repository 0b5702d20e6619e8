"""Checkpoints (counterpart of ``repro.ckpt``): the checkpoint manager."""
