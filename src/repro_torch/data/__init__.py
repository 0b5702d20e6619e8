"""Data (counterpart of ``repro.data``): the synthetic LM pipeline."""
