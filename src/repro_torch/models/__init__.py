"""Models (counterpart of ``repro.models``): layers, the Mamba2 block, the
LM assembly and its serving paths."""
