"""Models (counterpart of ``repro.models``): layers, the Mamba2, xLSTM and
MoE blocks, the LM assembly and its serving paths."""
