"""Model configurations: the ten architectures and their smoke variants
(counterpart of ``repro.configs``)."""
