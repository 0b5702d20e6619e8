"""Launchers (counterpart of ``repro.launch``): the costmodel, the serving
launcher and the training launcher."""
