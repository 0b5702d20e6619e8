"""Launchers (counterpart of ``repro.launch``): the costmodel and the
serving launcher."""
