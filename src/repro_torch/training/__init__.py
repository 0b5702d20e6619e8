"""Training (counterpart of ``repro.training``): the chunked loss, the
step builders and the step watchdog."""
