"""End-to-end examples (counterpart of the repository's ``examples/``)."""
