"""Analysis (counterpart of ``repro.analysis``): so far the memory
auditor, :mod:`repro_torch.analysis.memaudit` (the allocator's bytes
against the paper's Eqs. 2-4).  The JAX package's other suites
(``pallas_check``, ``numcheck``, ``lint``, ``shardcheck``) are ROADMAP
Queue 1 items 9 and 11.

CLI: ``python -m repro_torch.analysis --suite memaudit [--device cpu]``.
"""
