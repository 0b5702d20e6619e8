"""Analysis (counterpart of ``repro.analysis``): static and measured
verification of the port's claims.

* :mod:`repro_torch.analysis.memaudit`: the allocator's bytes against the
  paper's Eqs. 2-4.
* :mod:`repro_torch.analysis.launch_check`: the launcher's choices
  mirrored without a card (the JAX package's ``pallas_check``).
* :mod:`repro_torch.analysis.numcheck`: the numeric contract (dtype flow,
  accumulators, the precision-flow pass, the f64 error probe).
* :mod:`repro_torch.analysis.lint`: AST invariants.
* :mod:`repro_torch.analysis.shardcheck`: the collective contract of a
  partitioned conv, counted on ranks.

CLI: ``python -m repro_torch.analysis --suite
memaudit|launch|lint|numcheck|shardcheck|all [--device cpu]``.

Exports resolve lazily (PEP 562): importing the package imports none of
its submodules.
"""
import importlib

_EXPORTS = {
    "Finding": "repro_torch.analysis.lint",
    "lint_file": "repro_torch.analysis.lint",
    "lint_tree": "repro_torch.analysis.lint",
    "TOLERANCES": "repro_torch.analysis.memaudit",
    "audit_plan": "repro_torch.analysis.memaudit",
    "run_audit": "repro_torch.analysis.memaudit",
    "assert_plan": "repro_torch.analysis.launch_check",
    "check_geometry": "repro_torch.analysis.launch_check",
    "check_plan": "repro_torch.analysis.launch_check",
    "ContractViolation": "repro_torch.analysis.numcheck",
    "NumCheck": "repro_torch.analysis.numcheck",
    "NumCheckError": "repro_torch.analysis.numcheck",
    "assert_plan_numerics": "repro_torch.analysis.numcheck",
    "cell_numcheck": "repro_torch.analysis.numcheck",
    "check_numerics": "repro_torch.analysis.numcheck",
    "error_probe": "repro_torch.analysis.numcheck",
    "precision_flow_findings": "repro_torch.analysis.numcheck",
    "ShardCheck": "repro_torch.analysis.shardcheck",
    "ShardCheckError": "repro_torch.analysis.shardcheck",
    "assert_plan_contract": "repro_torch.analysis.shardcheck",
    "check_plan_contract": "repro_torch.analysis.shardcheck",
    "check_sharding": "repro_torch.analysis.shardcheck",
    "expected_collectives": "repro_torch.analysis.shardcheck",
    "rank_contract": "repro_torch.analysis.shardcheck",
    "verify_collectives": "repro_torch.analysis.shardcheck",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_EXPORTS[name]), name)
