"""Logical-axis sharding rules (counterpart of ``repro.parallel.axes``).

Model code names activation and parameter axes logically ("batch", "seq",
"tp", "expert", ...) and the launcher installs a rule set mapping them to
mesh axes.  Outside any mesh every annotation is a no-op, so the same
model code runs everywhere.

Where JAX's ``constrain`` asks GSPMD for a layout, a rank here holds its
local tensor and nothing reshards implicitly: :func:`constrain` returns
its argument, and only checks that every logical name it is given is
one the installed rules know.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Tuple

from repro_torch.launch.mesh import axis_names


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: object                 # a DeviceMesh or a launch.mesh.AbstractMesh
    # logical name -> mesh axis (str), tuple of mesh axes, or None (replicate)
    rules: dict
    dp_axes: Tuple[str, ...] = ("data",)   # gradient reduction axes
    ep_axis: Optional[str] = "model"       # expert-parallel a2a axis
    tp_axis: Optional[str] = "model"
    # True where each rank holds only its own slice of the batch (the
    # data-parallel train steps), not the same whole tensors: a conv there
    # runs on the rank's tensors, never split and gathered over the mesh.
    local_batch: bool = False

    def spec(self, logical_axes) -> Tuple:
        """The placement tuple (one mesh axis, tuple or None a dim)."""
        return tuple(self.rules.get(a) if a is not None else None
                     for a in logical_axes)


_state = threading.local()


def current_rules() -> Optional[ShardingRules]:
    return getattr(_state, "rules", None)


def global_rules() -> Optional[ShardingRules]:
    """The installed rules when every rank holds the same whole tensors
    (the sharded conv's view); None without rules and under
    ``local_batch`` rules."""
    rules = current_rules()
    return None if rules is None or rules.local_batch else rules


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    prev = current_rules()
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def constrain(x, *logical_axes):
    """The activation's logical layout: the identity on a rank's local
    tensor.  Under installed rules a name the rules do not know raises,
    and so does a name list longer than the tensor's rank."""
    rules = current_rules()
    if rules is None:
        return x
    unknown = [a for a in logical_axes
               if a is not None and a not in rules.rules]
    if unknown:
        raise ValueError(f"constrain: logical axes {unknown} have no rule "
                         f"(known: {sorted(rules.rules)})")
    if len(logical_axes) > x.dim():
        raise ValueError(f"constrain: {len(logical_axes)} logical axes for "
                         f"a rank-{x.dim()} tensor")
    return x


def default_rules(mesh) -> ShardingRules:
    """Default logical -> mesh mapping for the production mesh."""
    names = axis_names(mesh)
    dp = tuple(a for a in ("pod", "data") if a in names)
    tp = "model" if "model" in names else None
    return ShardingRules(
        mesh=mesh,
        rules={
            "batch": dp if len(dp) > 1 else (dp[0] if dp else None),
            "seq": None,
            "seq_tp": tp,       # sequence-parallel regions (MoE SP, KV cache)
            "embed": None,
            "heads": tp,
            "kv_heads": None,   # kv heads may not divide tp; replicate
            "head_dim": None,
            "ffn": tp,
            "expert": tp,
            "vocab": tp,
            "conv_ch": tp,
            "zero": dp if len(dp) > 1 else (dp[0] if dp else None),
        },
        dp_axes=dp,
        ep_axis=tp,
        tp_axis=tp,
    )
