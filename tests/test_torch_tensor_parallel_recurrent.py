"""The recurrent families (hybrid: zamba2-7b; ssm: xlstm-125m, each with
the lowered and the fused conv) on 2 gloo ranks against the JAX
package's one-device forward, gradient and gradient norm: the checks of
``tests/test_torch_tensor_parallel.py``, in a file of their own so the
test runner's workers share the load.
"""
import pytest

pytest.importorskip("torch")

from test_torch_tensor_parallel import (EDGES, FAMILIES,  # noqa: E402
                                        RECURRENT, check_family)


@pytest.mark.parametrize("arch,over", [(a, o) for a, o in
                                       [(a, {}) for a in FAMILIES] + EDGES
                                       if a in RECURRENT])
def test_family_on_2_ranks_matches_the_jax_package(arch, over):
    check_family(arch, over)
