"""The port's LM training step against the JAX package on the hybrid
(zamba2), ssm (xLSTM) and audio (whisper) families, on the CPU: the checks
and tolerances of ``tests/test_torch_train_parity.py`` (forward and aux
loss, every leaf's gradient, one ``make_train_step`` step, 1e-4
scale-normalised), whose helpers this file runs.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_train_parity import (check_forward,  # noqa: E402
                                     check_gradients, check_train_step,
                                     one_thread)

assert one_thread        # the autouse fixture, for this file's tests too

RECURRENT_ARCHS = ["zamba2-7b", "xlstm-125m", "whisper-tiny"]


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_forward_and_aux_match_jax(arch):
    check_forward(arch)


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_loss_gradients_match_jax(arch):
    check_gradients(arch)


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_train_step_matches_jax(arch):
    """One step: loss, grad norm, lr, the new parameters and moments."""
    check_train_step(arch)
