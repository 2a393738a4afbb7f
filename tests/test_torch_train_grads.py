"""The port's loss and gradients against ``jax.value_and_grad`` over the
JAX package's ``lm_loss`` for the last five architectures, at
``reduced()`` width in f32 (the first five, and the tolerances, are in
``test_torch_train.py``: two files, so two test workers share the
reference's compile time)."""

import pytest

from repro_torch.configs import ARCHITECTURES

from test_torch_train import (  # noqa: F401  (one_torch_thread: autouse)
    check_grads, check_loss, grad_case, one_torch_thread)


@pytest.fixture(scope="module", params=ARCHITECTURES[5:])
def case(request):
    """Each architecture's port and reference gradients, computed once."""
    return grad_case(request.param)


def test_loss_matches_reference(case):
    check_loss(case)


def test_grads_match_reference(case):
    check_grads(case)
