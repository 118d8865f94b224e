"""Port vs JAX package: gradients of ``R.train_loss`` and one
``make_train_step`` step for the RWKV6 and hybrid (Mamba2) archs, through
the plain chunked scan, at ``tests/test_torch_train.py``'s tolerances
(rwkv6-7b's gradient in float64, as set out there)."""
import pytest

from test_torch_train import (check_gradients, check_train_step,
                              one_torch_thread)  # noqa: F401

ARCHS_HERE = ["rwkv6-7b", "zamba2-2.7b"]


@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_gradients_match_jax(arch):
    check_gradients(arch)


@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_train_step_matches_jax(arch):
    check_train_step(arch)
