"""Port vs JAX package: gradients of ``R.train_loss`` and one
``make_train_step`` step for the vlm, audio and moe archs and granite, at
``tests/test_torch_train.py``'s tolerances (the cases live in their own
file so that one worker does not trace all ten archs)."""
import pytest

from test_torch_train import (check_gradients, check_train_step,
                              one_torch_thread)  # noqa: F401

ARCHS_HERE = ["granite-8b", "hubert-xlarge", "internvl2-1b",
              "kimi-k2-1t-a32b"]


@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_gradients_match_jax(arch):
    check_gradients(arch)


@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_train_step_matches_jax(arch):
    check_train_step(arch)
