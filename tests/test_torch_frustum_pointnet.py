"""The parity tests of tests/test_torch_frustum.py (weights through
state_dict_from_jax, the eval forward, one-step gradients, the three-step
trajectory against the JAX Trainer) for FrustumPointNet, in a file of their
own so that the parallel run spreads the models' JAX compiles."""

import pytest

from test_torch_frustum import (  # noqa: F401 (collected and used here)
    deterministic_sampler, few_threads, jax_sgd, model_parity_setup,
    test_eval_forward_matches_jax, test_one_step_gradients_match_jax,
    test_three_step_trajectory_matches_jax_trainer,
    test_weights_from_jax_round_trip)
from test_torch_train import no_dropout  # noqa: F401 (fixture)


@pytest.fixture(scope="module")
def frustum():
    return model_parity_setup("pointnet")
