"""The point-backbone model ``kpconv`` against the JAX package: the cases of
``test_torch_point_models.py`` (the eval forward, the first train steps,
the weights' round trip), with its inputs, weights and tolerances, for
this model alone."""

import pytest

from test_torch_point_models import (  # noqa: F401 (the module fixture of the inputs)
    arrays,
    run_model_case,
    test_eval_heads,
    test_eval_proposals,
    test_train_step_gradients,
    test_train_step_losses,
    test_train_step_proposals,
    test_weights_round_trip,
)
from torch_jax_cache import jax_compilation_cache  # noqa: F401 (autouse)


@pytest.fixture(scope="module", params=["kpconv"])
def model_case(request, arrays):  # noqa: F811
    return run_model_case(request.param, arrays)


@pytest.fixture(scope="module", params=["kpconv"])
def name(request):
    return request.param
