"""PyTorch port of the serving predictor: parity with the JAX Predictor."""

import numpy as np
import pytest
import torch

from skeleton_action_recognition_tpu import serving as jax_serving
from skeleton_action_recognition_tpu.models import stgcn as jax_stgcn
from skeleton_action_recognition_tpu_torch import interop, serving
from skeleton_action_recognition_tpu_torch.models import stgcn
from torch_parity_helpers import randomized_variables


@pytest.fixture(scope="module")
def predictors():
    x = np.random.default_rng(4).normal(size=(3, 3, 16, 25, 2)).astype(
        np.float32
    )
    # the stock model shares the fused model's variable tree
    variables = randomized_variables(
        jax_stgcn.Model(num_classes=6, remat=False), x, seed=5
    )
    jax_pred = jax_serving.Predictor(
        jax_stgcn.Model(num_classes=6, remat=False, fused_sgcn=True),
        variables["params"], variables["batch_stats"], max_batch=4,
    )
    port = stgcn.Model(num_classes=6, fused_sgcn=True)
    port.load_state_dict(interop.flax_to_state_dict(variables))
    return x, jax_pred, serving.Predictor(port, max_batch=4, device="cpu")


@pytest.mark.parametrize("n", [1, 3])
def test_predictor_matches_jax_predictor(predictors, n):
    x, jax_pred, port_pred = predictors
    want = jax_pred(x[:n])
    got = port_pred(x[:n])
    assert got.shape == (n, 6) and got.dtype == np.float32
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)
    # probabilities from f32 logits that agree to ~1e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_predictor_serves_in_eval_mode_and_bounds_the_batch(predictors):
    x, _, port_pred = predictors
    port_pred.model.train()
    port_pred_again = serving.Predictor(port_pred.model, max_batch=2,
                                             device="cpu")
    assert not port_pred_again.model.training
    with pytest.raises(ValueError):
        port_pred_again(x)
    # BatchNorm used its running statistics: the stats did not move
    bn = port_pred_again.model.backbone.data_bn.BatchNorm_0
    before = bn.running_mean.clone()
    port_pred_again(x[:2])
    assert torch.equal(bn.running_mean, before)
