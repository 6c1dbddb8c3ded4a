"""The port's MC Fisher against its own samples and the JAX package's GGN.

The MC Fisher's samples come from ``torch.Generator`` and so differ from
JAX's draws: it is checked against its own redrawn samples through JAX's
Jacobians, for replay, and for convergence to JAX's exact GGN, on the cases
of ``test_torch_curvature.py`` (the MC part of ``test_torch_risk.py``, in a
file of its own so that the suite's workers can take the two apart).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from curvlinops_tpu_torch.curvature.ggn import GGNLinearOperator
from curvlinops_tpu_torch.curvature.loss_hessian import FisherType, make_grad_output_fn
from curvlinops_tpu_torch.losses import CrossEntropyLoss
from curvlinops_tpu_torch.risk import batch_generator
from tests.test_torch_curvature import ATOL, RTOL, jax_oracle, make_case
from tests.test_torch_helpers import assert_close, capped_torch_threads

_threads = capped_torch_threads()

MC_SEED = 7


@pytest.fixture(scope="module")
def mlp_ce():
    return make_case("mlp_ce_mean")


# ---------------------------------------------------------------------- #
# MC Fisher
# ---------------------------------------------------------------------- #
# mean and sum reductions; seq_ce_ignore has targets at CE's ignore_index
MC_CASES = ["mlp_mse_mean", "mlp_ce_mean", "mlp_bce_mean", "mlp_ce_sum", "seq_ce_ignore"]


@pytest.mark.parametrize("case_name", MC_CASES)
def test_mc_fisher_matches_its_samples(case_name):
    """``J^T (sum g g^T / c_batch) J`` with the port's own grad outputs,
    redrawn from :func:`batch_generator`, and JAX's Jacobians (its
    operator's ``@ I``, one jitted program a batch). A mean
    loss divides each batch by its loss terms, the non-ignored targets for
    CE; the grad outputs already carry the per-datum share of them."""
    case = make_case(case_name)
    j, t = case["jax"], case["torch"]
    loss_fn, mc = t["loss_fn"], 3
    F = GGNLinearOperator(t["model"], loss_fn, t["params"], t["data"],
                          mc_samples=mc, seed=MC_SEED)
    expected = np.zeros(F.shape)
    for idx, ((X, y), batch_j) in enumerate(zip(t["data"], j["data"])):
        pred = t["model"](t["params"], X)
        G = make_grad_output_fn(loss_fn, FisherType.MC, mc)(
            pred, y, batch_generator(MC_SEED, idx, torch.device("cpu"))
        ).numpy().astype(np.float64).reshape(pred.shape[0], mc, -1)  # [N, mc, C * S]
        N, D = G.shape[0], G.shape[2]
        scale, share = (1.0, 1.0) if loss_fn.reduction == "sum" else (1.0 / N, N / F.num_data)
        if isinstance(loss_fn, CrossEntropyLoss) and loss_fn.reduction == "mean":
            scale *= y.numel() / int((y != loss_fn.ignore_index).sum())
        middle = np.zeros((N * D, N * D))
        for n in range(N):
            middle[n * D:(n + 1) * D, n * D:(n + 1) * D] = scale * G[n].T @ G[n]
        J = jax_oracle("jacobian", {"jax": {**j, "data": [batch_j]}}).astype(np.float64)
        expected += share * (J.T @ middle @ J)
    assert_close(F @ torch.eye(F.shape[1]), expected, RTOL, ATOL, case_name)


def test_mc_case_with_ignored_targets():
    """``seq_ce_ignore`` holds ignored and kept targets in every batch."""
    for _, y in make_case("seq_ce_ignore")["torch"]["data"]:
        ignored = int((y == CrossEntropyLoss().ignore_index).sum())
        assert 0 < ignored < y.numel()


def test_mc_fisher_replays_its_samples(mlp_ce):
    t = mlp_ce["torch"]
    F = GGNLinearOperator(t["model"], t["loss_fn"], t["params"], t["data"],
                          mc_samples=2, seed=MC_SEED)
    v = torch.randn(F.shape[1], generator=torch.Generator().manual_seed(0))
    assert torch.equal(F @ v, F @ v)


@pytest.mark.parametrize("case_name", MC_CASES)
def test_mc_fisher_converges_to_exact_ggn(case_name):
    """5000 samples: within 0.12 of the exact GGN (``tests/test_ggn.py``)."""
    case = make_case(case_name)
    t = case["torch"]
    dense = jax_oracle("ggn", case)
    F = GGNLinearOperator(t["model"], t["loss_fn"], t["params"], t["data"],
                          mc_samples=5000, check_deterministic=False)
    v = np.random.default_rng(0).standard_normal(F.shape[1]).astype(np.float32)
    scale = max(np.abs(dense @ v).max(), 1e-2)
    assert np.abs(F @ v - dense @ v).max() / scale < 0.12
