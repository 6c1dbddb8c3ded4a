"""The plain reference against the program on tiny shapes in float64, given
the same weights: forward passes, gradients, empirical-Fisher factors, the
heuristically damped inverse applied to a gradient, the GGN product and CG."""

import pytest
import torch
from tiny import CONFIGS

from perfbench.loops.kfac_step import factors_by_param
from perfbench.families import gpt as program_gpt
from perfbench.families import resnet as program_resnet
from perfbench.reference import curvature as rc
from perfbench.reference import gpt as ref_gpt
from perfbench.reference import resnet as ref_resnet

FAMILIES = {"resnet": (program_resnet, ref_resnet), "gpt": (program_gpt, ref_gpt)}
TOL = 1e-10


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def problem(family: str, attention: str = "einsum"):
    program, ref = FAMILIES[family]
    cfg = CONFIGS[family]
    gen = torch.Generator().manual_seed(7)
    weights = ref.init_weights(cfg, gen, "cpu")
    (X, y), = ref.make_batches(cfg, gen, 1, "cpu")
    if family == "resnet":
        ref.calibrate(weights, X, cfg)
    model = program.build_model(cfg, {"attention_impl": attention}, weights, "cpu")
    return cfg, ref, weights, model, X, y


@pytest.mark.parametrize("family,attention", [("resnet", None), ("gpt", "einsum"),
                                              ("gpt", "flash")])
def test_forward(family, attention):
    cfg, ref, weights, model, X, _ = problem(family, attention or "einsum")
    assert rel(model(X).detach(), ref.forward(weights, X, cfg)) < TOL


@pytest.mark.parametrize("family", FAMILIES)
def test_gradient_factors_and_preconditioned_step(family):
    from curvlinops_tpu_torch.kfac.operator import KFACLinearOperator
    from curvlinops_tpu_torch.losses import CrossEntropyLoss

    cfg, ref, weights, model, X, y = problem(family)
    params = dict(model.named_parameters())
    loss_fn = CrossEntropyLoss("mean")
    grads = dict(zip(params, torch.autograd.grad(loss_fn(model(X), y), list(params.values()))))
    names = [n for layer in ref.kfac_layers(cfg) for n in layer if n]
    kfac = KFACLinearOperator(model, loss_fn, {n: params[n] for n in names}, [(X, y)],
                              fisher_type="empirical", kfac_approx="expand",
                              check_deterministic=False)
    step = kfac.inverse(damping=0.1, use_heuristic_damping=True) @ {n: grads[n] for n in names}

    ref_grad, ref_factors = rc.step_outputs(ref, cfg, weights, X, y)
    ref_step = rc.apply_inverse(ref, rc.heuristic_inverse(ref_factors, 0.1), ref_grad)
    assert max(rel(grads[n], ref_grad[n]) for n in ref_grad) < TOL
    mine = factors_by_param(kfac)
    assert set(mine) == set(ref_factors)
    for n, fs in ref_factors.items():
        assert all(rel(a, b) < TOL for a, b in zip(mine[n], fs)), n
    assert max(rel(step[n], ref_step[n]) for n in names) < 1e-8


@pytest.mark.parametrize("family", FAMILIES)
def test_ggn_product_and_cg(family):
    from curvlinops_tpu_torch import CGInverseLinearOperator, GGNLinearOperator
    from curvlinops_tpu_torch.losses import CrossEntropyLoss
    from curvlinops_tpu_torch.ops.dense import IdentityLinearOperator

    cfg, ref, weights, model, X, y = problem(family)
    params = dict(model.named_parameters())
    gen = torch.Generator().manual_seed(3)
    v = {n: torch.randn(p.shape, generator=gen, dtype=p.dtype) for n, p in params.items()}
    G = GGNLinearOperator(model, CrossEntropyLoss("mean"), params, [(X, y)],
                          check_deterministic=False)
    Gv, ref_Gv = G @ v, rc.ggn_product(ref, cfg, weights, X, y, v)
    assert max(rel(Gv[n], ref_Gv[n]) for n in v) < TOL
    lam = 0.1
    solver = CGInverseLinearOperator(G + lam * IdentityLinearOperator(G.in_spec), maxiter=6,
                                     tol=0.0, atol=0.0)
    x = solver @ v
    ref_x, ref_norms = rc.cg(lambda u: {n: t + lam * u[n] for n, t in
                             rc.ggn_product(ref, cfg, weights, X, y, u).items()}, v, 6)
    num = sum(float((x[n] - ref_x[n]).norm()) ** 2 for n in v) ** 0.5
    assert num / sum(float(ref_x[n].norm()) ** 2 for n in v) ** 0.5 < 1e-8
    assert rel(solver.last_info["residual_history"][:, 0], ref_norms) < 1e-8
