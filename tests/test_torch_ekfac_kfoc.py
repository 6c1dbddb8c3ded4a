"""EKFAC and KFOC of the port against JAX and against dense oracles.

On the CPU in float32: EKFAC's one-datum and weight-sharing exactness
against the dense block-diagonal GGN, its two contraction strategies, its
matvec and inverse against JAX on the narrow ResNet, its rank-``r`` route
and its checkpoints; KFOC's factors against the dense Van Loan SVD in numpy
and against JAX, its power iteration on JAX's stopping cases
(near-degenerate, early stop, stagnation, zero block), batched against
single, and the refusals of both by type and message. Each check states its
tolerance.
"""

import jax
import numpy as np
import pytest
import torch
from torch import nn

from curvlinops_tpu.kfac import kfoc as jkfoc
from curvlinops_tpu.kfac import math as jmath
from curvlinops_tpu.kfac.ekfac import EKFACLinearOperator as JEKFAC
from curvlinops_tpu.kfac.kfoc import KFOCLinearOperator as JKFOC
from curvlinops_tpu.losses import CrossEntropyLoss as JCrossEntropyLoss
from curvlinops_tpu.losses import MSELoss as JMSELoss
from curvlinops_tpu.models import resnet as jresnet
from curvlinops_tpu_torch.kfac import kfoc as tkfoc
from curvlinops_tpu_torch.kfac import math as tmath
from curvlinops_tpu_torch.kfac.ekfac import EKFACLinearOperator
from curvlinops_tpu_torch.kfac.kfoc import KFOCLinearOperator
from curvlinops_tpu_torch.losses import CrossEntropyLoss, MSELoss
from curvlinops_tpu_torch.models.common import from_jax_params
from tests.test_torch_helpers import (
    SeqMLP,
    assert_same_vector,
    capped_torch_threads,
    jax_name,
    mlp_pair,
    narrow_resnet,
    random_jax_vector,
    rel_fro,
    jax_apply,
)
from tests.test_torch_kfac import blockdiag_projection, dense_ggn

_threads = capped_torch_threads()

# exactness oracles: float32 operator against the float64 dense GGN (the JAX
# package's tolerances)
ORACLE_RTOL, ORACLE_ATOL = 1e-3, 1e-5
# EKFAC against JAX on the narrow ResNet: float32 sums in another order
# (matvec), amplified by up to lambda_max / damping in the inverse
MATVEC_TOL, INVERSE_TOL = 1e-4, 1e-3
# KFOC factors against the dense Van Loan pair (JAX's tolerance)
KFOC_RTOL, KFOC_ATOL = 5e-3, 1e-4


def _ekfac_vs_dense(model, loss_fn, data, **kw):
    params = dict(model.named_parameters())
    ekfac = EKFACLinearOperator(model, loss_fn, params, data, fisher_type="type-2",
                                check_deterministic=False, **kw)
    expected = blockdiag_projection(dense_ggn(model, loss_fn, params, data), params, ekfac.groups)
    np.testing.assert_allclose(ekfac.todense().double().numpy(), expected.numpy(),
                               rtol=ORACLE_RTOL, atol=ORACLE_ATOL)
    return ekfac


# ---------------------------------------------------------------------- #
# EKFAC
# ---------------------------------------------------------------------- #
def test_ekfac_exact_one_datum():
    """One datum, type-2: EKFAC equals the block-diagonal GGN (rtol 1e-3)."""
    gen = torch.Generator().manual_seed(1)
    torch.manual_seed(1)
    model = nn.Sequential(nn.Linear(6, 7), nn.Tanh(), nn.Linear(7, 4))
    data = [(torch.randn(1, 6, generator=gen), torch.tensor([2]))]
    _ekfac_vs_dense(model, CrossEntropyLoss("mean"), data)


@pytest.mark.parametrize("separate", [True, False], ids=["separate", "joint"])
@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_ekfac_weight_sharing_exact(reduction, separate):
    """A deep linear net along a sequence axis, output flattened (the
    reference's expand-flatten case): EKFAC equals the block-diagonal GGN
    (rtol 1e-3)."""
    *_, model, data = mlp_pair([4, 3, 2], 6, 50, seq=5, linear=True)
    _ekfac_vs_dense(model, MSELoss(reduction), data, separate_weight_and_bias=separate)


def test_ekfac_strategies_agree():
    """Gramian and per-example-gradient corrections coincide (rtol 1e-4)."""
    *_, model, data = mlp_pair([4, 3, 2], 6, 50, seq=5)
    params = dict(model.named_parameters())
    lams = [
        EKFACLinearOperator(model, MSELoss("mean"), params, data, fisher_type="type-2",
                            check_deterministic=False, force_strategy=s).corrected_eigenvalues
        for s in ("gramian", "per_example_gradients")
    ]
    for gi in lams[0]:
        np.testing.assert_allclose(lams[0][gi].numpy(), lams[1][gi].numpy(), rtol=1e-4, atol=1e-6)


CORRECTION_CASES = {
    # (V, B, S, D1, D2, force_strategy): the auto rule picks the Gramian at
    # S = 2 and per-example gradients at S = 6, which form the per-sample
    # products first; forced at S = 2, they rotate the rows first
    # (S (D1^2 + D2^2) < D1 D2 (D1 + D2))
    "gramian": (2, 3, 2, 5, 7, None),
    "per_example": (2, 3, 6, 5, 7, None),
    "per_example_rotate_first": (2, 3, 2, 5, 7, "per_example_gradients"),
    "forced_gramian": (2, 3, 6, 5, 7, "gramian"),
    "bias": (2, 3, 4, 5, None, None),
}


@pytest.mark.parametrize("case", list(CORRECTION_CASES))
def test_eigenvalue_correction_matches_jax(case):
    """``eigenvalue_correction`` on the same numpy inputs as JAX's, each
    contraction order (relative 1e-5), and the strategy rule unchanged."""
    V, B, S, D1, D2, force = CORRECTION_CASES[case]
    rng = np.random.default_rng(11)
    g = rng.standard_normal((V, B, S, D1)).astype(np.float32)
    Q_g = np.linalg.qr(rng.standard_normal((D1, D1)))[0].astype(np.float32)
    a = Q_a = None
    if D2 is not None:
        a = rng.standard_normal((B, S, D2)).astype(np.float32)
        Q_a = np.linalg.qr(rng.standard_normal((D2, D2)))[0].astype(np.float32)
        rule = "gramian" if S * S * (D1 + D2) < D1 * D2 else "per_example_gradients"
        assert tmath.correction_strategy(S, D1, D2) == rule
    expected = jax.jit(lambda *x: jmath.eigenvalue_correction(*x, force_strategy=force))(
        g, Q_g, a, Q_a
    )
    t = [None if x is None else torch.from_numpy(x) for x in (g, Q_g, a, Q_a)]
    out = tmath.eigenvalue_correction(*t, force_strategy=force)
    assert rel_fro(out.numpy(), np.asarray(expected)) < 1e-5


def test_eigenvalue_correction_refusals():
    g, Q = torch.zeros(1, 2, 3, 4), torch.eye(4)
    with pytest.raises(ValueError, match="Invalid force_strategy"):
        tmath.eigenvalue_correction(g, Q, None, None, force_strategy="dense")
    with pytest.raises(ValueError, match="a and Q_a must both be None"):
        tmath.eigenvalue_correction(g, Q, torch.zeros(2, 3, 4), None)


@pytest.fixture(scope="module")
def resnet_ekfac():
    case = narrow_resnet()
    kfac_fn, kfac_params = jresnet.kfac_restricted(case["apply_fn"], case["jax_params"])
    jop = JEKFAC(kfac_fn, JCrossEntropyLoss("mean"), kfac_params, [(case["X_nhwc"], case["y"])],
                 fisher_type="type-2", check_deterministic=False)
    params = from_jax_params(jax.tree.map(np.asarray, kfac_params), case["model"])
    top = EKFACLinearOperator(case["model"], CrossEntropyLoss("mean"), params,
                              [(case["X"], case["y_t"])], fisher_type="type-2")
    return jop, top, random_jax_vector(kfac_params, 0), case["model"]


@pytest.mark.parametrize("mode", ["matvec", "inverse"])
def test_ekfac_matches_jax_on_narrow_resnet(resnet_ekfac, mode):
    """EKFAC (type-2) on the narrow ResNet: the matvec (relative Frobenius
    1e-4) and ``inverse(damping=1.0)`` (1e-3) against JAX's; the eigenbases
    differ by signs and rotations in degenerate eigenspaces, the operators
    do not."""
    jop, top, v_jax, model = resnet_ekfac
    if mode == "matvec":
        jA, tA, tol = jop, top, MATVEC_TOL
    else:
        jA, tA, tol = jop.inverse(damping=1.0), top.inverse(damping=1.0), INVERSE_TOL
    assert_same_vector(tA @ from_jax_params(v_jax, model), jax_apply(jA, v_jax), model, tol, mode)
    assert abs(float(top.trace()) / float(jop.trace()) - 1) < MATVEC_TOL


def test_ekfac_rank_route_exact_at_full_capture():
    """One datum: every factor's true rank is below rank 14, so the
    rank-``r`` EKFAC (sector blocks) equals the exact EKFAC (relative
    Frobenius 1e-4) and JAX's rank-14 EKFAC (1e-4); its inverse too (rtol
    5e-3, atol 2e-4, JAX's tolerance); its checkpoint restores it exactly."""
    model_fn, jparams, jdata, model, data = mlp_pair([20, 18, 16, 3], 1, 4)
    params = dict(model.named_parameters())
    kw = dict(fisher_type="type-2", check_deterministic=False)
    exact = EKFACLinearOperator(model, MSELoss("mean"), params, data, **kw)
    lowrank = EKFACLinearOperator(model, MSELoss("mean"), params, data, rank=14, **kw)
    assert {k for k, _ in lowrank._blocks_data.values()} == {"lreigh", "eigh"}
    de, dl = exact.todense().numpy(), lowrank.todense().numpy()
    assert rel_fro(dl, de) < 1e-4
    v_jax = random_jax_vector(jparams, 42)
    v = from_jax_params(v_jax, model)
    jop = JEKFAC(model_fn, JMSELoss("mean"), jparams, jdata, rank=14, **kw)
    assert_same_vector(lowrank @ v, jax_apply(jop, v_jax), model, 1e-4, "rank-14 EKFAC matvec")
    inv_lr, inv_ex = lowrank.inverse(damping=0.1) @ v, exact.inverse(damping=0.1) @ v
    for name in v:
        np.testing.assert_allclose(inv_lr[name].numpy(), inv_ex[name].numpy(),
                                   rtol=5e-3, atol=2e-4, err_msg=name)
    restored = EKFACLinearOperator.from_state_dict(
        lowrank.state_dict(), model, MSELoss("mean"), params, data, **kw
    )
    assert all(torch.equal(a, b) for a, b in zip((restored @ v).values(), (lowrank @ v).values()))


@pytest.mark.parametrize(
    "case,kwargs,match",
    [
        ("3d_output", {}, "2d model output only"),
        ("forward_only", dict(fisher_type="forward-only"), "EKFAC supports fisher types"),
        ("rank_zero", dict(rank=0), "rank must be a positive int"),
    ],
    ids=["3d_output", "forward_only", "rank_zero"],
)
def test_ekfac_refusals(case, kwargs, match):
    *_, model, data = mlp_pair([4, 3, 2], 2, 0, seq=3)
    if case == "3d_output":
        model = SeqMLP([4, 3, 2], flatten=False)
        data = [(data[0][0], data[0][1].reshape(2, 3, 2))]
    with pytest.raises(ValueError, match=match):
        EKFACLinearOperator(model, MSELoss("mean"), dict(model.named_parameters()), data,
                            check_deterministic=False, **kwargs)


# ---------------------------------------------------------------------- #
# KFOC
# ---------------------------------------------------------------------- #
def _dense_vanloan_top_pair(G, d1, d2):
    R = G.reshape(d1, d2, d1, d2).transpose(0, 2, 1, 3).reshape(d1 * d1, d2 * d2)
    u, s, vt = np.linalg.svd(R, full_matrices=False)
    return np.sqrt(s[0]) * u[:, 0].reshape(d1, d1), np.sqrt(s[0]) * vt[0].reshape(d2, d2)


def test_kfoc_matches_dense_vanloan_and_jax():
    """Type-2, one batch of 8 (MSE): each weight group's ``S_1 (x) S_2``
    against the dense Van Loan top pair in numpy and against JAX's (rtol
    5e-3, atol 1e-4), each bias group's block against the exact GGN block,
    and every group's power iteration converged (residual < 1e-5)."""
    model_fn, jparams, jdata, model, data = mlp_pair([5, 4, 3], 8, 3)
    params = dict(model.named_parameters())
    kw = dict(fisher_type="type-2", check_deterministic=False)
    kfoc = KFOCLinearOperator(model, MSELoss("mean"), params, data, **kw)
    jop = JKFOC(model_fn, JMSELoss("mean"), jparams, jdata, **kw)
    jgroups = {
        tuple(None if p is None else jax_name(p) for p in (g.weight_path, g.bias_path)): gi
        for gi, g in enumerate(jop.groups)
    }
    dense = dense_ggn(model, MSELoss("mean"), params, data).numpy()
    start, ranges = 0, {}
    for n, p in params.items():
        ranges[n] = slice(start, start + p.numel())
        start += p.numel()
    for gi, group in enumerate(kfoc.groups):
        jgi = jgroups[group.key]
        if group.weight_path is None:
            block = dense[ranges[group.bias_path], ranges[group.bias_path]]
            np.testing.assert_allclose(kfoc._ggT[gi].numpy(), block, rtol=KFOC_RTOL, atol=KFOC_ATOL)
            np.testing.assert_allclose(kfoc._ggT[gi].numpy(), np.asarray(jop._ggT[jgi]),
                                       rtol=1e-4, atol=1e-7)
            continue
        block = dense[ranges[group.weight_path], ranges[group.weight_path]]
        S1_ref, S2_ref = _dense_vanloan_top_pair(block, group.d_out, group.d_in)
        ours = np.kron(kfoc._ggT[gi].numpy(), kfoc._aaT[gi].numpy())
        np.testing.assert_allclose(ours, np.kron(S1_ref, S2_ref), rtol=KFOC_RTOL, atol=KFOC_ATOL)
        np.testing.assert_allclose(
            ours, np.kron(np.asarray(jop._ggT[jgi]), np.asarray(jop._aaT[jgi])),
            rtol=KFOC_RTOL, atol=KFOC_ATOL,
        )
        assert float(kfoc.power_info[gi]["residual"]) < 1e-5
    assert set(kfoc.power_info) == {gi for gi, g in enumerate(kfoc.groups) if g.weight_path}


def _near_degenerate_P():
    """Per-sample gradients whose GGN block is ``S1 (x) S2 + 0.998 T1 (x) T2``
    with trace-orthogonal rank-one factors: Van Loan singular values exactly
    {1, 0.998} (JAX's case)."""
    d = 3
    u1, u2 = np.eye(d)[:, 0], np.eye(d)[:, 1]
    q = np.linalg.qr(np.random.default_rng(0).normal(size=(d, d)))[0]
    w1, w2 = q[:, 0], q[:, 1]
    G = np.kron(np.outer(u1, u1), np.outer(w1, w1)) + 0.998 * np.kron(
        np.outer(u2, u2), np.outer(w2, w2)
    )
    evals, evecs = np.linalg.eigh(G)
    P = (np.sqrt(np.clip(evals, 0.0, None))[:, None] * evecs.T).reshape(-1, d, d)[None]
    return P.astype(np.float32), G


POWER_CASES = ["near_degenerate", "early_stop", "stagnation", "zero_block"]


@pytest.mark.parametrize("case", POWER_CASES)
def test_kfoc_power_iteration_stopping_matches_jax(case):
    """JAX's stopping cases on the same ``P``: near-degenerate needs more
    than 200 steps and matches the dense pair (atol 5e-4, the float32
    eigenvector floor of a 0.002 gap); a well-separated pair stops early at
    ``tol``; ``tol = 0`` stops on stagnation at the float32 floor (< 500
    steps, residual < 1e-5); a zero block gives zero factors. The factors'
    Kronecker products agree with JAX's (rtol 5e-3, atol 5e-4) and so do the
    stop reasons."""
    tol, G = None, None
    if case == "near_degenerate":
        P, G = _near_degenerate_P()
    elif case == "early_stop":
        P, tol = np.asarray(jax.random.normal(jax.random.key(3), (2, 4, 3, 5))), 1e-6
    elif case == "stagnation":
        P, tol = np.asarray(jax.random.normal(jax.random.key(5), (1, 8, 16, 48))), 0.0
    else:
        P = np.zeros((1, 4, 3, 5), np.float32)
    S1, S2, info = tkfoc.top_rank_one_kron_factors(torch.from_numpy(P), tol=tol)
    jS1, jS2, jinfo = jkfoc.top_rank_one_kron_factors(P, tol=tol)
    iters, res = int(info["iterations"]), float(info["residual"])
    ours, theirs = np.kron(S1.numpy(), S2.numpy()), np.kron(np.asarray(jS1), np.asarray(jS2))
    np.testing.assert_allclose(ours, theirs, rtol=5e-3, atol=5e-4)
    if case == "near_degenerate":
        assert iters > 200 and int(jinfo["iterations"]) > 200
        np.testing.assert_allclose(ours, np.kron(*_dense_vanloan_top_pair(G, 3, 3)),
                                   rtol=5e-3, atol=5e-4)
    elif case == "early_stop":
        assert iters < 200 and res <= 1e-6 and float(info["sigma"]) > 0
        assert int(jinfo["iterations"]) < 200
    elif case == "stagnation":
        assert iters < 500 and res < 1e-5
        assert int(jinfo["iterations"]) < 500
    else:
        assert not ours.any() and float(info["sigma"]) == 0.0 and iters == 1


def test_kfoc_batched_power_iterations_equal_single():
    """Three groups of one shape, batched with a per-group stop mask: each
    group's iteration count equals its own loop's, and its factors and
    residual agree to float32 roundoff (relative 1e-5)."""
    P = torch.from_numpy(np.random.default_rng(9).standard_normal((3, 1, 4, 3, 5)).astype(np.float32))
    P[1] *= 0.0  # a zero block stops at once
    S1, S2, info = tkfoc.batched_top_rank_one_kron_factors(P, tol=1e-6)
    for i in range(3):
        s1, s2, one = tkfoc.top_rank_one_kron_factors(P[i], tol=1e-6)
        assert int(info["iterations"][i]) == int(one["iterations"])
        np.testing.assert_allclose(float(info["residual"][i]), float(one["residual"]),
                                   rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(torch.kron(S1[i], S2[i]).numpy(),
                                   torch.kron(s1, s2).numpy(), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize(
    "kwargs,batches,match",
    [
        ({}, 2, "single batch"),
        (dict(fisher_type="empirical"), 1, "TYPE2/MC"),
        (dict(kfac_approx="reduce"), 1, "EXPAND only"),
    ],
    ids=["two_batches", "empirical", "reduce"],
)
def test_kfoc_refusals(kwargs, batches, match):
    *_, model, data = mlp_pair([4, 3, 2], 4, 0)
    X, y = data[0]
    data = [(X[:2], y[:2]), (X[2:], y[2:])] if batches == 2 else data
    with pytest.raises(ValueError, match=match):
        tkfoc.KFOCComputer(model, MSELoss("mean"), dict(model.named_parameters()), data,
                           check_deterministic=False, **kwargs)
