"""The port's stochastic estimators against the JAX package, on the CPU.

Each estimator's core fed the JAX package's own probes (drawn with
``curvlinops_tpu.estimators.sampling`` from the key splits the JAX function
makes) against the JAX estimator called with that key, in float64 to 1e-10;
the JAX package's statistical tests (``tests/test_estimators.py``, the first
four of ``tests/test_slq.py``) carried over to the port's generators; and
SLQ with ``f = identity`` against Hutchinson on the same probes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curvlinops_tpu.estimators import diagonal as jdiagonal
from curvlinops_tpu.estimators import norm as jnorm
from curvlinops_tpu.estimators import sampling as jsampling
from curvlinops_tpu.estimators import slq as jslq
from curvlinops_tpu.estimators import trace as jtrace
from curvlinops_tpu.ops.dense import MatrixLinearOperator as JMatrix
from curvlinops_tpu_torch import (
    GGNLinearOperator,
    IdentityLinearOperator,
    MatrixLinearOperator,
    MSELoss,
    hutchinson_diag,
    hutchinson_squared_fro,
    hutchinson_trace,
    hutchpp_trace,
    slq_function_trace,
    slq_logdet,
    xdiag,
    xtrace,
)
from curvlinops_tpu_torch.estimators import diagonal, norm, slq, trace
from curvlinops_tpu_torch.estimators.sampling import rademacher
from tests.test_torch_helpers import capped_torch_threads

_threads = capped_torch_threads()

PARITY_TOL = 1e-10  # float64, the port's cores on JAX's probes
DIM = 120  # the JAX package's tests/test_estimators.py
TINY = float(np.finfo(np.float64).tiny)


def gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------- #
# parity with the JAX package on its own probes, float64
# ---------------------------------------------------------------------- #
def _parity_cases():
    """``{name: (port estimate, JAX estimate)}`` on one SPD and one wide
    matrix, every JAX estimate computed once (one compiled call each)."""
    rng = np.random.default_rng(0)
    B = rng.standard_normal((40, 40))
    M = B @ B.T / 40 + np.eye(40)
    W = rng.standard_normal((12, 30))
    key = jax.random.key(3)
    k1, k2 = jax.random.split(key)  # hutchpp_trace's split
    with jax.enable_x64(True):
        def probes(k, dim, n, dist="rademacher"):
            return torch.from_numpy(np.array(jsampling.random_matrix(k, dim, n, dist, jnp.float64)))

        v0s = torch.from_numpy(np.array(jax.random.rademacher(key, (6, 40), jnp.float64)))

        @jax.jit
        def estimates(M, W, key):  # one compiled program: op by op takes seconds
            jM, jW = JMatrix(M), JMatrix(W)
            return {
                "hutchinson_trace": jtrace.hutchinson_trace(jM, 12, "normal", key=key),
                "hutchpp_trace": jtrace.hutchpp_trace(jM, 12, key=key),
                "xtrace": jtrace.xtrace(jM, 12, key=key),
                "hutchinson_diag": jdiagonal.hutchinson_diag(jM, 12, key=key),
                "xdiag": jdiagonal.xdiag(jM, 12, key=key),
                "hutchinson_squared_fro": jnorm.hutchinson_squared_fro(jW, 8, key=key),
                "slq_logdet": jslq.slq_logdet(jM, ncv=10, num_repeats=6, key=key),
            }

        jax_values = jax.block_until_ready(estimates(jnp.asarray(M), jnp.asarray(W), key))
        tM, tW = MatrixLinearOperator(torch.from_numpy(M)), MatrixLinearOperator(torch.from_numpy(W))
        port = {
            "hutchinson_trace": trace.hutchinson_trace_core(tM, probes(key, 40, 12, "normal")),
            "hutchpp_trace": trace.hutchpp_trace_core(tM, probes(k1, 40, 4), probes(k2, 40, 4)),
            "xtrace": trace.xtrace_core(tM, probes(key, 40, 6)),
            "hutchinson_diag": diagonal.hutchinson_diag_core(tM, probes(key, 40, 12)),
            "xdiag": diagonal.xdiag_core(tM, probes(key, 40, 6)),
            # the wide matrix is transposed: probes in its 12-dim row space
            "hutchinson_squared_fro": norm.hutchinson_squared_fro_core(tW, probes(key, 12, 8)),
            "slq_logdet": slq.slq_function_trace_core(
                tM, lambda t: torch.log(torch.clamp(t, min=TINY)), v0s.T, 10
            ),
        }
    return {name: (port[name], np.asarray(jax_values[name])) for name in port}


@pytest.fixture(scope="module")
def parity():
    return _parity_cases()


@pytest.mark.parametrize(
    "name",
    ["hutchinson_trace", "hutchpp_trace", "xtrace", "hutchinson_diag", "xdiag",
     "hutchinson_squared_fro", "slq_logdet"],
)
def test_core_matches_jax_on_its_probes(parity, name):
    """The port's core on the JAX package's probes equals the JAX estimate."""
    port, expected = parity[name]
    port = port.numpy()
    assert port.dtype == np.float64
    err = np.linalg.norm(port - expected) / np.linalg.norm(expected)
    assert err < PARITY_TOL, f"{name}: relative error {err}"


# ---------------------------------------------------------------------- #
# the JAX package's statistical tests, on the port's generators
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def spd_op():
    A = torch.randn((DIM, DIM), generator=gen(0)) / DIM**0.5
    M = A @ A.T + torch.eye(DIM)
    return MatrixLinearOperator(M), M.numpy()


def _averaged(estimator, op, num_matvecs, n_seeds=40, **kw):
    vals = [estimator(op, num_matvecs, generator=gen(s), **kw).numpy() for s in range(n_seeds)]
    return np.mean(vals, axis=0)


@pytest.mark.parametrize("distribution", ["rademacher", "normal"])
def test_hutchinson_trace_converges(spd_op, distribution):
    op, M = spd_op
    est = _averaged(hutchinson_trace, op, 60, distribution=distribution)
    assert abs(est - np.trace(M)) / abs(np.trace(M)) < 0.03


def test_hutchpp_trace_converges(spd_op):
    op, M = spd_op
    est = _averaged(hutchpp_trace, op, 60)
    assert abs(est - np.trace(M)) / abs(np.trace(M)) < 0.02


def test_xtrace_converges(spd_op):
    op, M = spd_op
    est = _averaged(xtrace, op, 60, n_seeds=10)
    assert abs(est - np.trace(M)) / abs(np.trace(M)) < 0.01


def test_hutchinson_diag_converges(spd_op):
    op, M = spd_op
    est = _averaged(hutchinson_diag, op, 64, n_seeds=250)
    scale = np.abs(np.diag(M)).max()
    assert np.abs(est - np.diag(M)).max() / scale < 0.15


def test_xdiag_converges(spd_op):
    op, M = spd_op
    est = _averaged(xdiag, op, 64, n_seeds=120)
    scale = np.abs(np.diag(M)).max()
    assert np.abs(est - np.diag(M)).max() / scale < 0.15


def test_xdiag_beats_hutchinson_on_decaying_spectrum():
    """Deflation pays off when a few directions dominate the spectrum."""
    Q, _ = torch.linalg.qr(torch.randn((DIM, DIM), generator=gen(9)))
    evals = torch.cat([torch.tensor([500.0, 200.0, 100.0, 50.0]), 0.1 * torch.ones(DIM - 4)])
    M = (Q * evals) @ Q.T
    op = MatrixLinearOperator(M)
    err_x = np.abs(_averaged(xdiag, op, 64, n_seeds=30) - np.diag(M.numpy())).max()
    err_h = np.abs(_averaged(hutchinson_diag, op, 64, n_seeds=30) - np.diag(M.numpy())).max()
    assert err_x < err_h, (err_x, err_h)


def test_squared_fro_converges(spd_op):
    op, M = spd_op
    est = _averaged(hutchinson_squared_fro, op, 60)
    truth = np.linalg.norm(M) ** 2
    assert abs(est - truth) / truth < 0.03


def test_squared_fro_rectangular():
    A = torch.randn((30, 200), generator=gen(1))
    est = _averaged(hutchinson_squared_fro, MatrixLinearOperator(A), 20, n_seeds=60)
    truth = float((A**2).sum())
    assert abs(est - truth) / truth < 0.05


def test_validation_errors(spd_op):
    op, _ = spd_op
    with pytest.raises(ValueError):
        xtrace(op, 7)  # not divisible by 2
    with pytest.raises(ValueError):
        hutchpp_trace(op, 8)  # not divisible by 3
    with pytest.raises(ValueError):
        hutchinson_trace(op, DIM + 2)  # too many matvecs
    with pytest.raises(ValueError):
        hutchinson_trace(MatrixLinearOperator(torch.ones((4, 6))), 2)  # not square
    with pytest.raises(ValueError):
        hutchinson_trace(op, 4, distribution="uniform")


def test_default_generators_decorrelate_repeats():
    """Without a generator, repeated calls draw fresh probes (from a
    per-process counter, not the global RNG); an explicit generator stays
    reproducible."""
    mat = torch.randn((32, 32), generator=gen(0))
    A = MatrixLinearOperator(mat @ mat.T)
    state = torch.random.get_rng_state()
    e1, e2 = float(hutchinson_trace(A, 4)), float(hutchinson_trace(A, 4))
    assert torch.equal(torch.random.get_rng_state(), state)
    assert e1 != e2
    assert float(hutchinson_trace(A, 4, generator=gen(3))) == float(
        hutchinson_trace(A, 4, generator=gen(3))
    )


def _spd_operator(dim=80, lo=0.5, hi=4.0, seed=0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(dim, dim)))
    evs = np.linspace(lo, hi, dim)
    return MatrixLinearOperator(torch.from_numpy((Q * evs) @ Q.T).float()), evs


def test_slq_logdet_dense():
    """SLQ's logdet of a dense SPD matrix against ``numpy.linalg.slogdet``."""
    A, evs = _spd_operator()
    est = float(slq_logdet(A, ncv=40, num_repeats=64, generator=gen(1)))
    exact = float(np.linalg.slogdet(A.A.double().numpy())[1])
    assert abs(exact - np.sum(np.log(evs))) < 1e-3
    assert abs(est - exact) / abs(exact) < 0.05


def test_slq_function_trace_inverse_and_identity():
    A, evs = _spd_operator(seed=1)
    est = float(slq_function_trace(A, lambda t: 1.0 / t, ncv=40, num_repeats=64,
                                   generator=gen(2)))
    exact = float(np.sum(1.0 / evs))
    assert abs(est - exact) / abs(exact) < 0.05
    est_tr = float(slq_function_trace(A, lambda t: t, ncv=40, num_repeats=64, generator=gen(3)))
    assert abs(est_tr - float(np.sum(evs))) / float(np.sum(evs)) < 0.05


def test_slq_identity_equals_hutchinson_on_the_same_probes():
    """Gauss quadrature is exact for degree 1: ``f = identity`` gives
    ``dim * e1^T T e1 = v^T A v`` per probe, Hutchinson's term."""
    A, _ = _spd_operator(dim=60, seed=5)
    A = MatrixLinearOperator(A.A.double())
    slq_est = slq_function_trace(A, lambda t: t, ncv=12, num_repeats=16, generator=gen(4))
    V = rademacher(gen(4), (16, 60), torch.float64).T
    hutch = trace.hutchinson_trace_core(A, V)
    assert abs(float(slq_est) - float(hutch)) <= 1e-12 * abs(float(hutch))


def test_slq_logdet_damped_ggn():
    """SLQ's logdet of a damped GGN on a tiny MLP against its dense matrix."""
    rng = np.random.default_rng(4)
    params = {
        "W1": torch.from_numpy(0.4 * rng.standard_normal((6, 8))).float(),
        "W2": torch.from_numpy(0.4 * rng.standard_normal((8, 4))).float(),
    }
    X = torch.from_numpy(rng.standard_normal((32, 6))).float()
    y = torch.from_numpy(rng.standard_normal((32, 4))).float()
    G = GGNLinearOperator(lambda p, x: torch.tanh(x @ p["W1"]) @ p["W2"], MSELoss("mean"),
                          params, [(X, y)], check_deterministic=False)
    damped = G + 0.5 * IdentityLinearOperator(G.in_spec)
    dim = damped.shape[0]  # 80; 40 Lanczos steps (the JAX test takes 80)
    est = float(slq_logdet(damped, ncv=dim // 2, num_repeats=64, generator=gen(5)))
    exact = float(np.linalg.slogdet(damped.todense().double().numpy())[1])
    assert abs(est - exact) / abs(exact) < 0.05


def test_slq_validation():
    A, _ = _spd_operator(dim=16)
    with pytest.raises(ValueError):
        slq_logdet(A, ncv=17)
    with pytest.raises(ValueError):
        slq_logdet(A, ncv=8, num_repeats=0)
