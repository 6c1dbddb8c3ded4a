"""The port's solvers and inverse operators against the JAX package.

``solvers/cg.py``, ``minres.py``, ``lsmr.py``, ``lanczos.py`` and
``eigsh.py`` (LOBPCG after ``jax.experimental.sparse.linalg.
lobpcg_standard``), and ``ops/inverse.py``, on the CPU. The solvers'
iterates are compared with the JAX package's from the same numpy inputs
and start vectors in float64, at a fixed iteration count (``tol=0``) and at
a tolerance where columns stop at different iterations, to 1e-10. Where
only the public API can be called (random start vectors drawn by each
package's own generator), converged results are held against the dense
``eigh``/``solve``, as the JAX package's tests do (``tests/test_inverse.py``,
``tests/test_spectrum.py``; its EKFAC half waits for EKFAC's port). The
float32 spectral densities are held by their integral and their support.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.sparse.linalg import lobpcg_standard as j_lobpcg
from torch import nn

import curvlinops_tpu_torch as T
from curvlinops_tpu.solvers import cg as jcg
from curvlinops_tpu.solvers import lanczos as jlanczos
from curvlinops_tpu.solvers import lsmr as jlsmr
from curvlinops_tpu.solvers import minres as jminres
from curvlinops_tpu_torch.losses import MSELoss
from curvlinops_tpu_torch.solvers import cg as tcg
from curvlinops_tpu_torch.solvers import eigsh as teigsh
from curvlinops_tpu_torch.solvers import lanczos as tlanczos
from curvlinops_tpu_torch.solvers import lsmr as tlsmr
from curvlinops_tpu_torch.solvers import minres as tminres
from tests.test_torch_curvature import jax_oracle, make_case, port_operator
from tests.test_torch_helpers import assert_close, capped_torch_threads, rel_fro

_threads = capped_torch_threads()

F64 = dict(rtol=1e-10, atol=1e-12)  # float64 iterates, the two packages
SOLVE32 = dict(rtol=1e-3, atol=1e-4)  # float32 solves against the dense solve (JAX tests)


def _spd(rng, n: int) -> np.ndarray:
    A = rng.standard_normal((n, n))
    return A @ A.T / n + np.eye(n)


def _indefinite(rng, n: int = 24) -> np.ndarray:
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    w = np.concatenate([np.linspace(-4, -2, n // 3), np.linspace(1.5, 6, n - n // 3)])
    return (Q * w) @ Q.T


def _matrix_op(M: np.ndarray, symmetric: bool = False) -> T.MatrixLinearOperator:
    op = T.MatrixLinearOperator(torch.from_numpy(M))
    op.SELF_ADJOINT = symmetric
    return op


# ---------------------------------------------------------------------- #
# the batched Krylov solvers, iterate for iterate
# ---------------------------------------------------------------------- #
def _krylov(solver: str, pkg, M: np.ndarray, B: np.ndarray, stop: dict):
    """One solve with the package's batched solver (``pkg`` is ``jnp`` or
    ``torch``), for ``A = M`` (LSMR: ``M`` is ``[30, 24]``)."""
    A = jnp.asarray(M) if pkg is jnp else torch.from_numpy(M)
    b = jnp.asarray(B) if pkg is jnp else torch.from_numpy(B)
    mod = {"cg": (jcg, tcg), "pcg": (jcg, tcg), "minres": (jminres, tminres),
           "lsmr": (jlsmr, tlsmr)}[solver][pkg is torch]
    if solver == "lsmr":
        return mod.batched_lsmr(lambda V: A @ V, lambda V: A.T @ V, b, **stop)
    kw = {"preconditioner": lambda R: R / pkg.diagonal(A)[:, None]} if solver == "pcg" else {}
    fn = mod.batched_cg if solver in ("cg", "pcg") else mod.batched_minres
    return fn(lambda V: A @ V, b, **stop, **kw)


@pytest.mark.parametrize(
    "solver, stopping",
    [("cg", "cap"), ("cg", "tol"), ("pcg", "cap"), ("minres", "cap"), ("minres", "tol"),
     ("lsmr", "cap"), ("lsmr", "tol")],
)
def test_krylov_solvers_match_jax(solver, stopping):
    """Three right-hand sides, float64: at the iteration cap with ``tol=0``,
    and at a tolerance where the columns stop at different iterations
    (converged columns freeze), the solution and every ``info`` entry
    agree to 1e-10."""
    rng = np.random.default_rng({"cg": 0, "pcg": 1, "minres": 2, "lsmr": 3}[solver])
    # each "tol" case stops well before the dimension: past it, Krylov
    # recurrences amplify roundoff and two correct runs drift apart
    if solver == "lsmr":
        M = np.vstack([3 * np.eye(24), np.zeros((6, 24))]) + 0.3 * rng.standard_normal((30, 24))
        stop = dict(maxiter=10, atol=0.0, btol=0.0) if stopping == "cap" else dict(
            maxiter=40, atol=1e-4, btol=1e-4)
    else:
        M = _indefinite(rng) if solver == "minres" else _spd(rng, 24) + np.diag(np.arange(24.0))
        stop = dict(maxiter=10, tol=0.0, atol=0.0) if stopping == "cap" else dict(
            maxiter=40, tol=1e-4, atol=1e-3)
    B = rng.standard_normal((M.shape[0], 3))
    if stopping == "tol":  # with atol, columns of different sizes stop at different iterations
        B = B * np.array([1.0, 1e-3, 1e3])
    with jax.enable_x64(True):
        X_j, info_j = _krylov(solver, jnp, M, B, stop)
        X_j, info_j = np.asarray(X_j), jax.tree.map(np.asarray, info_j)
    X_t, info_t = _krylov(solver, torch, M, B, stop)
    assert_close(X_t, X_j, **F64, name=f"{solver} X")
    for key, value in info_j.items():
        assert_close(torch.as_tensor(info_t[key]).double(), value.astype(np.float64), **F64,
                     name=f"{solver} {key}")
    # the port's histories (not in the JAX package's info) end at the final
    # residuals and hold one row more than the iterations
    final = {"lsmr": {"normr_history": "normr", "normar_history": "normar"},
             "minres": {"residual_history": "residuals"}}.get(
                 solver, {"residual_history": "residual_norms"})
    assert sorted(set(info_t) - set(info_j)) == sorted(final)
    for key, last in final.items():
        assert info_t[key].shape == (info_t["iterations"] + 1, 3)
        assert torch.equal(info_t[key][-1], info_t[last])
    if stopping == "tol" and solver != "lsmr":
        assert len(set(info_t["column_iterations"].tolist())) > 1


def test_lsmr_large_norm_operator_converges():
    """Stopping rule S1 uses the solution norm (Fong-Saunders): an operator
    with ``||A|| >= 1/atol`` must not stop at iteration 0 with ``X = 0``."""
    A = 2e6 * torch.eye(8)
    X, info = tlsmr.batched_lsmr(lambda v: A @ v, lambda v: A.T @ v, torch.ones(8, 1), maxiter=50)
    assert info["iterations"] >= 1
    assert_close(X, np.ones((8, 1)) / 2e6, rtol=1e-6, atol=0, name="X")


def test_solvers_take_trees():
    """A dict right-hand side with a column axis, through the operator's
    own tree space (the diagonal's): the solution comes back as a tree."""
    d = {"a": torch.tensor([[2.0, 4.0]], dtype=torch.float64), "b": torch.tensor([8.0], dtype=torch.float64)}
    D = T.DiagonalLinearOperator(d)
    B = {"a": torch.ones(1, 2, 2, dtype=torch.float64), "b": torch.ones(1, 2, dtype=torch.float64)}
    for solve in (lambda: tcg.batched_cg(D._matmat, B, tol=1e-12),
                  lambda: tminres.batched_minres(D._matmat, B, tol=1e-12),
                  lambda: tlsmr.batched_lsmr(D._matmat, D._matmat, B, atol=1e-12, btol=1e-12)):
        X, _ = solve()
        for k in d:
            assert_close(X[k], (1 / d[k])[..., None].expand_as(B[k]), rtol=1e-8, atol=0, name=k)


# ---------------------------------------------------------------------- #
# the inverse operators (tests/test_inverse.py)
# ---------------------------------------------------------------------- #
def test_cg_inverse():
    """Dense SPD with three right-hand sides; with a diagonal preconditioner
    on the flat space (float32, against the dense solve)."""
    rng = np.random.default_rng(0)
    M = _spd(rng, 8).astype(np.float32)
    B = rng.standard_normal((8, 3)).astype(np.float32)
    inv = T.CGInverseLinearOperator(_matrix_op(M, True), maxiter=200, tol=1e-7)
    assert_close(inv @ torch.from_numpy(B), np.linalg.solve(M, B), **SOLVE32, name="CG")
    assert inv.last_info["iterations"] <= 200 and inv.SELF_ADJOINT
    P = T.DiagonalLinearOperator(1.0 / torch.from_numpy(np.diag(M).copy()))
    inv = T.CGInverseLinearOperator(_matrix_op(M, True), maxiter=200, tol=1e-7, preconditioner=P)
    assert_close(inv @ B[:, 0], np.linalg.solve(M, B[:, 0]), **SOLVE32, name="PCG")


def test_cg_inverse_of_curvature_operator_matches_jax():
    """The damped GGN of a small MLP (float64) through the data loop:
    six iterations against the JAX package's ``batched_cg`` on the JAX
    GGN's matrix, to 1e-10; converged, against the dense solve."""
    with jax.enable_x64(True):
        case = make_case("mlp_mse_mean", np.float64)
        G = port_operator("ggn", case)
        dense = jax_oracle("ggn", case) + 0.1 * np.eye(G.shape[0])
        b = np.random.default_rng(2).standard_normal((G.shape[0], 1))
        X_j, _ = jcg.batched_cg(lambda V: jnp.asarray(dense) @ V, jnp.asarray(b),
                                maxiter=6, tol=0.0, atol=0.0)
    damped = G + 0.1 * T.IdentityLinearOperator(G.in_spec)
    inv = T.CGInverseLinearOperator(damped, maxiter=6, tol=0.0, atol=0.0)
    assert_close(inv @ torch.from_numpy(b), np.asarray(X_j), **F64, name="6 iterations")
    inv.set_cg_hyperparameters(maxiter=500, tol=1e-12)
    assert_close(inv @ torch.from_numpy(b), np.linalg.solve(dense, b), **F64, name="converged")


def test_minres_inverse():
    """Indefinite dense (where CG has no guarantee), a small MLP's
    indefinite Hessian shifted by ``-0.09 I`` (float64; no eigenvalue within 0.015 of 0), and the refusal of
    an operator not marked symmetric."""
    rng = np.random.default_rng(5)
    M = _indefinite(rng).astype(np.float32)
    v = rng.standard_normal(24).astype(np.float32)
    inv = T.MINRESInverseLinearOperator(_matrix_op(M, True), maxiter=200, tol=1e-7)
    assert_close(inv @ v, np.linalg.solve(M, v), **SOLVE32, name="MINRES indefinite")
    assert inv.last_info["iterations"] <= 200 and inv.adjoint() is inv
    case = make_case("mlp_mse_mean", np.float64)
    H = port_operator("hessian", case, check_deterministic=False)
    A = H - 0.09 * T.IdentityLinearOperator(H.in_spec)
    dense = A.todense().numpy()
    assert np.linalg.eigvalsh(dense).min() < 0
    b = np.random.default_rng(6).standard_normal(H.shape[0])
    inv = T.MINRESInverseLinearOperator(A, maxiter=600, tol=1e-12)
    # residual 1e-12 relative, condition number 140: 1e-8 relative in norm
    assert rel_fro(inv @ b, np.linalg.solve(dense, b)) < 1e-8
    with pytest.raises(ValueError, match="symmetric"):
        T.MINRESInverseLinearOperator(_matrix_op(M))


@pytest.mark.parametrize("shape", ["least squares", "square"])
def test_lsmr_inverse(shape):
    rng = np.random.default_rng(2)
    M = (rng.standard_normal((12, 5)) if shape == "least squares" else _spd(rng, 6)).astype(np.float32)
    B = rng.standard_normal((M.shape[0], 2)).astype(np.float32)
    inv = T.LSMRInverseLinearOperator(_matrix_op(M), maxiter=200, atol=1e-7, btol=1e-7)
    expected = np.linalg.lstsq(M, B, rcond=None)[0]
    assert_close(inv @ torch.from_numpy(B), expected, **SOLVE32, name=shape)
    assert inv.shape == (M.shape[1], M.shape[0]) and inv.lsmr_info is not None


@pytest.mark.parametrize("case", ["plain", "preconditioned", "zero terms", "as a preconditioner"])
def test_neumann_inverse(case):
    """Well-conditioned (60 terms); left-preconditioned by the exact inverse
    of a diagonal whose plain series diverges (30 terms); ``num_terms=0``
    (``scale * M``); as a CG preconditioner."""
    rng = np.random.default_rng(5)
    b = rng.standard_normal(6).astype(np.float32)
    if case == "plain":
        M = (np.eye(6) + 0.01 * _spd(rng, 6)).astype(np.float32)
        out, expected = T.NeumannInverseLinearOperator(_matrix_op(M), num_terms=60) @ b, np.linalg.solve(M, b)
    elif case == "preconditioned":
        d = np.array([5.0, 2.0, 0.5, 1.5, 3.0, 1.0], np.float32)
        P = T.DiagonalLinearOperator(torch.from_numpy(1 / d))
        inv = T.NeumannInverseLinearOperator(_matrix_op(np.diag(d)), num_terms=30, preconditioner=P)
        out, expected = inv @ b, b / d
    elif case == "zero terms":
        inv = T.NeumannInverseLinearOperator(_matrix_op(2 * np.eye(6, dtype=np.float32)),
                                             num_terms=0, scale=0.25)
        out, expected = inv @ b, 0.25 * b
    else:
        P = T.NeumannInverseLinearOperator(_matrix_op(np.eye(6, dtype=np.float32)), num_terms=5)
        cg = T.CGInverseLinearOperator(_matrix_op(2 * np.eye(6, dtype=np.float32), True),
                                       preconditioner=P, maxiter=50, tol=1e-10)
        out, expected = cg @ b, b / 2
    assert_close(out, expected, rtol=1e-5, atol=1e-6, name=case)


def test_neumann_divergence_raises():
    """``||I - A|| = 4``: NaN from some term on, reported after the loop
    with the first bad term."""
    inv = T.NeumannInverseLinearOperator(_matrix_op(5 * np.eye(4, dtype=np.float32)), num_terms=200)
    with pytest.raises(ValueError, match=r"diverged \(NaN at term \d+\)"):
        inv @ np.ones(4, np.float32)


def test_kfac_exact_preconditioner_for_cg_and_neumann():
    """KFAC's exact-damped inverse as an exact preconditioner: for one
    linear layer with MSE the GGN equals KFAC's type-2 approximation, so
    preconditioned CG converges at once and a 0-term preconditioned Neumann
    series is already exact (the KFAC half of the JAX package's
    ``tests/test_inverse.py::test_kfac_ekfac_exact_preconditioners_for_cg_and_neumann``,
    at its tolerances: KFAC's factors accumulate in float32, as there)."""
    gen = torch.Generator().manual_seed(1234)
    model = nn.Linear(3, 2, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.randn(2, 3, generator=gen) / 3**0.5)
    params = {n: p.detach() for n, p in model.named_parameters()}
    data = [(torch.randn(6, 3, generator=gen), torch.randn(6, 2, generator=gen))]
    delta = 1e-2
    ggn = T.GGNLinearOperator(model, MSELoss("mean"), params, data)
    damped = ggn + delta * T.IdentityLinearOperator(ggn.in_spec)
    expected = np.linalg.inv(damped.todense().double().numpy())
    kfac = T.KFACLinearOperator(model, MSELoss("mean"), params, data, fisher_type="type-2",
                                check_deterministic=False)
    pre = kfac.inverse(damping=delta, use_exact_damping=True)
    assert_close(pre.todense(), expected, rtol=5e-4, atol=1e-5, name="KFAC inverse")
    cg = T.CGInverseLinearOperator(damped, tol=1e-8, preconditioner=pre)
    assert_close(cg.todense(), expected, rtol=1e-4, atol=1e-5, name="CG + KFAC")
    neumann = T.NeumannInverseLinearOperator(damped, num_terms=0, preconditioner=pre)
    assert_close(neumann.todense(), expected, rtol=1e-4, atol=1e-5, name="Neumann + KFAC")


@pytest.mark.parametrize("kind", ["cg", "lsmr", "neumann"])
def test_inverse_adjoints(kind):
    """The adjoint of each inverse is the inverse of the adjoint (float64,
    a nonsymmetric ``A``): ``(A^{-1})^T``, ``(A^+)^T = (A^T)^+``."""
    rng = np.random.default_rng(8)
    M = np.eye(6) + 0.1 * rng.standard_normal((6, 6))
    if kind == "lsmr":
        M = rng.standard_normal((9, 6))
    A = _matrix_op(M)
    inv = {
        "cg": lambda: T.CGInverseLinearOperator(A, maxiter=6, tol=0.0, atol=0.0),
        "lsmr": lambda: T.LSMRInverseLinearOperator(A, maxiter=50, atol=1e-14, btol=1e-14),
        "neumann": lambda: T.NeumannInverseLinearOperator(A, num_terms=80),
    }[kind]()
    adj = inv.adjoint()
    expected = np.linalg.pinv(M.T) if kind != "cg" else None
    if kind == "cg":  # CG on a nonsymmetric A: the adjoint runs CG on A^T
        expected = T.CGInverseLinearOperator(_matrix_op(M.T), maxiter=6, tol=0.0, atol=0.0).todense()
    assert_close(adj.todense(), expected, rtol=1e-8, atol=1e-10, name=kind)


@pytest.mark.parametrize("kind", ["cg", "minres", "lsmr", "neumann"])
def test_set_hyperparameters(kind):
    """Each change applies to the next solve; unknown names are refused."""
    A = _matrix_op(_spd(np.random.default_rng(0), 6), True)
    b = torch.ones(6, dtype=torch.float64)
    if kind == "neumann":
        inv = T.NeumannInverseLinearOperator(A, num_terms=3, scale=0.5)
        before = inv @ b
        inv.set_neumann_hyperparameters(num_terms=0, scale=0.25)
        assert_close(inv @ b, 0.25 * b, **F64, name="num_terms=0") and not torch.equal(before, inv @ b)
        return
    cls, setter, info = {
        "cg": (T.CGInverseLinearOperator, "set_cg_hyperparameters", "last_info"),
        "minres": (T.MINRESInverseLinearOperator, "set_minres_hyperparameters", "last_info"),
        "lsmr": (T.LSMRInverseLinearOperator, "set_lsmr_hyperparameters", "lsmr_info"),
    }[kind]
    inv = cls(A)
    inv @ b
    assert getattr(inv, info)["iterations"] > 1
    getattr(inv, setter)(maxiter=1)
    inv @ b
    assert getattr(inv, info)["iterations"] == 1
    with pytest.raises(ValueError, match="Unknown"):
        getattr(inv, setter)(maxiter=2, bogus=1)


# ---------------------------------------------------------------------- #
# Lanczos, spectral densities (tests/test_spectrum.py)
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def spd():
    M = _spd(np.random.default_rng(0), 40) - 0.5 * np.eye(40)
    return _matrix_op(M, True), M


@pytest.fixture(scope="module")
def indefinite():
    A = np.random.default_rng(7).standard_normal((40, 40)) / np.sqrt(40)
    M = (A + A.T) / 2 - 0.3 * np.eye(40)
    return _matrix_op(M, True), M


def test_fast_lanczos_matches_jax(spd):
    """Eight steps from one start vector, float64: the tridiagonal's
    eigenvalues and eigenvectors (up to sign) agree to 1e-10."""
    op, M = spd
    v0 = np.random.default_rng(1).standard_normal(40)
    with jax.enable_x64(True):
        evals_j, evecs_j = jlanczos._fast_lanczos_loop(
            lambda v, c: jnp.asarray(M) @ v, (), jnp.asarray(v0), 8, jnp.float64)
        evals_j, evecs_j = np.asarray(evals_j), np.asarray(evecs_j)
    evals_t, evecs_t = tlanczos.fast_lanczos(op, 8, v0=torch.from_numpy(v0))
    assert_close(evals_t, evals_j, **F64, name="Ritz values")
    assert_close(evecs_t.abs(), np.abs(evecs_j), **F64, name="|Ritz vectors|")


def test_fast_lanczos_full_rank_recovers_eigvals():
    """With ``ncv == dim`` and a well-separated spectrum, Ritz values are
    the eigenvalues."""
    op = _matrix_op(np.diag([1.0, 3.0, 7.0, 15.0, 40.0]), True)
    evals, _ = tlanczos.fast_lanczos(op, 5)
    assert_close(evals, [1, 3, 7, 15, 40], rtol=1e-8, atol=0, name="eigenvalues")


@pytest.mark.parametrize("which", ["BE", "SA", "LA", "LM", "SM"])
def test_lanczos_eigsh_selectors(indefinite, which):
    """Every selector against the dense ``eigvalsh``, as the JAX test."""
    op, M = indefinite
    evals = np.linalg.eigvalsh(M)
    scale = max(abs(evals[0]), abs(evals[-1]))
    got = tlanczos.lanczos_eigsh(op, which=which)
    expected = {"BE": (evals[0], evals[-1]), "SA": evals[0], "LA": evals[-1],
                "LM": np.abs(evals).max(), "SM": np.abs(evals).min()}[which]
    assert np.allclose(got, expected, rtol=0, atol=(0.05 if which == "SM" else 0.02) * scale)


def test_lanczos_eigsh_rejects_unknown_selector(indefinite):
    with pytest.raises(ValueError, match="selector"):
        tlanczos.lanczos_eigsh(indefinite[0], which="XX")


def test_boundaries(spd):
    """Signed and absolute boundaries, and partly given ones."""
    op, M = spd
    evals = np.linalg.eigvalsh(M)
    lo, hi = tlanczos.approximate_boundaries(op)
    assert abs(hi - evals[-1]) / evals[-1] < 0.02 and 0 < lo <= evals[0] * 1.2
    _, ahi = tlanczos.approximate_boundaries_abs(op)
    assert abs(ahi - evals[-1]) / evals[-1] < 0.02
    lo2, hi2 = tlanczos.approximate_boundaries(op, boundaries=(0.1, None))
    assert lo2 == 0.1 and abs(hi2 - evals[-1]) / evals[-1] < 0.02
    # |A| of a spectrum straddling zero: its smallest magnitude, not min(|extremes|)
    lo, hi = tlanczos.approximate_boundaries_abs(
        _matrix_op(np.diag([-5.0, -1.0, 0.01, 0.5, 3.0, 10.0]), True))
    assert abs(hi - 10.0) < 0.5 and lo < 0.1


@pytest.mark.parametrize("log", [False, True], ids=["spectrum", "log_spectrum"])
def test_density_matches_jax(spd, log):
    """From one Lanczos run's ``(evals, evecs)`` (float64) the density and
    its grid agree with the JAX package's to 1e-10; end to end in float32
    (each package's own start vectors), the density integrates to one and
    has the JAX density's support."""
    op, M = spd
    evals, evecs = tlanczos.fast_lanczos(op, 12)
    bounds = (0.3, 4.5)
    args = (128, 1.04, 0.05, 1e-5) if log else (128, 3.0, 0.05)
    port_fn = (tlanczos.lanczos_approximate_log_spectrum_from_iter if log
               else tlanczos.lanczos_approximate_spectrum_from_iter)
    jax_fn = (jlanczos.lanczos_approximate_log_spectrum_from_iter if log
              else jlanczos.lanczos_approximate_spectrum_from_iter)
    with jax.enable_x64(True):
        grid_j, dens_j = jax_fn((jnp.asarray(evals.numpy()), jnp.asarray(evecs.numpy())), bounds, *args)
        grid_j, dens_j = np.asarray(grid_j), np.asarray(dens_j)
    grid_t, dens_t = port_fn((evals, evecs), bounds, *args)
    assert_close(grid_t, grid_j, **F64, name="grid")
    assert_close(dens_t, dens_j, **F64, name="density")

    op32 = _matrix_op(M.astype(np.float32), True)
    kw = dict(ncv=32, num_points=256, num_repeats=2)
    run_t = (T.lanczos_approximate_log_spectrum if log else T.lanczos_approximate_spectrum)(op32, **kw)
    import curvlinops_tpu as J

    run_j = (J.lanczos_approximate_log_spectrum if log else J.lanczos_approximate_spectrum)(
        J.MatrixLinearOperator(jnp.asarray(M, jnp.float32)), **kw, key=jax.random.key(3))
    for name, (grid, dens) in (("port", run_t), ("JAX", run_j)):
        grid, dens = np.asarray(grid, np.float64), np.asarray(dens, np.float64)
        assert abs(np.trapezoid(dens, grid) - 1) < (0.1 if log else 0.05), name
        support = grid[dens > 1e-3 * dens.max()]
        if name == "port":
            port_support = support[[0, -1]]
        else:
            assert np.allclose(port_support, support[[0, -1]], rtol=0.05), (port_support, support)
    assert isinstance(run_t[1], torch.Tensor) and run_t[1].dtype == torch.float32


def test_cached_spectrum_matches_and_extends(spd):
    op, _ = spd
    cached = T.LanczosApproximateSpectrumCached(op, ncv=16)
    _, d1 = cached.approximate_spectrum(num_repeats=2, num_points=64)
    assert len(cached._iters) == 2
    cached.approximate_spectrum(num_repeats=4, num_points=64)
    assert len(cached._iters) == 4
    _, d1b = cached.approximate_spectrum(num_repeats=2, num_points=64)
    assert torch.equal(d1, d1b)
    log_cached = T.LanczosApproximateLogSpectrumCached(op, ncv=16)
    _, d = log_cached.approximate_log_spectrum(num_repeats=2, num_points=64)
    assert bool(d.isfinite().all())


# ---------------------------------------------------------------------- #
# LOBPCG and the smallest eigenvalue
# ---------------------------------------------------------------------- #
def test_lobpcg_matches_jax(spd):
    """Six iterations from one start block, float64: the Ritz values and
    vectors (up to sign) agree with ``jax.experimental.sparse.linalg.
    lobpcg_standard``'s to 1e-10."""
    _, M = spd
    X0 = np.random.default_rng(3).standard_normal((40, 3))
    with jax.enable_x64(True):
        theta_j, U_j, i_j = j_lobpcg(jnp.asarray(M), jnp.asarray(X0), m=6)
        theta_j, U_j = np.asarray(theta_j), np.asarray(U_j)
    theta_t, U_t, i_t = teigsh.lobpcg_standard(torch.from_numpy(M), torch.from_numpy(X0), m=6)
    assert i_t == int(i_j) == 6
    assert_close(theta_t, theta_j, **F64, name="Ritz values")
    assert_close(U_t.abs(), np.abs(U_j), **F64, name="|Ritz vectors|")


def test_topk_eigenpairs_and_smallest_eigenvalue(spd):
    """The public API (its own start block) against the dense ``eigh``."""
    op, M = spd
    evals, evecs = T.topk_eigenpairs(op, k=4, maxiter=200)
    ref = np.linalg.eigvalsh(M)
    assert_close(evals, ref[::-1][:4], rtol=1e-6, atol=0, name="top 4")
    R = M @ evecs.numpy() - evecs.numpy() * evals.numpy()
    assert np.abs(R).max() < 1e-5
    assert abs(float(teigsh.smallest_eigenvalue(op, num_iters=40)) - ref[0]) < 1e-8


@pytest.mark.parametrize("case", ["k = 0", "5k >= n", "dtype"])
def test_lobpcg_refuses(case):
    M = torch.eye(20, dtype=torch.float64)
    X = {"k = 0": torch.zeros(20, 0, dtype=torch.float64),
         "5k >= n": torch.ones(20, 4, dtype=torch.float64),
         "dtype": torch.ones(20, 2)}[case]
    with pytest.raises(ValueError):
        teigsh.lobpcg_standard(lambda V: M @ V.double(), X)
