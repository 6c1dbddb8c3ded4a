"""The captured solvers (CG, MINRES, LSMR, LOBPCG as chunked loops) and the
operators marked ``capturable``, against the JAX package, on the CPU.

On the CPU a chunked loop (``utils/graphs.py::ChunkedLoop``) runs the chunk
it captures on the card, eagerly: ``CHUNK`` masked iterations, then one read
of the flag. The inverse operators run it over ``capturable`` operators; the
solver functions run the eager loop (one read an iteration). Both are held
to the JAX package's ``batched_cg``, ``batched_minres`` and ``batched_lsmr``
in float64 where a solve stops at iteration 1, ``CHUNK - 1``, ``CHUNK`` and
``CHUNK + 1`` (diagonal systems whose right-hand sides reach as many
distinct eigenvalues as the iterations, one column fewer) and at a cap that
is not a multiple of ``CHUNK``: the same iteration and column counts, the
solutions to 1e-10, and one flag read a chunk. Then the twins of
``tests/test_traced.py``'s CG program cache, fused-against-eager
``topk_eigenpairs`` and KFAC-preconditioned CG; each class newly marked
``capturable`` inside a Neumann series and a CG solve against the JAX
operator's dense matrix; and the Jacobians' held-batch products against
their streamed ones, with LSMR over them. Every JAX oracle of the module is
one ``jax.jit`` call (:func:`jx`).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import curvlinops_tpu as cl
import curvlinops_tpu_torch as T
from curvlinops_tpu.kfac.operator import KFACLinearOperator as JKFAC
from curvlinops_tpu.losses import MSELoss as JMSELoss
from curvlinops_tpu.ops import kronecker as jkron
from curvlinops_tpu.ops import stacked as jstacked
from curvlinops_tpu.solvers import cg as jcg
from curvlinops_tpu.solvers import lsmr as jlsmr
from curvlinops_tpu.solvers import minres as jminres
from curvlinops_tpu_torch.losses import MSELoss
from curvlinops_tpu_torch.ops import kronecker as tkron
from curvlinops_tpu_torch.ops import stacked as tstacked
from curvlinops_tpu_torch.solvers import cg as tcg
from curvlinops_tpu_torch.solvers import eigsh as teigsh
from curvlinops_tpu_torch.solvers import lsmr as tlsmr
from curvlinops_tpu_torch.solvers import minres as tminres
from curvlinops_tpu_torch.utils.graphs import CHUNK, ChunkedLoop, EagerLoop
from tests.test_torch_helpers import (
    assert_close,
    capped_torch_threads,
    mlp_pair,
    port_order,
    rel_fro,
)

_threads = capped_torch_threads()

F64 = dict(rtol=1e-10, atol=1e-12)
STOPS = {"1": 1, "c-1": CHUNK - 1, "c": CHUNK, "c+1": CHUNK + 1}
CAP = 2 * CHUNK + 1  # a cap that is not a multiple of the chunk


# ---------------------------------------------------------------------- #
# the inputs, as numpy
# ---------------------------------------------------------------------- #
def _boundary_case(solver: str, stop: str):
    """``(A, B, kwargs, expected iterations)``: a diagonal system whose
    columns reach 1, ``s - 1`` and ``s`` distinct eigenvalues (so they
    converge after as many iterations, the solve after ``s``; LSMR's all
    ``s``), or a dense one run to the cap with ``tol = 0``."""
    rng = np.random.default_rng(len(stop) + {"cg": 0, "minres": 10, "lsmr": 20}[solver])
    if stop == "cap":
        M = rng.standard_normal((12, 12))
        A = M @ M.T / 12 + np.eye(12)
        if solver == "lsmr":
            A = np.vstack([A, 0.3 * rng.standard_normal((4, 12))])
        kw = dict(maxiter=CAP, atol=0.0, btol=0.0) if solver == "lsmr" else dict(
            maxiter=CAP, tol=0.0, atol=0.0)
        return A, rng.standard_normal((A.shape[0], 3)), kw, CAP
    s = STOPS[stop]
    distinct = CHUNK + 2
    eig = np.arange(1.0, distinct + 1)
    if solver == "minres":  # indefinite
        eig = eig * (-1.0) ** np.arange(distinct)
    d = np.repeat(eig, 2)  # each eigenvalue twice
    # LSMR: every column at s; one whose Krylov space runs out before the
    # others turns NaN (0 / 0 in its rotations, as in the JAX package) and
    # never meets the test again, so the solve would run to the cap
    reach = (s, s, s) if solver == "lsmr" else (1, max(s - 1, 1), s)
    x = np.zeros((2 * distinct, 3))
    for j, m in enumerate(reach):
        x[: 2 * m, j] = rng.standard_normal(2 * m)
    if solver == "lsmr":  # [diag(d); 0] with the right-hand side in its range
        A = np.vstack([np.diag(d), np.zeros((4, 2 * distinct))])
        return A, A @ x, dict(maxiter=20, atol=1e-10, btol=1e-10), s
    return np.diag(d), np.diag(d) @ x, dict(maxiter=20, tol=1e-10, atol=0.0), s


BOUNDARY = [(solver, stop) for solver in ("cg", "minres", "lsmr") for stop in [*STOPS, "cap"]]


def _spd(rng, *shape):
    M = rng.standard_normal(shape)
    return M @ np.swapaxes(M, -1, -2) / shape[-1] + np.eye(shape[-1])


def _orth(rng, *shape):
    return np.linalg.qr(rng.standard_normal(shape))[0]


def _structured():
    """numpy data of one operator of each structured class marked
    ``capturable``."""
    rng = np.random.default_rng(5)
    return {
        "kron": (_spd(rng, 3, 3), _spd(rng, 4, 4)),
        "stacked_kron": (_spd(rng, 2, 3, 3), _spd(rng, 2, 4, 4)),
        "stacked_eigh": (rng.random((2, 12)) + 0.5, _orth(rng, 2, 3, 3), _orth(rng, 2, 4, 4)),
        "embedding_kron": (_spd(rng, 3, 3), rng.random(5) + 0.5),
        "embedding_eigh": (rng.random((3, 5)) + 0.5, _orth(rng, 3, 3)),
        "eigh": (rng.random(12) + 0.5, _orth(rng, 3, 3), _orth(rng, 4, 4)),
        "blockdiag": (_spd(rng, 2, 2), _spd(rng, 3, 3), _spd(rng, 4, 4)),
        "submatrix": (_spd(rng, 9, 9), [0, 2, 3, 5, 7]),
    }


def _ops(pkg: str, kind: str, data):
    """The operator of ``kind`` in the JAX package (``"jax"``) or the port."""
    arr = (lambda a: jnp.asarray(a)) if pkg == "jax" else (lambda a: torch.from_numpy(np.asarray(a)))
    kron = jkron if pkg == "jax" else tkron
    stacked = jstacked if pkg == "jax" else tstacked
    pkg_ = cl if pkg == "jax" else T
    if kind == "kron":
        return kron.KroneckerProductLinearOperator(*map(arr, data))
    if kind == "stacked_kron":
        return stacked.StackedKroneckerOperator(*map(arr, data))
    if kind == "stacked_eigh":
        return stacked.StackedEighOperator(arr(data[0]), [arr(data[1]), arr(data[2])])
    if kind == "embedding_kron":
        return kron.EmbeddingKroneckerOperator(*map(arr, data))
    if kind == "embedding_eigh":
        return kron.EmbeddingEighOperator(*map(arr, data))
    if kind == "eigh":
        Q = kron.KroneckerProductLinearOperator(arr(data[1]), arr(data[2]))
        return pkg_.EighDecomposedLinearOperator(arr(data[0]), Q)
    if kind == "blockdiag":
        return pkg_.BlockDiagonalLinearOperator([
            kron.KroneckerProductLinearOperator(arr(data[0]), arr(data[1])),
            pkg_.MatrixLinearOperator(arr(data[2])),
        ])
    return pkg_.SubmatrixLinearOperator(pkg_.MatrixLinearOperator(arr(data[0])), data[1], data[1])


def _mlp():
    """The same tanh MLP 6-10-3 in both packages, float64, MSE, two batches
    of four: ``(jax model_fn, jax params, jax data, module, port data)``."""
    model_fn, jparams, jdata, model, data = mlp_pair([6, 10, 3], 8, 11)
    jparams = jax.tree.map(lambda a: np.asarray(a, np.float64), jparams)
    (X, y), (Xt, yt) = jdata[0], data[0]
    jdata = [(X[:4].astype(np.float64), y[:4].astype(np.float64)),
             (X[4:].astype(np.float64), y[4:].astype(np.float64))]
    data = [(Xt[:4].double(), yt[:4].double()), (Xt[4:].double(), yt[4:].double())]
    return model_fn, jparams, jdata, model.double(), data


# ---------------------------------------------------------------------- #
# every JAX oracle of the module: one jax.jit call
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jx():
    model_fn, jparams, jdata, model, data = _mlp()
    structured = _structured()
    with jax.enable_x64(True):
        jparams = jax.tree.map(jnp.asarray, jparams)
        jdata = [(jnp.asarray(X), jnp.asarray(y)) for X, y in jdata]
        G = cl.GGNLinearOperator(model_fn, JMSELoss("mean"), jparams, jdata,
                                 check_deterministic=False)
        J = cl.JacobianLinearOperator(model_fn, jparams, jdata, check_deterministic=False)
        kfac = JKFAC(model_fn, JMSELoss("mean"), jparams, jdata, fisher_type="type-2",
                     check_deterministic=False)
        ops = {kind: _ops("jax", kind, d) for kind, d in structured.items()}
        ops["kfac"], ops["kfac_inverse"] = kfac, kfac.inverse(damping=1e-2)
        boundary = {key: _boundary_case(*key) for key in BOUNDARY}
        mat = np.random.default_rng(1).standard_normal((40, 40))

        def oracles(b_inputs, eye_p, eye_j):
            out = {"G": G @ eye_p, "J": J @ eye_p, "Jt": J.T @ eye_j}
            for kind, op in ops.items():
                out[kind] = op @ jnp.eye(op.shape[1], dtype=jnp.float64)
            for name, (A, B) in b_inputs.items():
                key = tuple(name.split("/"))
                kw = boundary[key][2]
                solver = key[0]
                if solver == "lsmr":
                    out["/".join(key)] = jlsmr.batched_lsmr(lambda V: A @ V, lambda V: A.T @ V, B, **kw)
                else:
                    fn = jcg.batched_cg if solver == "cg" else jminres.batched_minres
                    out["/".join(key)] = fn(lambda V: A @ V, B, **kw)
            A40 = jnp.asarray(mat @ mat.T + np.eye(40))
            out["topk"] = cl.topk_eigenpairs(cl.MatrixLinearOperator(A40), k=3, maxiter=100,
                                             key=jax.random.key(2), jit=False)[0]
            return out

        n_p = G.shape[1]
        b_inputs = {"/".join(key): (jnp.asarray(c[0]), jnp.asarray(c[1]))
                    for key, c in boundary.items()}
        out = jax.jit(oracles)(b_inputs, jnp.eye(n_p, dtype=jnp.float64),
                               jnp.eye(J.shape[0], dtype=jnp.float64))
        out = jax.tree.map(np.asarray, out)
    names = [n for n, _ in model.named_parameters()]
    perm = port_order(jparams, model, names).numpy()
    for key in ("G", "kfac", "kfac_inverse"):  # into the port's parameter order
        out[key] = out[key][perm][:, perm]
    out["J"] = out["J"].reshape(-1, n_p)[:, perm]
    out["Jt"] = out["Jt"].reshape(n_p, -1)[perm]
    return out, boundary, structured, (model, data), mat


def _port_mlp_ops(model, data):
    params = dict(model.named_parameters())
    G = T.GGNLinearOperator(model, MSELoss("mean"), params, data, check_deterministic=False)
    J = T.JacobianLinearOperator(model, params, data, check_deterministic=False)
    return params, G, J


# ---------------------------------------------------------------------- #
# chunk boundaries and host reads
# ---------------------------------------------------------------------- #
def _port_solve(solver: str, A: np.ndarray, B: np.ndarray, kw: dict, captured: bool):
    """The port's solve: through the inverse operator over a (capturable)
    dense operator, or the solver function with the eager loop. Returns
    ``(X, info, host reads)``."""
    op = T.MatrixLinearOperator(torch.from_numpy(A))
    op.SELF_ADJOINT = solver != "lsmr"
    Bt = torch.from_numpy(B)
    if captured:
        if solver == "lsmr":
            inv = T.LSMRInverseLinearOperator(op, **kw)
            X = inv @ Bt
            return X, inv.lsmr_info, inv.lsmr_info["host_reads"]
        cls = T.CGInverseLinearOperator if solver == "cg" else T.MINRESInverseLinearOperator
        inv = cls(op, **kw)
        X = inv @ Bt
        assert isinstance(inv._program_cache[1][(solver, kw["maxiter"], kw["tol"], kw["atol"], B.shape[1],
                                                 torch.float64)], ChunkedLoop)
        return X, inv.last_info, inv.last_info["host_reads"]
    loop = EagerLoop()
    if solver == "lsmr":
        X, info = tlsmr.batched_lsmr(op._matmat, op.adjoint()._matmat, Bt, loop=loop, **kw)
    else:
        fn = tcg.batched_cg if solver == "cg" else tminres.batched_minres
        X, info = fn(op._matmat, Bt, loop=loop, **kw)
    return X, info, loop.host_reads


@pytest.mark.parametrize("captured", [True, False], ids=["chunked", "eager"])
@pytest.mark.parametrize("solver, stop", BOUNDARY)
def test_chunk_boundaries_match_jax(jx, solver, stop, captured):
    """Iteration and column counts equal JAX's, the solution within 1e-10;
    the chunked loop reads its flag ``ceil(k / CHUNK)`` times, the eager
    one before each iteration (and once more when a test stopped it)."""
    out, boundary, *_ = jx
    A, B, kw, expected = boundary[(solver, stop)]
    X_j, info_j = out[f"{solver}/{stop}"]
    assert int(info_j["iterations"]) == expected  # the case stops where it says
    X, info, reads = _port_solve(solver, A, B, kw, captured)
    assert info["iterations"] == expected
    if solver != "lsmr":
        assert info["column_iterations"].tolist() == info_j["column_iterations"].tolist()
        if stop != "cap":
            assert len(set(info_j["column_iterations"].tolist())) == min(expected, 3)
    assert_close(X, X_j, **F64, name=f"{solver} X")
    k = expected
    assert reads == (math.ceil(k / CHUNK) if captured else k + (stop != "cap"))


@pytest.mark.parametrize("maxiter", range(0, 2 * CHUNK + 2))
def test_host_reads_per_chunk(maxiter):
    """At ``tol = 0`` the chunked CG reads its flag once a chunk (once for
    no iteration at all), the eager loop once an iteration."""
    rng = np.random.default_rng(0)
    A, B = _spd(rng, 10, 10), rng.standard_normal((10, 2))
    kw = dict(maxiter=maxiter, tol=0.0, atol=0.0)
    X, info, reads = _port_solve("cg", A, B, kw, True)
    X_e, info_e, reads_e = _port_solve("cg", A, B, kw, False)
    assert info["iterations"] == info_e["iterations"] == maxiter
    assert reads == max(1, math.ceil(maxiter / CHUNK)) and reads_e == maxiter
    assert torch.equal(X, X_e)
    assert info["residual_history"].shape == (maxiter + 1, 2)


# ---------------------------------------------------------------------- #
# the twins of tests/test_traced.py
# ---------------------------------------------------------------------- #
def test_cg_program_cache_reused_across_calls(jx):
    """One solver program across two same-width solves (the second a
    scaled right-hand side), equal to JAX's CG on its damped GGN;
    ``set_cg_hyperparameters`` drops it."""
    out, *_, (model, data), _ = jx
    params, G, _ = _port_mlp_ops(model, data)
    damped = G + 1e-2 * T.IdentityLinearOperator(G.in_spec)
    cg = T.CGInverseLinearOperator(damped, maxiter=200, tol=1e-8)
    v = torch.from_numpy(np.random.default_rng(3).standard_normal(G.shape[1]))
    x1 = cg @ v
    assert len(cg._program_cache[1]) == 1
    x2 = cg @ (2 * v)
    (loop,) = cg._program_cache[1].values()
    assert isinstance(loop, ChunkedLoop) and len(cg._program_cache[1]) == 1
    assert_close(x2, 2 * x1, rtol=1e-8, atol=1e-12, name="2 x1")
    dense = out["G"] + 1e-2 * np.eye(G.shape[1])
    assert_close(x1, np.linalg.solve(dense, v.numpy()), rtol=1e-6, atol=1e-9, name="solve")
    cg.set_cg_hyperparameters(maxiter=3)
    assert "_program_cache" not in cg.__dict__
    cg @ v
    assert cg.last_info["iterations"] == 3 and cg._program_cache[1][
        ("cg", 3, 1e-8, 1e-8, 1, torch.float64)] is not loop


def test_topk_eigenpairs_fused_matches_eager(jx):
    """``capture="auto"`` (a chunked loop cached on the operator) against
    ``capture=False`` from one start block, and both against the dense
    eigenvalues and JAX's LOBPCG."""
    out, *_, mat = jx
    A = T.MatrixLinearOperator(torch.from_numpy(mat @ mat.T + np.eye(40)))
    X0 = torch.from_numpy(np.random.default_rng(2).standard_normal((40, 3)))
    w_f, V_f = teigsh.topk_eigenpairs(A, k=3, maxiter=100, X0=X0)
    w_e, V_e = teigsh.topk_eigenpairs(A, k=3, maxiter=100, X0=X0, capture=False)
    assert isinstance(A._program_cache[1][("lobpcg", 3, 100, None, torch.float64)], ChunkedLoop)
    assert_close(w_f, w_e.numpy(), rtol=1e-10, atol=0, name="fused vs eager")
    w_true = np.linalg.eigvalsh(mat @ mat.T + np.eye(40))[::-1][:3]
    assert_close(w_f, w_true, rtol=1e-3, atol=0, name="dense")
    assert_close(w_f, out["topk"], rtol=1e-3, atol=0, name="JAX")
    with pytest.raises(ValueError, match="capturable"):
        teigsh.topk_eigenpairs(lambda V: A @ V, k=3, X0=X0, capture=True)


def test_cg_with_kfac_preconditioner_fused(jx):
    """CG on the damped GGN preconditioned by KFAC's damped inverse (type-2):
    one chunked loop over both (the Kronecker chain is capturable), equal
    to JAX's preconditioned CG on the two dense matrices; converged before
    the cap."""
    out, *_, (model, data), _ = jx
    params, G, _ = _port_mlp_ops(model, data)
    damped = G + 1e-2 * T.IdentityLinearOperator(G.in_spec)
    kfac = T.KFACLinearOperator(model, MSELoss("mean"), params, data, fisher_type="type-2",
                                check_deterministic=False)
    pre = kfac.inverse(damping=1e-2)
    assert pre.capturable and damped.capturable
    v = np.random.default_rng(4).standard_normal(G.shape[1])
    cg = T.CGInverseLinearOperator(damped, maxiter=200, tol=1e-8, preconditioner=pre)
    x = cg @ v
    assert isinstance(next(iter(cg._program_cache[1].values())), ChunkedLoop)
    dense, P = out["G"] + 1e-2 * np.eye(G.shape[1]), out["kfac_inverse"]
    assert cg.last_info["iterations"] < 200
    assert_close(dense @ np.asarray(x), v, rtol=0, atol=1e-6, name="residual")
    # iterate for iterate against JAX's PCG on the dense GGN and the port's
    # preconditioner (JAX's KFAC sums its factors in float32: 1e-7 apart,
    # which 10 preconditioned iterations amplify)
    assert rel_fro(pre @ torch.eye(G.shape[1], dtype=torch.float64), P) < 1e-6
    P = (pre @ torch.eye(G.shape[1], dtype=torch.float64)).numpy()
    cg.set_cg_hyperparameters(maxiter=10, tol=0.0, atol=0.0)
    x = cg @ v
    with jax.enable_x64(True):
        x_j, _ = jax.jit(lambda b: jcg.batched_cg(
            lambda V: dense @ V, b, maxiter=10, tol=0.0, atol=0.0,
            preconditioner=lambda V: P @ V))(jnp.asarray(v[:, None]))
    assert_close(x, np.asarray(x_j)[:, 0], **F64, name="PCG")


# ---------------------------------------------------------------------- #
# the operators marked capturable, inside a Neumann series and a CG solve
# ---------------------------------------------------------------------- #
KINDS = ["kron", "stacked_kron", "stacked_eigh", "embedding_kron", "embedding_eigh", "eigh",
         "blockdiag", "submatrix", "kfac", "kfac_inverse", "held", "jacobian"]


def _port_capturable(kind: str, structured, model, data):
    if kind in structured:
        return _ops("port", kind, structured[kind])
    params, G, J = _port_mlp_ops(model, data)
    if kind.startswith("kfac"):
        kfac = T.KFACLinearOperator(model, MSELoss("mean"), params, data, fisher_type="type-2",
                                    check_deterministic=False)
        return kfac.inverse(damping=1e-2) if kind == "kfac_inverse" else kfac
    if kind == "held":
        return G.linearized()
    return J.adjoint() @ J


@pytest.mark.parametrize("kind", KINDS)
def test_capturable_operator_in_neumann_and_cg_matches_jax(jx, kind):
    """The operator is ``capturable``; a 5-term Neumann series over it and
    6 CG iterations over it + 0.1 I each run as the program cached on the
    inverse operator, and equal the series and JAX's ``batched_cg`` over the
    JAX operator's dense matrix (float64)."""
    out, _, structured, (model, data), _ = jx
    A = _port_capturable(kind, structured, model, data)
    assert A.capturable
    if kind == "held":
        dense = out["G"]
    elif kind == "jacobian":
        dense = out["J"].T @ out["J"]
    else:
        dense = out[kind]
    if kind.startswith("kfac"):
        # JAX's KFAC sums its factors in float32 (1e-7 apart, which the
        # solves amplify): hold the operator to JAX's, the solves to JAX's
        # CG on the port operator's dense matrix
        port_dense = (A @ torch.eye(A.shape[1], dtype=torch.float64)).numpy()
        assert rel_fro(port_dense, dense) < 1e-6
        dense = port_dense
    n = dense.shape[0]
    V = np.random.default_rng(6).standard_normal((n, 2))
    scale = 0.5 / np.linalg.norm(dense, 2)
    neumann = T.NeumannInverseLinearOperator(A, num_terms=5, scale=scale)
    x = neumann @ torch.from_numpy(V)
    assert ("neumann", 2, torch.float64) in neumann._program_cache[1]
    term, expected = V, V.copy()
    for _ in range(5):
        term = term - scale * dense @ term
        expected = expected + term
    assert_close(x, scale * expected, **F64, name=f"Neumann over {kind}")
    cg = T.CGInverseLinearOperator(A + 0.1 * T.IdentityLinearOperator(A.in_spec), maxiter=6,
                                   tol=0.0, atol=0.0)
    x = cg @ torch.from_numpy(V)
    assert isinstance(next(iter(cg._program_cache[1].values())), ChunkedLoop)
    with jax.enable_x64(True):
        D = jnp.asarray(dense + 0.1 * np.eye(n))
        x_j, _ = jax.jit(lambda b: jcg.batched_cg(lambda M: D @ M, b, maxiter=6, tol=0.0,
                                                  atol=0.0))(jnp.asarray(V))
    assert_close(x, np.asarray(x_j), **F64, name=f"CG over {kind}")


# ---------------------------------------------------------------------- #
# the Jacobians read their held batches
# ---------------------------------------------------------------------- #
def test_jacobian_held_batches_match_streamed_and_jax_lsmr(jx):
    """``J`` and ``J^T`` products from the held batches equal the streamed
    ones and JAX's dense Jacobian; LSMR over the held ``J`` (a chunked loop)
    equals JAX's ``batched_lsmr`` on the dense Jacobian."""
    out, *_, (model, data), _ = jx
    params, _, J = _port_mlp_ops(model, data)
    J_s = T.JacobianLinearOperator(model, params, data, check_deterministic=False)
    J_s.fuse_batches = False
    assert J.capturable and J.adjoint().capturable and not J_s.capturable
    rng = np.random.default_rng(8)
    V = torch.from_numpy(rng.standard_normal((J.shape[1], 2)))
    W = torch.from_numpy(rng.standard_normal((J.shape[0], 2)))
    assert J._fused_state() is not None and J_s._fused_state() is None
    for A, A_s, M, dense in ((J, J_s, V, out["J"]), (J.T, J_s.T, W, out["Jt"])):
        assert_close(A @ M, (A_s @ M).numpy(), **F64, name="held vs streamed")
        assert_close(A @ M, dense @ M.numpy(), **F64, name="vs JAX")
    inv = T.LSMRInverseLinearOperator(J, maxiter=7, atol=0.0, btol=0.0)
    x = inv @ W
    assert isinstance(next(iter(inv._program_cache[1].values())), ChunkedLoop)
    Jd = out["J"]
    with jax.enable_x64(True):
        x_j, info_j = jax.jit(lambda b: jlsmr.batched_lsmr(
            lambda M: Jd @ M, lambda M: Jd.T @ M, b, maxiter=7, atol=0.0, btol=0.0))(
                jnp.asarray(W.numpy()))
    assert inv.lsmr_info["iterations"] == int(info_j["iterations"]) == 7
    assert inv.lsmr_info["host_reads"] == math.ceil(7 / CHUNK)
    assert_close(x, np.asarray(x_j), **F64, name="LSMR over J")


# ---------------------------------------------------------------------- #
# LOBPCG's route to its small eigenproblems
# ---------------------------------------------------------------------- #
# n: the small-eigh kernel's route, either type, and the cluster route's
# CTAs and padded size. The shared route (256 threads, A and V^T in shared
# memory) to n = 16 and again at 33-38, where it was faster on an H100 than
# the cluster route (blocked Jacobi, a cluster of ceil(n / 32) CTAs, A and
# V^T in a device-memory workspace, n padded to a multiple of 32); the
# cluster route for the others to 512 (16 CTAs, the card's largest cluster).
KERNEL_ROUTES = {
    1: ("shared", 1, 32), 16: ("shared", 1, 32), 17: ("cluster", 1, 32),
    32: ("cluster", 1, 32), 33: ("shared", 2, 64), 38: ("shared", 2, 64),
    39: ("cluster", 2, 64), 40: ("cluster", 2, 64), 44: ("cluster", 2, 64),
    45: ("cluster", 2, 64), 120: ("cluster", 4, 128), 121: ("cluster", 4, 128),
    256: ("cluster", 8, 256), 257: ("cluster", 9, 288), 300: ("cluster", 10, 320),
    511: ("cluster", 16, 512), 512: ("cluster", 16, 512), 513: (None, 17, 544),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", sorted(KERNEL_ROUTES))
def test_small_eigh_kernel_route(n, dtype):
    """The kernel's route by size, the cluster route's CTAs and padded size
    (:func:`cluster_shape`, the workspace the wrapper allocates), and the
    size limit that ``small_eigh`` enforces on the card (its CPU path takes
    any size and counts no launch)."""
    from curvlinops_tpu_torch.solvers import small_eigh as se

    route, ctas, padded = KERNEL_ROUTES[n]
    assert se.kernel_route(n) == route
    assert se.cluster_shape(n) == (ctas, padded)
    assert se.MAX_N == 512 and se.BLOCK == 16
    assert se.SHARED_SIZES == (range(1, 17), range(33, 39))
    A = torch.eye(n, dtype=dtype)
    launches, sizes = se.small_eigh.launches, dict(se.small_eigh.size_launches)
    w, V = se.small_eigh(A)  # the CPU's plain version, descending
    assert w.shape == (n,) and V.shape == (n, n) and bool((w == 1).all())
    assert se.small_eigh.launches == launches and se.small_eigh.size_launches == sizes


def _spectrum_operator(dim: int, k: int, dtype, seed: int):
    """A dense symmetric ``[dim, dim]`` operator with known eigenvalues: the
    top ``k`` evenly in [1, 2], the rest in [0, 0.5] (a gap LOBPCG closes in
    a few iterations), eigenvectors from a seeded QR."""
    rng = np.random.default_rng(seed)
    Q = torch.linalg.qr(torch.from_numpy(rng.standard_normal((dim, dim))))[0].numpy()
    lam = np.concatenate([np.linspace(2.0, 1.0, k), rng.uniform(0.0, 0.5, dim - k)])
    M = (Q * lam) @ Q.T
    return M, np.sort(lam)[::-1], rng.standard_normal((dim, k))


# k with 3k at and around the kernel's limits: 96 (the old limit) and 99,
# 159 and 162 (around float32's shared route), 510 and 513 (MAX_N = 512)
ROUTE_KS = [32, 33, 53, 54, 170, 171]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("capture", ["auto", False], ids=["captured", "eager"])
@pytest.mark.parametrize("k", ROUTE_KS)
def test_topk_eigenpairs_small_eigh_route(monkeypatch, k, capture, dtype):
    """``topk_eigenpairs``' one route choice: while ``3k <= 512`` every
    small problem (start, eager or chunked loop) goes to ``small_eigh``
    (the kernel on the card) and ``capture="auto"`` caches a chunked loop;
    past it every one goes to ``small_eigh_plain`` (``torch.linalg.eigh``),
    ``"auto"`` runs eagerly (no program cached) and ``capture=True`` raises
    naming the limit and the way out. Two iterations on a dense operator of
    dimension ``5k + 4``."""
    calls = {"kernel": [], "plain": []}
    for name, key in (("small_eigh", "kernel"), ("small_eigh_plain", "plain")):
        fn = getattr(teigsh, name)
        monkeypatch.setattr(teigsh, name, lambda M, *a, _fn=fn, _key=key, **kw: (
            calls[_key].append(M.shape[-1]), _fn(M, *a, **kw))[1])
    dim = 5 * k + 4
    M, _, X0 = _spectrum_operator(dim, k, np.float64, seed=k)
    A = T.MatrixLinearOperator(torch.from_numpy(M).to(dtype))
    fits = 3 * k <= 512
    if not fits:
        with pytest.raises(ValueError, match=r"(?s)\[513, 513\].*512.*capture=False"):
            teigsh.topk_eigenpairs(A, k=k, maxiter=2, X0=torch.from_numpy(X0).to(dtype),
                                   capture=True)
        assert not calls["kernel"] and not calls["plain"]
    w, V = teigsh.topk_eigenpairs(A, k=k, maxiter=2, X0=torch.from_numpy(X0).to(dtype),
                                  capture=capture)
    assert w.shape == (k,) and V.shape == (dim, k) and w.dtype == dtype
    assert bool(torch.isfinite(w).all()) and bool((w[:-1] >= w[1:]).all())
    used, unused = ("kernel", "plain") if fits else ("plain", "kernel")
    assert not calls[unused] and set(calls[used]) == {k, 3 * k}
    cached = "_program_cache" in A.__dict__ and any(
        isinstance(p, ChunkedLoop) for p in A._program_cache[1].values())
    assert cached == (fits and capture == "auto")


def test_topk_eigenpairs_k33_matches_jax():
    """k = 33 (a ``[99, 99]`` Rayleigh-Ritz problem, past the kernel's old
    limit of 96) on a 200 x 200 dense operator of known spectrum, float64:
    captured (``"auto"``) and eager against the exact top 33 and JAX's
    jitted ``topk_eigenpairs`` (to 1e-10), and each other (1e-10)."""
    k, dim = 33, 200
    M, lam, X0 = _spectrum_operator(dim, k, np.float64, seed=5)
    with jax.enable_x64(True):
        w_j = np.asarray(cl.topk_eigenpairs(cl.MatrixLinearOperator(jnp.asarray(M)), k=k,
                                            maxiter=100, key=jax.random.key(3))[0])
    A = T.MatrixLinearOperator(torch.from_numpy(M))
    w_f, V_f = teigsh.topk_eigenpairs(A, k=k, maxiter=100, X0=torch.from_numpy(X0))
    w_e, _ = teigsh.topk_eigenpairs(A, k=k, maxiter=100, X0=torch.from_numpy(X0), capture=False)
    assert isinstance(A._program_cache[1][("lobpcg", k, 100, None, torch.float64)], ChunkedLoop)
    assert_close(w_f, w_e.numpy(), **F64, name="captured vs eager")
    assert_close(w_f, lam[:k], **F64, name="exact")
    assert_close(w_f, w_j, **F64, name="JAX")
    assert_close(V_f.T @ V_f, np.eye(k), rtol=0, atol=1e-10, name="orthonormal")
