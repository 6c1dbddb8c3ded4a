"""The port's captured programs against the JAX package's fused programs, on
the CPU.

Twins of ``tests/test_traced.py``: the fused multi-batch matmat and
gradient (the mode record ``"scan"``, ``"unroll"`` or ``None`` against
JAX's, the results against JAX's fused ``G @ v``, each JAX oracle one
``jax.jit`` call, and against the port's streamed loop), the fuse policy
past the unroll limit, the program cache's invalidation on a chain
``__setitem__``, the fused Neumann series and fast Lanczos's program on the
operator. And the port's own: one batch fused as ``"single"`` (the JAX
package streams it), the Hessian and empirical Fisher fused, the MC
Fisher's taped draws (fused equals streamed and itself), the setters and
``load_state_dict`` dropping programs; and the twins of
``tests/test_slq.py``'s two program-cache tests. On the CPU a
:class:`~curvlinops_tpu_torch.utils.graphs.CapturedProgram` runs its
function eagerly; the card's captures are in ``tests/test_torch_cuda.py``.

The problem is ``tests/test_traced.py::_mlp_problem``'s MLP (6 -> 10 -> 3,
ReLU, cross-entropy; 4 batches of 8, or of 8 to 11 rows when ragged), its
inputs drawn with numpy and passed to both packages.
"""

from __future__ import annotations

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import curvlinops_tpu as jcl
import curvlinops_tpu_torch as T
from curvlinops_tpu.losses import BCEWithLogitsLoss as JBCE
from curvlinops_tpu.losses import CrossEntropyLoss as JCE
from curvlinops_tpu.losses import MSELoss as JMSE
from curvlinops_tpu_torch.ops.base import traced_epoch
from curvlinops_tpu_torch.solvers import lanczos as tlanczos
from curvlinops_tpu_torch.utils.graphs import CapturedProgram, DrawTape
from tests.test_torch_helpers import capped_torch_threads

_threads = capped_torch_threads()

TOL = dict(rtol=1e-5, atol=1e-6)  # tests/test_traced.py's


def _jax_model(params, X):
    return jax.nn.relu(X @ params["w1"] + params["b1"]) @ params["w2"]


def _port_model(params, X):
    return torch.relu(X @ params["w1"] + params["b1"]) @ params["w2"]


def _targets(loss: str, rng, b: int) -> np.ndarray:
    if loss == "ce":
        return rng.integers(0, 3, b)
    if loss == "bce":
        return rng.integers(0, 2, (b, 3)).astype(np.float32)
    return rng.standard_normal((b, 3)).astype(np.float32)


def _problem(n_batches: int = 4, ragged: bool = False, loss: str = "ce", seed: int = 0) -> dict:
    """The MLP's parameters, batches and a vector, as numpy."""
    rng = np.random.default_rng(seed)
    params = {
        "w1": (0.4 * rng.standard_normal((6, 10))).astype(np.float32),
        "b1": np.zeros(10, np.float32),
        "w2": (0.4 * rng.standard_normal((10, 3))).astype(np.float32),
    }
    data = []
    for i in range(n_batches):
        b = 8 + (i if ragged else 0)
        data.append((rng.standard_normal((b, 6)).astype(np.float32), _targets(loss, rng, b)))
    v = {k: rng.standard_normal(p.shape).astype(np.float32) for k, p in params.items()}
    return dict(params=params, data=data, v=v, loss=loss)


_JLOSS = {"ce": JCE, "mse": JMSE, "bce": JBCE}
_TLOSS = {"ce": T.CrossEntropyLoss, "mse": T.MSELoss, "bce": T.BCEWithLogitsLoss}


def _port(cls, prob: dict, **kw):
    params = {k: torch.from_numpy(p) for k, p in prob["params"].items()}
    data = [(torch.from_numpy(X), torch.from_numpy(y)) for X, y in prob["data"]]
    return cls(_port_model, _TLOSS[prob["loss"]]("mean"), params, data,
               check_deterministic=False, **kw)


def _jax(cls, prob: dict):
    params = jax.tree.map(jnp.asarray, prob["params"])
    data = [(jnp.asarray(X), jnp.asarray(y)) for X, y in prob["data"]]
    return cls(_jax_model, _JLOSS[prob["loss"]]("mean"), params, data, check_deterministic=False)


def _port_v(prob: dict) -> dict:
    return {k: torch.from_numpy(a) for k, a in prob["v"].items()}


def _mode(op):
    state = op._batch_fn_cache.get("fused_state")
    return None if state is None else state[0]


def _close(actual: dict, expected: dict, tol=TOL) -> None:
    for k in expected:
        np.testing.assert_allclose(np.asarray(actual[k]), np.asarray(expected[k]), **tol,
                                   err_msg=k)


def _jax_matvec_and_mode(G, prob: dict):
    """JAX's fused ``G @ v`` as one ``jax.jit`` program, and its mode."""
    out = jax.jit(lambda u: G @ u)(jax.tree.map(jnp.asarray, prob["v"]))
    return jax.tree.map(np.asarray, out), _mode(G)


# ---------------------------------------------------------------------- #
# twins of tests/test_traced.py
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
def test_fused_batch_accumulation_matches_streaming(ragged):
    """The fused accumulation equals JAX's fused ``G @ v`` and the port's
    streamed loop; its mode record is JAX's."""
    prob = _problem(ragged=ragged)
    G1, G2 = _port(T.GGNLinearOperator, prob), _port(T.GGNLinearOperator, prob)
    G2.fuse_batches = False
    v = _port_v(prob)
    fused = G1 @ v
    assert _mode(G1) == ("unroll" if ragged else "scan")
    streamed = G2 @ v
    assert G2._batch_fn_cache.get("fused_state") is None  # opted out
    jax_out, jax_mode = _jax_matvec_and_mode(_jax(jcl.GGNLinearOperator, prob), prob)
    assert _mode(G1) == jax_mode
    _close(fused, streamed)
    _close(fused, jax_out)


@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
def test_fuse_policy_past_unroll_limit(ragged, monkeypatch):
    """Past the unroll limit uniform batches still fuse as ``"scan"`` while
    ragged ones stream, in both packages."""
    prob = _problem(ragged=ragged)
    G = _port(T.GGNLinearOperator, prob)
    monkeypatch.setattr(type(G), "_FUSE_UNROLL_LIMIT", 2)
    monkeypatch.setattr(jcl.GGNLinearOperator, "_FUSE_UNROLL_LIMIT", 2)
    out = G @ _port_v(prob)
    assert _mode(G) == (None if ragged else "scan")
    _, jax_mode = _jax_matvec_and_mode(_jax(jcl.GGNLinearOperator, prob), prob)
    assert _mode(G) == jax_mode
    G2 = _port(T.GGNLinearOperator, prob)
    G2.fuse_batches = False
    _close(out, G2 @ _port_v(prob))


class _FreshBatches:
    """A problem's batches, copied afresh on every pass: counts the batches
    read and keeps a weak reference to each."""

    def __init__(self, prob: dict):
        self.prob, self.read, self.refs = prob, 0, []

    def __iter__(self):
        for X, y in self.prob["data"]:
            X, y = torch.tensor(X), torch.tensor(y)
            self.read += 1
            self.refs.append(weakref.ref(X))
            yield X, y


@pytest.mark.parametrize("past", ["ragged", "uniform_over_bytes"])
def test_fused_state_stops_reading_past_both_limits(past, monkeypatch):
    """70 batches, ragged or uniform past the byte limit: the fused state
    stops reading at the 65th batch (past both limits), holds none of them
    and records ``None``; the product streams and equals ``fuse_batches =
    False``."""
    prob = _problem(n_batches=70, ragged=past == "ragged", seed=6)
    if past == "uniform_over_bytes":
        monkeypatch.setattr(T.GGNLinearOperator, "_FUSE_STACK_BYTE_LIMIT", 1000)
    data = _FreshBatches(prob)
    G = T.GGNLinearOperator(_port_model, T.CrossEntropyLoss("mean"),
                            {k: torch.from_numpy(p) for k, p in prob["params"].items()}, data,
                            check_deterministic=False)
    data.read, data.refs = 0, []
    assert G._fused_state() is None and "fused_state" in G._batch_fn_cache
    assert data.read == G._FUSE_UNROLL_LIMIT + 1
    gc.collect()
    assert not any(ref() is not None for ref in data.refs)
    G2 = _port(T.GGNLinearOperator, prob)
    G2.fuse_batches = False
    v = _port_v(prob)
    _close(G @ v, G2 @ v)
    assert data.read == G._FUSE_UNROLL_LIMIT + 1 + 70  # the product streamed all 70


@pytest.mark.parametrize("streams", ["fuse_batches_false", "progressbar", "past_limits"])
def test_series_and_recurrence_run_eagerly_over_streamed_operators(streams, monkeypatch):
    """A Neumann series over a streamed MC GGN plus the identity, and fast
    Lanczos on the streamed MC GGN, keep no program (a streamed operator is
    not ``capturable``) and equal the captured programs over the fused
    operator: the same draws in every product."""
    prob = _problem(ragged=True, seed=7)
    fused, streamed = (_port(T.GGNLinearOperator, prob, mc_samples=1, seed=3) for _ in range(2))
    if streams == "fuse_batches_false":
        streamed.fuse_batches = False
    elif streams == "progressbar":
        streamed._progressbar = True
    else:
        monkeypatch.setattr(streamed, "_FUSE_UNROLL_LIMIT", 2)
    assert fused.capturable and not streamed.capturable
    v = _port_v(prob)
    inv = {name: T.NeumannInverseLinearOperator(
        A + T.IdentityLinearOperator(A.in_spec), num_terms=12, scale=0.5)
        for name, A in (("fused", fused), ("streamed", streamed))}
    _close(inv["streamed"] @ v, inv["fused"] @ v)
    assert "_program_cache" in inv["fused"].__dict__
    assert "_program_cache" not in inv["streamed"].__dict__
    v0 = torch.from_numpy(np.random.default_rng(8).standard_normal(fused.shape[1])
                          .astype(np.float32))
    evals = {name: tlanczos.fast_lanczos(A, 6, v0=v0)[0]
             for name, A in (("fused", fused), ("streamed", streamed))}
    torch.testing.assert_close(evals["streamed"], evals["fused"], **TOL)
    assert any(k[0] == "fast_lanczos" for k in fused._program_cache[1])
    assert "_program_cache" not in streamed.__dict__


@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
def test_fused_gradient_and_loss_matches_streaming(ragged):
    """The fused gradient and loss equal the streamed ones and JAX's fused
    ``gradient_and_loss``."""
    prob = _problem(ragged=ragged)
    G1, G2 = _port(T.GGNLinearOperator, prob), _port(T.GGNLinearOperator, prob)
    G2.fuse_batches = False
    (g1, l1), (g2, l2) = G1.gradient_and_loss(), G2.gradient_and_loss()
    assert _mode(G1) == ("unroll" if ragged else "scan")
    GJ = _jax(jcl.GGNLinearOperator, prob)
    gj, lj = jax.jit(GJ.gradient_and_loss)()
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    np.testing.assert_allclose(float(l1), float(lj), rtol=1e-6)
    tol = dict(rtol=1e-5, atol=1e-7)
    _close(g1, g2, tol)
    _close(g1, jax.tree.map(np.asarray, gj), tol)


@pytest.mark.parametrize("chain", [False, True], ids=["traced", "neumann"])
def test_traced_invalidation_on_mutation(chain):
    """A chain ``__setitem__`` refreshes every cached program, including a
    composite's that runs the mutated chain (the values of JAX's twin)."""
    A = T.MatrixLinearOperator(2.0 * torch.eye(4))
    B = T.MatrixLinearOperator(3.0 * torch.eye(4))
    chain_op = A @ B
    summed = chain_op + T.IdentityLinearOperator(chain_op.in_spec)
    v = torch.ones(4, 1)
    if not chain:
        fn, consts = summed.traced(1)
        torch.testing.assert_close(fn(v, *consts), 7.0 * torch.ones(4, 1))
        chain_op[1] = T.MatrixLinearOperator(5.0 * torch.eye(4))  # bumps the epoch
        fn2, consts2 = summed.traced(1)
        torch.testing.assert_close(fn2(v, *consts2), 11.0 * torch.ones(4, 1))
        return
    inv = T.NeumannInverseLinearOperator(summed, num_terms=200, scale=0.1)
    torch.testing.assert_close(inv @ v, v / 7.0)
    epoch = traced_epoch()
    assert inv._program_cache[0] == epoch and len(inv._program_cache[1]) == 1
    chain_op[1] = T.MatrixLinearOperator(5.0 * torch.eye(4))
    assert traced_epoch() == epoch + 1 and "_program_cache" not in inv.__dict__
    torch.testing.assert_close(inv @ v, v / 11.0)


def test_fused_neumann_matches_dense_inverse_with_preconditioner():
    """400 preconditioned terms: the port's series against the dense solve
    and JAX's ``fori_loop`` program on the same matrix."""
    rng = np.random.default_rng(0)
    M = (rng.standard_normal((8, 8)) / 8).astype(np.float32)
    S = (M @ M.T + np.eye(8)).astype(np.float32)
    P = np.diag(1.0 / np.diag(S)).astype(np.float32)
    v = rng.standard_normal(8).astype(np.float32)
    x = T.NeumannInverseLinearOperator(
        T.MatrixLinearOperator(torch.from_numpy(S)), num_terms=400, scale=0.4,
        preconditioner=T.MatrixLinearOperator(torch.from_numpy(P)),
    ) @ torch.from_numpy(v)
    jop = jcl.NeumannInverseLinearOperator(
        jcl.MatrixLinearOperator(jnp.asarray(S)), num_terms=400, scale=0.4,
        preconditioner=jcl.MatrixLinearOperator(jnp.asarray(P)),
    )
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(S, v), atol=1e-3)
    np.testing.assert_allclose(x.numpy(), jop @ v, rtol=1e-5, atol=1e-6)


def test_fused_neumann_divergence_raises_with_term_index():
    """A diverging series raises after the program, naming the first term
    with a NaN, the same term as JAX's."""
    messages = []
    for op in (
        T.NeumannInverseLinearOperator(T.MatrixLinearOperator(10.0 * torch.eye(4)),
                                       num_terms=300, scale=1.0),
        jcl.NeumannInverseLinearOperator(jcl.MatrixLinearOperator(10.0 * jnp.eye(4)),
                                         num_terms=300, scale=1.0),
    ):
        with pytest.raises(ValueError, match="diverged") as err:
            op @ np.ones(4, dtype=np.float32)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_fast_lanczos_program_cached_on_operator():
    """``fast_lanczos`` keeps its program on the operator under
    ``("fast_lanczos", ncv, ...)``; the program equals the eager recurrence
    and its top Ritz value approximates the top eigenvalue."""
    mat = np.random.default_rng(3).standard_normal((30, 30)).astype(np.float32)
    S = torch.from_numpy(mat @ mat.T)
    A = T.MatrixLinearOperator(S)
    evals, _ = tlanczos.fast_lanczos(A, ncv=10, generator=torch.Generator().manual_seed(0))
    keys = list(A._program_cache[1])
    assert any(k[:2] == ("fast_lanczos", 10) for k in keys)
    top = float(torch.linalg.eigvalsh(S.double())[-1])
    assert abs(float(evals[-1]) - top) / top < 0.05
    v0 = tlanczos.start_vector(A, torch.Generator().manual_seed(0), (30, 1))
    eager = tlanczos.fast_lanczos_recurrence(tlanczos.flat_matmat(A), 10)(v0)
    program = A._program_cache[1][next(k for k in keys if k[0] == "fast_lanczos")]
    for a, b in zip(program(v0), eager):
        torch.testing.assert_close(a, b)
    lo, hi = tlanczos.lanczos_extreme_eigenvalues(A, num_iters=30)
    assert any(k[:3] == ("lanczos_extreme", 30, 1) for k in A._program_cache[1])
    np.testing.assert_allclose(float(hi), top, rtol=1e-4)


# ---------------------------------------------------------------------- #
# the port's own
# ---------------------------------------------------------------------- #
_OPERATORS = {
    "ggn": (T.GGNLinearOperator, jcl.GGNLinearOperator),
    "hessian": (T.HessianLinearOperator, jcl.HessianLinearOperator),
    "ef": (T.EFLinearOperator, jcl.EFLinearOperator),
}


@pytest.mark.parametrize("op", sorted(_OPERATORS))
def test_single_batch_is_fused(op):
    """One batch is fused as ``"single"`` (JAX streams it: ``None``); the
    product equals the streamed one and JAX's."""
    prob = _problem(n_batches=1)
    cls, jcls = _OPERATORS[op]
    A1, A2 = _port(cls, prob), _port(cls, prob)
    A2.fuse_batches = False
    v = _port_v(prob)
    fused = A1 @ v
    assert _mode(A1) == "single"
    jax_out, jax_mode = _jax_matvec_and_mode(_jax(jcls, prob), prob)
    assert jax_mode is None
    _close(fused, A2 @ v)
    _close(fused, jax_out)


@pytest.mark.parametrize("op", ["hessian", "ef"])
@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
def test_fused_matmat_matches_streaming(op, ragged):
    """The Hessian and the empirical Fisher: fused two-column matmats equal
    the streamed ones."""
    prob = _problem(ragged=ragged, seed=1)
    A1, A2 = _port(_OPERATORS[op][0], prob), _port(_OPERATORS[op][0], prob)
    A2.fuse_batches = False
    V = torch.from_numpy(np.random.default_rng(2).standard_normal((A1.shape[1], 2)).astype(np.float32))
    fused = A1 @ V
    assert _mode(A1) == ("unroll" if ragged else "scan")
    np.testing.assert_allclose(fused.numpy(), (A2 @ V).numpy(), **TOL)


@pytest.mark.parametrize("loss", ["ce", "mse", "bce"])
def test_mc_fisher_fused_replays_streamed_draws(loss):
    """The MC Fisher's fused matvec makes the streamed loop's draws (one
    generator per batch): fused equals streamed, and two fused calls (the
    draws replayed from their tapes) equal each other."""
    prob = _problem(ragged=True, loss=loss, seed=4)
    G1, G2 = (_port(T.GGNLinearOperator, prob, mc_samples=2, seed=11) for _ in range(2))
    G2.fuse_batches = False
    v = _port_v(prob)
    first, streamed = G1 @ v, G2 @ v
    second = G1 @ v
    assert _mode(G1) == "unroll"
    _close(first, streamed)
    for k in first:
        torch.testing.assert_close(first[k], second[k], rtol=0, atol=0)


def test_program_outputs_are_not_aliased_and_taped_draws_are_read_only():
    """A result kept across a later call is unchanged; a tape's replayed
    draw is its first draw."""
    prob = _problem(loss="ce", seed=5)
    G = _port(T.GGNLinearOperator, prob, mc_samples=1)
    v = _port_v(prob)
    first = G @ v
    kept = {k: t.clone() for k, t in first.items()}
    G @ {k: 2 * t for k, t in v.items()}
    for k in kept:
        torch.testing.assert_close(first[k], kept[k], rtol=0, atol=0)
    tape = G._batch_fn_cache["fused_state"][3][0]
    # a cross-entropy tape holds the sampled classes [N, D, M], not the race
    assert [(t.dtype, tuple(t.shape)) for t in tape._draws] == [(torch.int64, (8, 1, 1))]
    assert tape.nbytes == 8 * 8
    recorded = [t.clone() for t in tape._draws]
    G @ v
    assert recorded and all(torch.equal(a, b) for a, b in zip(recorded, tape._draws))
    fresh = DrawTape(torch.Generator().manual_seed(0))
    a = fresh.draw(lambda g: torch.randn(3, generator=g), (3,))
    fresh.rewind()
    assert fresh.draw(lambda g: torch.randn(3, generator=g), (3,)) is a
    fresh.rewind()
    with pytest.raises(RuntimeError, match="shape"):
        fresh.draw(lambda g: torch.randn(4, generator=g), (4,))


def test_setters_and_load_state_dict_drop_programs():
    """The inverses' setters and KFAC's ``load_state_dict`` bump the epoch;
    a Neumann series rebuilt with a new scale gives the new result;
    ``CapturedProgram`` on CPU tensors runs its function."""
    S = torch.diag(torch.tensor([1.0, 2.0, 4.0]))
    inv = T.NeumannInverseLinearOperator(T.MatrixLinearOperator(S), num_terms=300, scale=0.2)
    v = torch.ones(3)
    torch.testing.assert_close(inv @ v, 1.0 / torch.diag(S))
    inv.set_neumann_hyperparameters(num_terms=1)
    assert "_program_cache" not in inv.__dict__
    torch.testing.assert_close(inv @ v, 0.2 * (2 - 0.2 * torch.diag(S)))
    cg = T.CGInverseLinearOperator(T.MatrixLinearOperator(S))
    epoch = traced_epoch()
    cg.set_cg_hyperparameters(maxiter=5)
    assert traced_epoch() == epoch + 1
    prob = _problem(n_batches=2)
    model = torch.nn.Sequential(torch.nn.Linear(6, 10), torch.nn.ReLU(), torch.nn.Linear(10, 3))
    data = [(torch.from_numpy(X), torch.from_numpy(y)) for X, y in prob["data"]]
    kfac = T.KFACLinearOperator(model, T.CrossEntropyLoss("mean"), dict(model.named_parameters()),
                                data, check_deterministic=False)
    epoch = traced_epoch()
    kfac.load_state_dict(kfac.state_dict())
    assert traced_epoch() == epoch + 1
    program = CapturedProgram(lambda x: {"y": 2 * x}, torch.device("cpu"))
    torch.testing.assert_close(program(v)["y"], 2 * v)
    assert program.capture_seconds is None


def _spd_operator(dim: int, seed: int) -> T.MatrixLinearOperator:
    """``tests/test_slq.py::_spd_operator``: eigenvalues 0.5 to 4, float32."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(dim, dim)))
    return T.MatrixLinearOperator(torch.from_numpy(((Q * np.linspace(0.5, 4.0, dim)) @ Q.T)
                                                   .astype(np.float32)))


def test_slq_program_cached():
    """Twin of ``tests/test_slq.py::test_slq_program_cached``: the quadrature
    program does not depend on ``f`` or the probes, so repeated estimates
    with other maps and generators reuse one program."""
    A = _spd_operator(32, 2)
    T.slq_logdet(A, ncv=16, num_repeats=4)
    n_programs = len(A._program_cache[1])
    T.slq_logdet(A, ncv=16, num_repeats=4, generator=torch.Generator().manual_seed(9))
    T.slq_function_trace(A, torch.exp, ncv=16, num_repeats=4)
    T.slq_function_trace(A, lambda t: 1.0 / t, ncv=16, num_repeats=4)
    assert len(A._program_cache[1]) == n_programs == 1


def test_program_cache_evicted_on_epoch_bump():
    """Twin of ``tests/test_slq.py::test_program_cache_evicted_on_epoch_bump``:
    an epoch bump evicts the stale program instead of keeping it."""
    A = _spd_operator(32, 4)
    T.slq_logdet(A, ncv=8, num_repeats=2)
    assert len(A._program_cache[1]) == 1
    A.invalidate_traced()
    T.slq_logdet(A, ncv=8, num_repeats=2)
    assert len(A._program_cache[1]) == 1
