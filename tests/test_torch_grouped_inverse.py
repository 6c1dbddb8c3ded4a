"""The grouped damped Kronecker inverse against the JAX package, on the CPU.

Twins of ``tests/test_grouped_inverse.py``: ``kfac/chain.py::
grouped_kron_inverse`` inverts every plain or heuristic-damped factor of
KFAC's blocks in batched Cholesky factorizations with one two-flag host
read (it builds the KFAC preconditioner that the captured CG uses). It
must equal the JAX package's grouped inverse and the port's per-block path
(float64, from the same numpy factors), return ``None`` on a NaN factor,
degenerate to the plain ``sqrt(damping)`` split where a factor's trace is
zero, refuse a negative mean eigenvalue and three factors under heuristic
damping, and the operator's per-block fallback must reproduce it. The JAX
oracles are computed once for the module.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curvlinops_tpu.kfac.chain import grouped_kron_inverse as j_grouped
from curvlinops_tpu_torch import KFACLinearOperator
from curvlinops_tpu_torch.kfac import operator as op_mod
from curvlinops_tpu_torch.kfac.chain import grouped_kron_inverse, stacked_kron_inverse
from curvlinops_tpu_torch.losses import MSELoss
from curvlinops_tpu_torch.ops.kronecker import KroneckerProductLinearOperator, damped_cholesky_inverse
from tests.test_torch_helpers import assert_close, capped_torch_threads, mlp_pair

_threads = capped_torch_threads()

F64 = dict(rtol=1e-10, atol=1e-12)
DAMPING = 1e-2
ZERO_SLOTS = [0, 1, "both"]


def _spd(rng, n, L=None):
    shape = (n, n) if L is None else (L, n, n)
    A = rng.standard_normal(shape)
    return np.einsum("...ij,...kj->...ik", A, A) / n + 0.1 * np.eye(n)


def _blocks() -> dict:
    rng = np.random.default_rng(0)
    S = [_spd(rng, 3), _spd(rng, 4), _spd(rng, 5), _spd(rng, 3, L=2), _spd(rng, 2, L=2)]
    return {
        0: ("kron", [S[0], S[1]]),
        1: ("kron", [S[2]]),
        2: ("skron", [S[3], S[4]]),
        3: ("kron", [S[1], S[1].copy()]),  # shape-batches with block 0's second factor
    }


def _zero_case(zero_slot) -> dict:
    rng = np.random.default_rng(7)
    S1 = np.zeros((3, 3)) if zero_slot in (0, "both") else _spd(rng, 3)
    S2 = np.zeros((4, 4)) if zero_slot in (1, "both") else _spd(rng, 4)
    return {0: ("kron", [S1, S2])}


def _torch_blocks(blocks: dict) -> dict:
    return {gi: (kind, [torch.from_numpy(S) for S in fs]) for gi, (kind, fs) in blocks.items()}


@pytest.fixture(scope="module")
def jax_grouped():
    """The JAX package's grouped inverses, float64: plain and heuristic on
    the blocks, heuristic on each zero-trace case, and the NaN case."""
    with jax.enable_x64(True):
        def run(blocks, heuristic):
            jb = {gi: (kind, [jnp.asarray(S) for S in fs]) for gi, (kind, fs) in blocks.items()}
            out = j_grouped(jb, DAMPING, heuristic, 1e-8)
            return None if out is None else {gi: [np.asarray(x) for x in xs] for gi, xs in out.items()}

        res = {h: run(_blocks(), h) for h in (False, True)}
        for slot in ZERO_SLOTS:
            res[("zero", slot)] = run(_zero_case(slot), True)
        bad = _blocks()
        bad[4] = ("kron", [np.full((4, 4), np.nan)])
        res["nan"] = run(bad, False)
    return res


@pytest.mark.parametrize("heuristic", [False, True], ids=["plain", "heuristic"])
def test_grouped_matches_jax_and_per_block(jax_grouped, heuristic):
    """Every inverted factor equals JAX's grouped one and the port's
    per-block path (``stacked_kron_inverse``; ``damped_cholesky_inverse``
    with the Martens-Grosse split)."""
    blocks = _torch_blocks(_blocks())
    out = grouped_kron_inverse(blocks, DAMPING, heuristic, 1e-8)
    assert out is not None
    for gi, (kind, factors) in blocks.items():
        if kind == "skron":
            expected = stacked_kron_inverse(factors, DAMPING, heuristic, 1e-8, True)
        else:
            if heuristic and len(factors) == 2:
                m1, m2 = (float(torch.diagonal(S).mean()) for S in factors)
                pi = math.sqrt(m2 / m1)
                ds = (max(math.sqrt(DAMPING) / pi, 1e-8), max(math.sqrt(DAMPING) * pi, 1e-8))
            else:
                ds = (max(DAMPING, 1e-8),) * len(factors)
            expected = [damped_cholesky_inverse(S, d) for S, d in zip(factors, ds)]
        for fi, (got, exp, jx) in enumerate(zip(out[gi], expected, jax_grouped[heuristic][gi])):
            assert_close(got, exp.numpy(), **F64, name=f"block {gi} factor {fi}, per block")
            assert_close(got, jx, **F64, name=f"block {gi} factor {fi}, JAX")


def test_grouped_nan_returns_none(jax_grouped):
    blocks = _torch_blocks(_blocks())
    blocks[4] = ("kron", [torch.full((4, 4), float("nan"), dtype=torch.float64)])
    assert grouped_kron_inverse(blocks, DAMPING, False, 1e-8) is None
    assert jax_grouped["nan"] is None


@pytest.mark.parametrize("zero_slot", ZERO_SLOTS)
def test_heuristic_zero_trace_factor_degenerates_to_plain_split(jax_grouped, zero_slot):
    """A zero factor trace carries no scale: ``pi = 1``, the plain
    ``sqrt(damping)`` split, in the grouped and the per-block path, as in
    the JAX package's grouped inverse."""
    blocks = _torch_blocks(_zero_case(zero_slot))
    out = grouped_kron_inverse(blocks, DAMPING, True, 1e-8)
    S1, S2 = blocks[0][1]
    per_block = KroneckerProductLinearOperator(S1, S2).inverse(
        damping=DAMPING, use_heuristic_damping=True)
    for fi, (S, got, got_block, jx) in enumerate(
            zip([S1, S2], out[0], per_block.factors, jax_grouped[("zero", zero_slot)][0])):
        expected = damped_cholesky_inverse(S, max(math.sqrt(DAMPING), 1e-8)).numpy()
        assert np.isfinite(got.numpy()).all()
        assert_close(got, expected, **F64, name=f"grouped factor {fi}")
        assert_close(got_block, expected, **F64, name=f"per-block factor {fi}")
        assert_close(got, jx, **F64, name=f"JAX factor {fi}")


def test_grouped_heuristic_refusals():
    """A negative mean eigenvalue and three factors under heuristic damping."""
    with pytest.raises(RuntimeError, match="Negative mean eigenvalue"):
        grouped_kron_inverse({0: ("kron", [-torch.eye(3), torch.eye(4)])}, DAMPING, True, 1e-8)
    S = torch.from_numpy(_spd(np.random.default_rng(0), 2))
    with pytest.raises(ValueError, match="at most two factors"):
        grouped_kron_inverse({0: ("kron", [S, S, S])}, DAMPING, True, 1e-8)


@pytest.mark.parametrize("heuristic", [False, True], ids=["plain", "heuristic"])
def test_operator_fallback_matches_grouped(heuristic, monkeypatch):
    """Forcing the NaN fallback (the per-block float64-retry path of
    ``KFACLinearOperator.inverse``) reproduces the grouped inverse."""
    *_, model, data = mlp_pair([4, 3, 2], 8, 1)
    model = model.double()
    data = [(X.double(), y.double()) for X, y in data]
    op = KFACLinearOperator(model, MSELoss("mean"), dict(model.named_parameters()), data,
                            check_deterministic=False)
    kwargs = dict(damping=DAMPING, use_heuristic_damping=heuristic)
    dense_grouped = op.inverse(**kwargs).todense()
    monkeypatch.setattr(op_mod, "grouped_kron_inverse", lambda *a, **k: None)
    dense_fallback = op.inverse(**kwargs).todense()
    assert_close(dense_grouped, dense_fallback.numpy(), **F64, name="grouped vs fallback")
