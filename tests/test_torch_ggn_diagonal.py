"""The port's GGN diagonal against the JAX package and the dense GGN, on the CPU.

The exact (type-2) diagonal against ``curvlinops_tpu``'s
``GGNDiagonalLinearOperator`` on the small cases of
``test_torch_curvature.py`` (float64, 1e-10, ``ignore_index`` included) and
against the diagonal of the port's own dense GGN; the MC diagonal's
expectation (the JAX package's ``test_ggn_diagonal_mc_expectation``) and its
identity with the diagonal of the MC Fisher operator on the same samples;
the vmap-compatibility probe refusing BatchNorm in training mode; and the
tiny GPT, whose prediction has a row per token: the flash model (the plain
versions on the CPU) against the einsum model under one generator, and the
exact diagonal against the GGN's own columns.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from torch import nn
from torch.utils import _pytree as pytree

from curvlinops_tpu.curvature.ggn_diagonal import (
    GGNDiagonalLinearOperator as JGGNDiagonal,
)
from curvlinops_tpu_torch import GGNDiagonalLinearOperator, GGNLinearOperator, MSELoss
from curvlinops_tpu_torch.curvature.loss_hessian import FisherType, make_grad_output_fn
from curvlinops_tpu_torch.losses import CrossEntropyLoss
from curvlinops_tpu_torch.models.gpt import TINY_GPT, shakespeare_nanogpt
from curvlinops_tpu_torch.risk import batch_generator
from tests.test_torch_curvature import make_case
from tests.test_torch_helpers import capped_torch_threads, rel_fro

_threads = capped_torch_threads()

PARITY_TOL = 1e-10  # float64
CASES = ("mlp_mse_mean", "mlp_mse_sum", "mlp_ce_mean", "mlp_bce_mean", "seq_ce_mean",
         "seq_ce_ignore")


def flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(t).reshape(-1) for t in pytree.tree_leaves(tree)])


def port_diagonal(case: dict, **kw) -> GGNDiagonalLinearOperator:
    c = case["torch"]
    return GGNDiagonalLinearOperator(c["model"], c["loss_fn"], c["params"], c["data"],
                                     batch_size_fn=c["batch_size_fn"], **kw)


def port_ggn(case: dict, **kw) -> GGNLinearOperator:
    c = case["torch"]
    return GGNLinearOperator(c["model"], c["loss_fn"], c["params"], c["data"],
                             batch_size_fn=c["batch_size_fn"], check_deterministic=False, **kw)


def with_jax_scalars(case: dict) -> np.ndarray:
    """The port's diagonal with the JAX package's float32 normalisation
    scalars: per batch, ``c / c_batch`` rounded as the JAX package computes
    it (``c`` and ``mean_rescale`` in float32, ``ggn_diagonal.py:121`` and
    ``loss_hessian.py:71``) in place of the port's float64 one."""
    c = case["torch"]
    bs_fn = c["batch_size_fn"] or (lambda X: X.shape[0])
    N = sum(bs_fn(X) for X, _ in c["data"])
    mean = c["loss_fn"].reduction == "mean"
    ce = isinstance(c["loss_fn"], CrossEntropyLoss)
    total = 0.0
    for X, y in c["data"]:
        B, count = bs_fn(X), max(int((y != -100).sum()), 1)
        part = flat(port_diagonal(dict(torch=dict(c, data=[(X, y)])), num_data=N,
                                  check_deterministic=False).diagonal)
        if mean:  # c / (B / mean_rescale), float32 in the JAX package
            r32 = np.float32(y.numel()) / np.float32(count) if ce else np.float32(1.0)
            r64 = y.numel() / count if ce else 1.0
            part = part * float(np.float32(B / N) / (np.float32(B) / r32)) / (r64 / N)
        total = total + part
    return total


@pytest.fixture(scope="module")
def cases():
    """The float64 cases and the JAX package's diagonals, built once."""
    out = {}
    with jax.enable_x64(True):
        for name in CASES:
            case = make_case(name, dtype=np.float64)
            j = case["jax"]
            diag = JGGNDiagonal(j["model_fn"], j["loss_fn"], j["params"], j["data"],
                                check_deterministic=False).diagonal
            out[name] = (case, flat(jax.block_until_ready(diag)))
    return out


@pytest.mark.parametrize("name", CASES)
def test_exact_diagonal_matches_jax_and_dense(cases, name):
    """The exact diagonal (with the determinism and vmap probes) against the
    diagonal of the port's dense GGN, and, per batch with the JAX package's
    float32 normalisation scalars, against the JAX package's, float64."""
    case, expected = cases[name]
    assert rel_fro(with_jax_scalars(case), expected) < PARITY_TOL
    diag = flat(port_diagonal(case).diagonal)
    dense = torch.diagonal(port_ggn(case).todense()).numpy()
    assert rel_fro(diag, dense) < PARITY_TOL


def test_mc_diagonal_expectation(cases):
    """5,000 MC samples per datum reach the exact diagonal (the JAX package's test)."""
    case, _ = cases["mlp_mse_mean"]
    diag = flat(port_diagonal(case, mc_samples=5000, check_deterministic=False).diagonal)
    ref = torch.diagonal(port_ggn(case).todense()).numpy()
    assert np.abs(diag - ref).max() / max(np.abs(ref).max(), 1e-3) < 0.12


@pytest.mark.parametrize("name", ["mlp_ce_mean", "seq_ce_ignore"])
def test_mc_diagonal_is_the_mc_fisher_diagonal(cases, name):
    """The MC diagonal draws from the MC Fisher operator's per-batch
    generators: with one prediction row a datum (``[N, C]`` and ``[N, C, S]``
    predictions) it is that operator's diagonal, same samples, float64."""
    case, _ = cases[name]
    diag = flat(port_diagonal(case, mc_samples=3, seed=11).diagonal)
    dense = torch.diagonal(port_ggn(case, mc_samples=3, seed=11).todense()).numpy()
    assert rel_fro(diag, dense) < PARITY_TOL


def test_vmap_probe_refuses_batchnorm_in_training_mode():
    torch.manual_seed(0)
    model = nn.Sequential(nn.Linear(4, 6), nn.BatchNorm1d(6), nn.Linear(6, 3)).train()
    data = [(torch.randn(8, 4), torch.randn(8, 3))]
    params = dict(model.named_parameters())
    with pytest.raises(RuntimeError, match="not vmap-compatible"):
        GGNDiagonalLinearOperator(model, MSELoss("mean"), params, data)
    model.eval()
    GGNDiagonalLinearOperator(model, MSELoss("mean"), params, data)


@pytest.fixture(scope="module")
def tiny_gpts():
    return {impl: shakespeare_nanogpt(2, TINY_GPT, seed=0, device="cpu", attention_impl=impl)
            for impl in ("flash", "einsum")}


def test_tiny_flash_gpt_mc_diagonal_matches_einsum(tiny_gpts):
    """The flash GPT's MC diagonal (reverse mode only: the per-datum vjp
    through the flash Function's vmap rule) against the einsum GPT's, one
    generator, float32."""
    diags = [
        flat(GGNDiagonalLinearOperator(p.model, p.loss_fn, p.params, p.data, mc_samples=1,
                                       check_deterministic=False).diagonal)
        for p in tiny_gpts.values()
    ]
    assert rel_fro(*diags) < 1e-5


def test_tiny_gpt_exact_diagonal_matches_ggn_columns(tiny_gpts):
    """A prediction row per token: each square-root column stays on its
    row. Entries of the exact diagonal against the GGN's own columns."""
    p = tiny_gpts["einsum"]
    diag = flat(GGNDiagonalLinearOperator(p.model, p.loss_fn, p.params, p.data).diagonal)
    G = GGNLinearOperator(p.model, p.loss_fn, p.params, p.data, check_deterministic=False)
    idx = torch.randperm(G.shape[1], generator=torch.Generator().manual_seed(0))[:12]
    E = torch.zeros(G.shape[1], 12)
    E[idx, torch.arange(12)] = 1.0
    cols = (G @ E)[idx, torch.arange(12)].numpy()
    assert rel_fro(diag[idx.numpy()], cols) < 1e-5


def test_tiny_gpt_mc_diagonal_is_per_sequence(tiny_gpts):
    """A prediction row per token (``R = T`` rows a datum): the MC Fisher
    operator gives each row its own sample, so its diagonal is
    ``sum_r (J_r^T g_r)^2``; the MC diagonal maps one vjp per sequence and
    sample, ``(sum_r J_r^T g_r)^2``, the same in expectation with the rows'
    cross terms besides. Both (the operator's on 16 entries) against the
    per-row products ``J_r^T g_r`` on the operator's samples, float64."""
    p = shakespeare_nanogpt(2, TINY_GPT, seed=0, dtype=torch.float64, device="cpu",
                            attention_impl="einsum")
    (X, y), = p.data
    k, seed = 2, 11
    params = {name: t.detach() for name, t in p.params.items()}
    pred, vjp_fn = torch.func.vjp(lambda q: torch.func.functional_call(p.model, q, (X,)),
                                  params)
    g = make_grad_output_fn(p.loss_fn, FisherType.MC, k)(
        pred.detach(), y, batch_generator(seed, 0, pred.device))  # [B * T, k, vocab]
    rows = pred.shape[0]
    onehot = torch.eye(rows, dtype=g.dtype)[:, None, :, None] * g[:, :, None]  # [r, k, rows, V]
    u = torch.func.vmap(
        lambda t: torch.cat([g.reshape(-1) for g in pytree.tree_leaves(vjp_fn(t)[0])])
    )(onehot.reshape(rows * k, *pred.shape))
    u = u.numpy().reshape(X.shape[0], -1, k, u.shape[-1]) / np.sqrt(rows)  # [B, T, k, P]
    op = GGNLinearOperator(p.model, p.loss_fn, p.params, p.data, mc_samples=k, seed=seed,
                           check_deterministic=False)
    idx = torch.randperm(op.shape[1], generator=torch.Generator().manual_seed(0))[:16]
    E = torch.zeros(op.shape[1], 16, dtype=torch.float64)
    E[idx, torch.arange(16)] = 1.0
    op_diag = (op @ E)[idx, torch.arange(16)].numpy()
    assert rel_fro(op_diag, (u**2).sum((0, 1, 2))[idx.numpy()]) < PARITY_TOL
    diag = flat(GGNDiagonalLinearOperator(p.model, p.loss_fn, p.params, p.data, mc_samples=k,
                                          seed=seed, check_deterministic=False).diagonal)
    assert rel_fro(diag, (u.sum(1) ** 2).sum((0, 1))) < PARITY_TOL
