"""KFAC and EKFAC for embedding lookups (``nn.Embedding``) against the JAX
package's embedding KFAC and the port's one-hot dense model.

The port's oracles of ``tests/test_kfac_embedding.py``: one-hot inputs make
a lookup's input covariance exactly ``diag(token counts)``, so the embedding
model must give the operator of the same model with a dense layer on
explicit one-hot inputs (relative Frobenius error below 1e-5: the count sums
are exact), and the JAX package's operator on the same numpy weights and
tokens (the tolerances of ``tests/test_torch_gpt.py``: 1e-4 for factors and
matvecs, 1e-3 for inverses).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from curvlinops_tpu.kfac import math as jmath
from curvlinops_tpu.kfac.ekfac import EKFACLinearOperator as JEKFAC
from curvlinops_tpu.kfac.operator import KFACLinearOperator as JKFAC
from curvlinops_tpu.losses import CrossEntropyLoss as JCrossEntropyLoss
from curvlinops_tpu.models import gpt as jgpt
from curvlinops_tpu.models import resnet as jresnet
from curvlinops_tpu_torch import examples as texamples
from curvlinops_tpu_torch.kfac import math as kmath
from curvlinops_tpu_torch.kfac.ekfac import EKFACLinearOperator
from curvlinops_tpu_torch.kfac.kfoc import KFOCLinearOperator
from curvlinops_tpu_torch.kfac.operator import KFACLinearOperator
from curvlinops_tpu_torch.losses import CrossEntropyLoss
from curvlinops_tpu_torch.models import gpt as tgpt
from curvlinops_tpu_torch.models.common import from_jax_params, to_jax_params
from curvlinops_tpu_torch.models.resnet import kfac_restricted
from curvlinops_tpu_torch.models.stack import scan
from tests.test_torch_helpers import (
    capped_torch_threads,
    jax_apply,
    jax_gpt_init,
    jax_name,
    rel_fro,
)

_threads = capped_torch_threads()

V, C, D_OUT, B, T = 11, 6, 4, 8, 5
EXACT_TOL = 1e-5  # embedding against one-hot dense: exact count sums
FACTOR_TOL, MATVEC_TOL, INVERSE_TOL = 1e-4, 1e-4, 1e-3  # against JAX


class EmbModel(nn.Module):
    """A lookup (or, ``onehot``, a dense layer on one-hot inputs), tanh and a
    dense head; ``tied`` adds a second lookup of the table on the tokens
    rolled by one position."""

    def __init__(self, onehot: bool = False, tied: bool = False):
        super().__init__()
        self.emb = nn.Linear(V, C, bias=False) if onehot else nn.Embedding(V, C)
        self.head = nn.Linear(C, D_OUT)
        self.tied = tied

    def forward(self, x):  # noqa: D102
        h = self.emb(x)
        if self.tied:
            h = h + 0.5 * self.emb(torch.roll(x, 1, dims=1))
        return self.head(torch.tanh(h)).reshape(-1, D_OUT)


def jax_emb_model(p, tokens, tied=False):
    h = p["emb"][tokens]
    if tied:
        h = h + 0.5 * p["emb"][jnp.roll(tokens, 1, axis=1)]
    h = jnp.tanh(h)
    return (h @ p["head"]["W"] + p["head"]["b"]).reshape(-1, D_OUT)


def _params(seed=0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "emb": (0.4 * rng.standard_normal((V, C))).astype(np.float32),
        "head": {"W": (0.4 * rng.standard_normal((C, D_OUT))).astype(np.float32),
                 "b": (0.1 * rng.standard_normal(D_OUT)).astype(np.float32)},
    }


def _tokens(seed=1, shape=(B, T)):
    rng = np.random.default_rng(seed)
    return rng.integers(0, V, size=shape), rng.integers(0, D_OUT, size=shape[0] * shape[1])


def _models(jparams, tied=False):
    out = []
    for onehot in (False, True):
        m = EmbModel(onehot, tied)
        m.load_state_dict(from_jax_params(jparams, m))
        out.append(m)
    return out


def _port_ops(cls, jparams, tokens, y, tied=False, **kw):
    """The port's operator on the embedding model and on the one-hot model
    (whose dense ``emb.weight`` is the transposed table), and the models."""
    loss = CrossEntropyLoss("mean")
    X, yt = torch.from_numpy(tokens), torch.from_numpy(y)
    emb, hot = _models(jparams, tied)
    op_e = cls(emb, loss, dict(emb.named_parameters()), [(X, yt)], **kw)
    op_h = cls(hot, loss, dict(hot.named_parameters()), [(F.one_hot(X, V).float(), yt)], **kw)
    return op_e, op_h, emb, hot


def _compare(ops, models, jax_ops, jparams, tol, exact_tol=EXACT_TOL, seed=5):
    """Port operators on the embedding and one-hot models, and a JAX operator,
    applied to one random vector; each result in JAX's layout."""
    rng = np.random.default_rng(seed)
    v_jax = jax.tree.map(lambda a: rng.standard_normal(np.shape(a)).astype(np.float32), jparams)
    r_e, r_h = (
        to_jax_params(op @ from_jax_params(v_jax, m), m) for op, m in zip(ops, models)
    )
    r_j = jax.tree.map(np.asarray, jax_ops @ v_jax)
    for (path, e), h, j in zip(jax.tree_util.tree_flatten_with_path(r_e)[0],
                               jax.tree.leaves(r_h), jax.tree.leaves(r_j)):
        assert rel_fro(e, h) < exact_tol, path
        assert rel_fro(e, j) < tol, path


@pytest.mark.parametrize("fisher_type", ["type-2", "empirical"])
def test_embedding_kfac_equals_onehot_dense_and_jax(fisher_type):
    """Embedding KFAC (a ``"krond"`` block) equals the dense KFAC on the
    explicit one-hot model and JAX's embedding KFAC: matvec, trace and
    Frobenius norm."""
    jparams = _params()
    tokens, y = _tokens()
    op_e, op_h, *models = _port_ops(
        KFACLinearOperator, jparams, tokens, y, fisher_type=fisher_type
    )
    emb_groups = [g for g in op_e.groups if g.input_diag]
    assert len(emb_groups) == 1 and emb_groups[0].d_in == V
    assert op_e._blocks_data[0][0] == "krond"
    j = JKFAC(jax_emb_model, JCrossEntropyLoss("mean"), jparams, [(tokens, y)],
              fisher_type=fisher_type)
    _compare((op_e, op_h), models, j, jparams, MATVEC_TOL)
    for prop in ("trace", "frobenius_norm"):
        a = float(getattr(op_e, prop)())
        assert abs(a - float(getattr(op_h, prop)())) <= 1e-5 * abs(a), prop
        assert abs(a - float(getattr(j, prop)())) <= 1e-4 * abs(a), prop


@pytest.mark.parametrize(
    "inv_kwargs",
    [
        {"damping": 0.1},
        {"damping": 0.1, "use_heuristic_damping": True},
        {"damping": 0.1, "use_exact_damping": True},
    ],
    ids=["plain", "heuristic", "exact"],
)
def test_embedding_kfac_inverse_equals_onehot_dense_and_jax(inv_kwargs):
    """All damping modes of the embedding block's inverse, on tokens that
    cover the vocabulary (a damped Cholesky of a singular one-hot covariance
    and a damped diagonal differ otherwise); exact damping gives an
    ``"eighd"`` block."""
    jparams = _params()
    tokens = np.arange(2 * V).reshape(2, V) % V
    y = np.random.default_rng(2).integers(0, D_OUT, size=2 * V)
    op_e, op_h, *models = _port_ops(KFACLinearOperator, jparams, tokens, y, fisher_type="type-2")
    j = JKFAC(jax_emb_model, JCrossEntropyLoss("mean"), jparams, [(tokens, y)],
              fisher_type="type-2")
    inv = op_e.inverse(**inv_kwargs)
    expected_kind = "eighd" if inv_kwargs.get("use_exact_damping") else "krond"
    assert inv._blocks_data[0][0] == expected_kind
    # the one-hot model's dense Cholesky and eigh round differently
    _compare((inv, op_h.inverse(**inv_kwargs)), models, j.inverse(**inv_kwargs), jparams,
             INVERSE_TOL, exact_tol=1e-4)


def test_embedding_counts_diagonal():
    """The stored input factor is exactly the normalized token counts, as
    JAX's."""
    jparams = _params()
    tokens, y = _tokens()
    op_e, *_ = _port_ops(KFACLinearOperator, jparams, tokens, y, fisher_type="type-2")
    j = JKFAC(jax_emb_model, JCrossEntropyLoss("mean"), jparams, [(tokens, y)],
              fisher_type="type-2")
    counts = np.bincount(tokens.reshape(-1), minlength=V) / (B * T)
    gi = next(i for i, g in enumerate(op_e.groups) if g.input_diag)
    jgi = next(i for i, g in enumerate(j.groups) if g.input_diag)
    np.testing.assert_allclose(op_e._aaT[gi].numpy(), counts, rtol=1e-6)
    np.testing.assert_allclose(op_e._aaT[gi].numpy(), np.asarray(j._aaT[jgi]), rtol=1e-6)
    assert torch.equal(kmath.embedding_input_counts(torch.from_numpy(tokens), V, torch.float32),
                       torch.from_numpy(np.bincount(tokens.reshape(-1), minlength=V)).float())


@pytest.mark.parametrize("cls", [KFACLinearOperator, EKFACLinearOperator], ids=["kfac", "ekfac"])
def test_embedding_state_dict_roundtrip(cls):
    jparams = _params()
    tokens, y = _tokens()
    op, _, model, _ = _port_ops(cls, jparams, tokens, y, fisher_type="type-2")
    v = {n: torch.randn(p.shape, generator=torch.Generator().manual_seed(5))
         for n, p in model.named_parameters()}
    before = op @ v
    op.load_state_dict({k: dict(d) for k, d in op.state_dict().items()})
    after = op @ v
    for name in before:
        assert torch.equal(before[name], after[name]), name


@pytest.mark.parametrize("op_name", ["kfac", "ekfac"])
def test_gpt_with_embeddings_matches_jax(op_name):
    """``kfac_restricted(include_embeddings=True)`` on the stacked tiny GPT
    covers ``wte``/``wpe`` as diagonal-input groups beside the stacked
    blocks: factors (KFAC) and matvec against JAX's, and finite damped
    inverses."""
    config = jgpt.TINY_GPT
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        jgpt.stack_gpt_blocks(jax_gpt_init(config), config),
    )
    tokens = rng.integers(0, config.vocab_size, size=(2, config.block_size + 1))
    X, y = tokens[:, :-1], tokens[:, 1:].reshape(-1)
    fn = jax.tree_util.Partial(jgpt.gpt_apply, config=config)
    jfn, jp = jresnet.kfac_restricted(fn, params, include_embeddings=True)
    jcls, cls = (JKFAC, KFACLinearOperator) if op_name == "kfac" else (JEKFAC, EKFACLinearOperator)
    kw = dict(fisher_type="type-2", check_deterministic=False)
    jop = jcls(jfn, JCrossEntropyLoss("mean"), jp, [(X, y)], **kw)
    model = tgpt.GPT(tgpt.TINY_GPT, scan_blocks=True)
    model.load_state_dict(from_jax_params(params, model))
    _, p = kfac_restricted(model, include_embeddings=True)
    assert sorted(p)[-2:] == ["wpe.weight", "wte.weight"]
    op = cls(model, CrossEntropyLoss("mean"), p,
             [(torch.from_numpy(X), torch.from_numpy(y))], **kw)
    assert sorted(g.name for g in op.groups if g.input_diag) == ["wpe", "wte"]
    if op_name == "kfac":
        port = {g.key: gi for gi, g in enumerate(op.groups)}
        for jgi, g in enumerate(jop.groups):
            key = tuple(None if k is None else _port_name(k, model) for k in g.key)
            tgi = port.pop(key)
            for jf, tf in ((jop._ggT, op._ggT), (jop._aaT, op._aaT)):
                if jgi in jf:
                    assert rel_fro(tf[tgi].numpy(), np.asarray(jf[jgi])) < FACTOR_TOL, key
        assert not port
    v_jax = {k: rng.standard_normal(np.shape(a)).astype(np.float32) for k, a in jp.items()}
    v = from_jax_params(v_jax, model)
    v = {n: v[n] for n in p}
    out = op @ v
    expected = from_jax_params(jax_apply(jop, v_jax), model)
    for name in expected:
        assert rel_fro(out[name].detach().numpy(), expected[name].numpy()) < MATVEC_TOL, name
    inv = op.inverse(damping=0.1, use_exact_damping=True) if op_name == "kfac" else op.inverse(0.1)
    assert all(torch.isfinite(t).all() for t in (inv @ v).values())


def _port_name(path, model) -> str:
    """The port's parameter name of a ``kfac_restricted`` JAX key path."""
    name = jax_name(path)
    return f"{name}.weight" if name in ("wte", "wpe") else name


def test_embedding_eigenvalue_correction_matches_dense_and_jax():
    """The segment-sum correction equals the dense correction with one-hot
    inputs and an identity input basis, and JAX's segment sum."""
    Vv, Bn, S, D1, vocab = 2, 4, 3, 5, 7
    rng = np.random.default_rng(0)
    g = rng.standard_normal((Vv, Bn, S, D1)).astype(np.float32)
    idx = rng.integers(0, vocab, size=(Bn, S))
    Q = np.linalg.qr(rng.standard_normal((D1, D1)))[0].astype(np.float32)
    fast = kmath.eigenvalue_correction_embedding(
        torch.from_numpy(g), torch.from_numpy(Q), torch.from_numpy(idx), vocab
    )
    dense = kmath.eigenvalue_correction(
        torch.from_numpy(g), torch.from_numpy(Q), F.one_hot(torch.from_numpy(idx), vocab).float(),
        torch.eye(vocab), "per_example_gradients",
    )
    expected = jmath.eigenvalue_correction_embedding(g, Q, idx[..., None], vocab)
    assert rel_fro(fast.numpy(), dense.numpy()) < EXACT_TOL
    assert rel_fro(fast.numpy(), np.asarray(expected)) < EXACT_TOL


def test_embedding_ekfac_closer_than_kfac():
    """EKFAC is Frobenius-closer than KFAC to the exact GGN's block-diagonal
    (George et al. 2018), the embedding block included (single-position
    sequences: with weight sharing the corrected eigenvalues are per
    example); the port's EKFAC matvec equals JAX's."""
    jparams = _params()
    tokens, y = _tokens(shape=(16, 1))
    kw = dict(fisher_type="type-2")
    kfac, _, model, _ = _port_ops(KFACLinearOperator, jparams, tokens, y, **kw)
    ekfac, ekfac_h, *models = _port_ops(EKFACLinearOperator, jparams, tokens, y, **kw)
    assert ekfac._blocks_data[0][0] == "eighd"
    params = dict(model.named_parameters())
    data = [(torch.from_numpy(tokens), torch.from_numpy(y))]
    dense = texamples.dense_ggn(model, CrossEntropyLoss("mean"), params, data)
    sizes = [p.numel() for p in params.values()]  # one group per parameter
    mask = torch.block_diag(*[torch.ones(n, n) for n in sizes]).bool()
    proj = torch.where(mask, dense, 0.0)
    n = sum(sizes)
    gap_k = torch.linalg.norm(kfac @ torch.eye(n) - proj)
    gap_e = torch.linalg.norm(ekfac @ torch.eye(n) - proj)
    assert gap_e <= gap_k + 1e-6, (gap_e, gap_k)
    j = JEKFAC(jax_emb_model, JCrossEntropyLoss("mean"), jparams, [(tokens, y)], **kw)
    _compare((ekfac, ekfac_h), models, j, jparams, MATVEC_TOL)


def test_tied_embedding_ekfac_equals_onehot_dense_and_jax():
    """One table, two lookups: the correction concatenates each use's token
    ids along the sharing axis as the gradients are; oracles the tied
    one-hot dense model and JAX's tied embedding EKFAC."""
    jparams = _params()
    tokens, y = _tokens()
    kw = dict(fisher_type="type-2", check_deterministic=False)
    op_e, op_h, *models = _port_ops(EKFACLinearOperator, jparams, tokens, y, tied=True, **kw)
    assert len(op_e.groups[0].uses) == 2
    j = JEKFAC(lambda p, x: jax_emb_model(p, x, tied=True), JCrossEntropyLoss("mean"),
               jparams, [(tokens, y)], **kw)
    _compare((op_e, op_h), models, j, jparams, MATVEC_TOL)


class _ScanLookup(nn.Module):
    """A lookup inside a scan loop (weight shared over the iterations)."""

    def __init__(self):
        super().__init__()
        self.emb = nn.Embedding(V, C)

    def forward(self, tokens):  # noqa: D102
        h0 = torch.zeros(tokens.shape[0], C)
        return scan(lambda h, _: h + torch.tanh(self.emb(tokens)).mean(1), h0, 2)


class _TiedHead(nn.Module):
    """The table reused as the output head: one weight, two layer kinds."""

    def __init__(self):
        super().__init__()
        self.emb = nn.Embedding(V, C)
        self.head = nn.Linear(C, V, bias=False)
        self.head.weight = self.emb.weight

    def forward(self, tokens):  # noqa: D102
        return self.head(torch.tanh(self.emb(tokens))).reshape(-1, V)


def test_embedding_refusals():
    """REDUCE, EKFAC on a lookup inside a scan (KFAC takes it as a shared
    weight), KFOC, a table tied to a dense layer, and a lookup
    configuration the math does not cover (``padding_idx``) are refused."""
    jparams = _params()
    tokens, y = _tokens()
    X, yt = torch.from_numpy(tokens), torch.from_numpy(y)
    model = _models(jparams)[0]
    args = (CrossEntropyLoss("mean"), dict(model.named_parameters()), [(X, yt)])
    with pytest.raises(ValueError, match="EXPAND"):
        KFACLinearOperator(model, *args, fisher_type="type-2", kfac_approx="reduce")
    with pytest.raises(ValueError, match="embedding"):
        KFOCLinearOperator(model, *args, fisher_type="type-2")

    scan_model = _ScanLookup()
    y_c = torch.from_numpy(np.random.default_rng(7).integers(0, C, size=B))
    scan_args = (scan_model, CrossEntropyLoss("mean"), dict(scan_model.named_parameters()),
                 [(X, y_c)])
    with pytest.raises(ValueError, match="scan"):
        EKFACLinearOperator(*scan_args, fisher_type="type-2")
    shared = KFACLinearOperator(*scan_args, fisher_type="type-2")
    assert len(shared.groups[0].uses) == 2 and shared.groups[0].input_diag

    tied = _TiedHead()
    y_v = torch.from_numpy(np.random.default_rng(4).integers(0, V, size=B * T))
    with pytest.raises(ValueError, match="tied across layer kinds"):
        KFACLinearOperator(tied, CrossEntropyLoss("mean"), dict(tied.named_parameters()),
                           [(X, y_v)], fisher_type="type-2")

    padded = EmbModel()
    padded.emb.padding_idx = 0
    with pytest.raises(ValueError, match="padding_idx"):
        KFACLinearOperator(padded, CrossEntropyLoss("mean"), dict(padded.named_parameters()),
                           [(X, yt)], fisher_type="type-2")
