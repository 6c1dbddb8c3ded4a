"""KFAC on the scan-stacked tiny GPT against the unrolled GPT and against
the JAX package's ``lax.scan`` KFAC.

The GPT case of ``test_torch_kfac_scan.py`` (its tolerances), in a file of
its own so that the suite's workers can take the two apart: the stacked
GPT's factors slice by slice against the unrolled GPT's (1e-5), its matvec
(1e-4) and heuristic inverse (1e-3) against JAX's scan KFAC.
"""

import jax
import numpy as np
import pytest
import torch

from curvlinops_tpu.kfac.operator import KFACLinearOperator as JKFAC
from curvlinops_tpu.losses import CrossEntropyLoss as JCrossEntropyLoss
from curvlinops_tpu.models import gpt as jgpt
from curvlinops_tpu.models import resnet as jresnet
from curvlinops_tpu_torch.kfac.operator import KFACLinearOperator
from curvlinops_tpu_torch.losses import CrossEntropyLoss
from curvlinops_tpu_torch.models import gpt as tgpt
from curvlinops_tpu_torch.models.common import from_jax_params
from curvlinops_tpu_torch.models.resnet import kfac_restricted
from tests.test_torch_helpers import capped_torch_threads, jax_apply, jax_gpt_init, rel_fro
from tests.test_torch_kfac_scan import EXACT_TOL, INVERSE_TOL, MATVEC_TOL

_threads = capped_torch_threads()


# ---------------------------------------------------------------------- #
# the tiny GPT: stacked against unrolled and against JAX's scan KFAC
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def gpt_case():
    config = jgpt.TINY_GPT
    rng = np.random.default_rng(0)
    params_u = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        jax_gpt_init(config),
    )
    params_s = jax.tree.map(np.asarray, jgpt.stack_gpt_blocks(params_u, config))
    tokens = rng.integers(0, config.vocab_size, size=(2, config.block_size + 1))
    X, y = tokens[:, :-1], tokens[:, 1:].reshape(-1)
    models = {}
    for name, params, scan_blocks in (("unrolled", params_u, False), ("stacked", params_s, True)):
        m = tgpt.GPT(tgpt.TINY_GPT, scan_blocks=scan_blocks)
        m.load_state_dict(from_jax_params(params, m))
        models[name] = m
    return {"params_s": params_s, "X": X, "y": y, "models": models,
            "data": [(torch.from_numpy(X), torch.from_numpy(y))]}


@pytest.mark.parametrize("fisher_type", ["type-2", "empirical"])
def test_scan_gpt_kfac_matches_unrolled_and_jax(gpt_case, fisher_type):
    """The stacked tiny GPT's KFAC (four stacked weight groups and their
    biases): its factors slice by slice against the unrolled GPT's, its
    matvec and heuristic inverse against JAX's scan KFAC."""
    loss = CrossEntropyLoss("mean")
    ops = {}
    for name, m in gpt_case["models"].items():
        _, p = kfac_restricted(m)
        ops[name] = KFACLinearOperator(m, loss, p, gpt_case["data"], fisher_type=fisher_type,
                                       check_deterministic=False)
    op_s, op_u = ops["stacked"], ops["unrolled"]
    assert sum(g.weight_path is not None for g in op_s.groups) == 4
    assert all(g.stack == tgpt.TINY_GPT.n_layer for g in op_s.groups)
    index_u = {g.key: gi for gi, g in enumerate(op_u.groups)}
    for gi, g in enumerate(op_s.groups):
        for l in range(g.stack):
            key = tuple(None if k is None else k.replace("h.", f"h{l}.") for k in g.key)
            for fac_s, fac_u in ((op_s._ggT, op_u._ggT), (op_s._aaT, op_u._aaT)):
                if gi in fac_s:
                    err = rel_fro(fac_s[gi][l].numpy(), fac_u[index_u[key]].numpy())
                    assert err < EXACT_TOL, (g.name, l, err)

    fn = jax.tree_util.Partial(jgpt.gpt_apply, config=jgpt.TINY_GPT)
    jfn, jp = jresnet.kfac_restricted(fn, gpt_case["params_s"])
    jop = JKFAC(jfn, JCrossEntropyLoss("mean"), jp,
                [(gpt_case["X"], gpt_case["y"])], fisher_type=fisher_type,
                check_deterministic=False)
    rng = np.random.default_rng(1)
    v_jax = {k: rng.standard_normal(np.shape(a)).astype(np.float32) for k, a in jp.items()}
    model = gpt_case["models"]["stacked"]
    v = from_jax_params(v_jax, model)
    v = {n: v[n] for n in kfac_restricted(model)[1]}  # the operator's key order
    for port_op, jax_op, tol in (
        (op_s, jop, MATVEC_TOL),
        (op_s.inverse(1e-3, use_heuristic_damping=True),
         jop.inverse(1e-3, use_heuristic_damping=True), INVERSE_TOL),
    ):
        out = port_op @ v
        expected = from_jax_params(jax_apply(jax_op, v_jax), model)
        assert sorted(out) == sorted(expected)
        for name in expected:
            err = rel_fro(out[name].detach().numpy(), expected[name].numpy())
            assert err < tol, f"{name}: {err}"
