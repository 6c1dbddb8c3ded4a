"""The collector fuzz oracle for the port: generated models are exact or refused.

Twin of ``tests/test_collector_fuzz.py`` with the same seeds and chunks:
``tests/torch_fuzz_cases.py`` holds the torch generators, which make the
JAX generators' draws in the same order (seed ``s`` is the same
architecture in both packages), and the oracle: the port's own dense GGN
projected block-diagonally onto ``kfac.groups``, with JAX's tolerances and
non-vacuity floors; a failing seed is named. The cross-package check
(``test_fuzz_pairs_match_jax``) builds eight seeds with JAX's own
generators, weights and data, and asserts that both packages build or both
refuse, and that where both build the two ``todense()`` agree.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from curvlinops_tpu import FisherType, KFACType
from curvlinops_tpu.kfac.operator import KFACLinearOperator as JKFAC
from curvlinops_tpu_torch import CrossEntropyLoss, MSELoss
from curvlinops_tpu_torch.models.common import from_jax_params
from tests import test_collector_fuzz as jf
from tests.test_torch_helpers import capped_torch_threads, port_order
from tests.torch_fuzz_cases import (
    assert_close,
    build_case,
    build_conv_sharing_case,
    build_linear_sharing_case,
    build_scan_pair,
    dense_of,
    kfac_of,
    run_chunk,
    scan_equals_unrolled,
)

_threads = capped_torch_threads()

_CHUNK = 20
_N_CHUNKS = 10  # 200 generated cases


@pytest.mark.parametrize("chunk", range(_N_CHUNKS))
def test_fuzz_exact_or_refuse(chunk):
    built, refused = run_chunk(build_case, range(chunk * _CHUNK, (chunk + 1) * _CHUNK), 1e-5)
    assert built >= _CHUNK // 3, (built, refused)


@pytest.mark.parametrize("chunk", range(4))
def test_fuzz_scan_equals_unrolled(chunk, n_per_chunk=10):
    for seed in range(chunk * n_per_chunk, (chunk + 1) * n_per_chunk):
        scan_equals_unrolled(seed)


@pytest.mark.parametrize("chunk", range(6))
def test_fuzz_linear_sharing_exact_or_refuse(chunk, n_per_chunk=20):
    """120 generated deep-linear sharing cases: exact or refused."""
    seeds = range(chunk * n_per_chunk, (chunk + 1) * n_per_chunk)
    built, refused = run_chunk(build_linear_sharing_case, seeds, 1e-5)
    assert built >= n_per_chunk // 3, (built, refused)


@pytest.mark.parametrize("chunk", range(6))
def test_fuzz_conv_sharing_exact_or_refuse(chunk, n_per_chunk=15):
    """90 generated conv-sharing cases: exact against the dense GGN or refused."""
    seeds = range(chunk * n_per_chunk, (chunk + 1) * n_per_chunk)
    built, refused = run_chunk(build_conv_sharing_case, seeds, 2e-5)
    assert built >= n_per_chunk // 3, (built, refused)


# ---------------------------------------------------------------------------
# the cross-package check: JAX's own generators, JAX's weights and data
# ---------------------------------------------------------------------------

# seeds over the four families: a conv + cond, a while_loop (refused), an
# embedding + cond; a scan; a 3-batch REDUCE and a slice (refused); a grouped
# 2-D EXPAND and a grouped 1-D REDUCE conv
PAIRS = [("case", 105), ("case", 132), ("case", 144), ("scan", 7),
         ("linear", 0), ("linear", 3), ("conv", 9), ("conv", 18)]


def _jax_outcome(family: str, seed: int):
    """``(dense or None, case)`` of JAX's own case: ``None`` if JAX refuses;
    its ``todense()`` runs as one ``jax.jit`` program."""
    if family == "scan":
        c = jf.build_scan_pair(seed)
        c = dict(model_fn=c["scan_fn"], loss_fn=c["loss"], params=c["params_scan"],
                 data=c["data"], separate=c["separate"])
    else:
        c = {"case": jf.build_case, "linear": jf.build_linear_sharing_case,
             "conv": jf.build_conv_sharing_case}[family](seed)
    approx = c.get("kfac_approx", KFACType.EXPAND)
    try:
        k = JKFAC(c["model_fn"], c["loss_fn"], c["params"], c["data"],
                  fisher_type=FisherType.TYPE2, kfac_approx=approx,
                  separate_weight_and_bias=c["separate"], check_deterministic=False)
        dense = np.asarray(jax.jit(k.todense)())
    except (ValueError, NotImplementedError):
        dense = None
    return dense, c


@pytest.mark.parametrize("family,seed", PAIRS, ids=[f"{f}{s}" for f, s in PAIRS])
def test_fuzz_pairs_match_jax(family, seed):
    """Seed ``s`` builds in both packages or refuses in both; where both
    build, the port's KFAC on JAX's weights and data equals JAX's."""
    expected, jc = _jax_outcome(family, seed)
    if family == "scan":
        model, approx = build_scan_pair(seed)["scanned"], "expand"
    else:
        twin = {"case": build_case, "linear": build_linear_sharing_case,
                "conv": build_conv_sharing_case}[family](seed)
        model, approx = twin["model"], twin["kfac_approx"]
    jparams = jax.tree.map(np.asarray, jc["params"])
    with torch.no_grad():
        for name, t in from_jax_params(jparams, model).items():
            model.get_parameter(name).copy_(t)
    data = [(torch.from_numpy(np.array(X)), torch.from_numpy(np.array(y))) for X, y in jc["data"]]
    data = [(X, y.long() if not y.is_floating_point() else y) for X, y in data]
    port_loss = (CrossEntropyLoss if type(jc["loss_fn"]).__name__ == "CrossEntropyLoss"
                 else MSELoss)(jc["loss_fn"].reduction)
    case = dict(model=model, loss_fn=port_loss, data=data, separate=jc["separate"],
                kfac_approx=approx)
    try:
        kfac, params, _ = kfac_of(case)
        mine = dense_of(kfac)
    except (ValueError, NotImplementedError) as e:
        assert expected is None, f"seed {seed}: JAX builds, the port refuses: {e}"
        return
    assert expected is not None, f"seed {seed}: the port builds, JAX refuses"
    perm = port_order(jparams, model, list(params))
    assert_close(mine, expected[np.ix_(perm, perm)], rtol=1e-4, atol=1e-6,
                 name=f"{family} seed {seed}")
