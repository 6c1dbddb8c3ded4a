"""REDUCE and the randomized rank-r inverse of the KFAC port against JAX.

The same numpy inputs go through ``curvlinops_tpu`` and
``curvlinops_tpu_torch`` on the CPU in float32: the conv patches and their
location means (strides, asymmetric paddings), REDUCE factors and matvecs on
the narrow ResNet and on an MLP applied along a sequence axis (weight
sharing), the randomized eigendecomposition given JAX's own test matrix, the
4-sector damped inverse, and ``KFACLinearOperator.inverse(rank=)``. Each
check states its tolerance; the refusals are checked by type and message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curvlinops_tpu.kfac import math as jmath
from curvlinops_tpu.kfac import randomized as jrand
from curvlinops_tpu.kfac.operator import KFACLinearOperator as JKFAC
from curvlinops_tpu.losses import CrossEntropyLoss as JCrossEntropyLoss
from curvlinops_tpu.losses import MSELoss as JMSELoss
from curvlinops_tpu.models import resnet as jresnet
from curvlinops_tpu_torch.kfac import math as tmath
from curvlinops_tpu_torch.kfac import randomized as trand
from curvlinops_tpu_torch.kfac.operator import KFACLinearOperator
from curvlinops_tpu_torch.losses import CrossEntropyLoss, MSELoss
from curvlinops_tpu_torch.models.common import from_jax_params
from tests.test_torch_helpers import (
    assert_same_vector,
    capped_torch_threads,
    jax_name,
    mlp_pair,
    narrow_resnet,
    random_jax_vector,
    rel_fro,
    jax_apply,
)

_threads = capped_torch_threads()

# float32 sums in another order: patches are copies (exact up to the mean's
# order), factors and matvecs measured at ~3e-6 relative
PATCH_ATOL, FACTOR_TOL, MATVEC_TOL = 1e-6, 1e-4, 1e-4
# randomized eigh: the same test matrix through QR and eigh in two LAPACK
# call orders; eigenvalues and projectors measured at ~1e-6
EIGH_TOL = 1e-4
# the rank-r inverse against the exact one at a rank above the factors' true
# rank: the tails carry float32 trace cancellation (JAX's own tolerance)
RANK_RTOL, RANK_ATOL = 5e-3, 2e-4


# ---------------------------------------------------------------------- #
# conv patches and their location means
# ---------------------------------------------------------------------- #
PATCH_CASES = [
    ("plain3x3", (3, 3), (1, 1), ((1, 1), (1, 1))),
    ("strided", (3, 3), (2, 2), ((1, 1), (1, 1))),
    ("asym_pad", (3, 3), (2, 1), ((0, 1), (2, 0))),
    ("no_pad", (3, 3), (1, 2), ((0, 0), (0, 0))),
    ("stem_7x7", (7, 7), (2, 2), ((3, 2), (2, 3))),
]


def _conv_metas(x_shape, kernel, stride, padding, O=5):
    B, C, H, W = x_shape
    w_shape = (O, C, *kernel)
    jmeta = {
        "dimension_numbers": jax.lax.conv_dimension_numbers(
            x_shape, w_shape, ("NCHW", "OIHW", "NCHW")
        ),
        "w_shape": w_shape,
        "window_strides": stride,
        "padding": padding,
        "lhs_dilation": (1, 1),
        "rhs_dilation": (1, 1),
        "feature_group_count": 1,
        "batch_group_count": 1,
    }
    tmeta = {
        "stride": stride, "padding": padding, "kernel": kernel, "dilation": (1, 1),
        "groups": 1, "C": C, "w_shape": w_shape,
    }
    return jmeta, tmeta


@pytest.mark.parametrize(
    "kernel,stride,padding", [c[1:] for c in PATCH_CASES], ids=[c[0] for c in PATCH_CASES]
)
def test_patches_and_averaged_patches_match_jax(kernel, stride, padding):
    """The strided-view patches, the averaged patches and REDUCE's sharing
    format (bias column appended) against JAX's (abs 1e-6)."""
    x = np.random.default_rng(0).standard_normal((3, 4, 11, 10)).astype(np.float32)
    jmeta, tmeta = _conv_metas(x.shape, kernel, stride, padding)
    xt = torch.from_numpy(x)
    # one jitted JAX program (eager, each of the 49 slices of a 7x7 compiles)
    j_full, j_shared = jax.jit(lambda x: (
        jmath.extract_conv_patches(x, jmeta),
        jmath.input_to_sharing_format(x, "conv", jmeta, "reduce", bias_pad=1.0),
    ))(x)
    full = tmath.extract_conv_patches(xt, tmeta)
    avg = tmath.extract_averaged_patches(xt, tmeta)
    shared = tmath.input_to_sharing_format(xt, "conv", tmeta, "reduce", bias_pad=1.0)
    np.testing.assert_allclose(full.numpy(), np.asarray(j_full), atol=PATCH_ATOL)
    np.testing.assert_allclose(shared.numpy(), np.asarray(j_shared), atol=PATCH_ATOL)
    np.testing.assert_allclose(avg.numpy(), full.mean(1, keepdim=True).numpy(), atol=PATCH_ATOL)
    np.testing.assert_allclose(shared[..., :-1].numpy(), avg.numpy(), atol=0)


# ---------------------------------------------------------------------- #
# REDUCE factors and matvecs against JAX
# ---------------------------------------------------------------------- #
def _by_name(jop, top):
    """Pairs of (JAX group index, port group index) with the same parameters."""
    port = {g.key: gi for gi, g in enumerate(top.groups)}
    pairs = []
    for gi, g in enumerate(jop.groups):
        key = tuple(None if p is None else jax_name(p) for p in (g.weight_path, g.bias_path))
        pairs.append((gi, port.pop(key)))
    assert not port, f"port groups without a JAX counterpart: {list(port)}"
    return pairs


def _assert_same_factors(jop, top):
    for jgi, tgi in _by_name(jop, top):
        assert (jgi in jop._aaT) == (tgi in top._aaT)
        if jgi in jop._aaT:
            assert rel_fro(top._aaT[tgi], jop._aaT[jgi]) < FACTOR_TOL, top.groups[tgi].name
        assert rel_fro(top._ggT[tgi], jop._ggT[jgi]) < FACTOR_TOL, top.groups[tgi].name


@pytest.fixture(scope="module")
def resnet_reduce():
    case = narrow_resnet()
    kfac_fn, kfac_params = jresnet.kfac_restricted(case["apply_fn"], case["jax_params"])
    jop = JKFAC(
        kfac_fn, JCrossEntropyLoss("mean"), kfac_params, [(case["X_nhwc"], case["y"])],
        fisher_type="type-2", kfac_approx="reduce", check_deterministic=False,
    )
    params = from_jax_params(jax.tree.map(np.asarray, kfac_params), case["model"])
    top = KFACLinearOperator(
        case["model"], CrossEntropyLoss("mean"), params, [(case["X"], case["y_t"])],
        fisher_type="type-2", kfac_approx="reduce",
    )
    v_jax = random_jax_vector(kfac_params, 0)
    return jop, top, v_jax, case["model"]


def test_reduce_resnet_factors_and_matvec_match_jax(resnet_reduce):
    """REDUCE on the narrow ResNet (type-2): every factor and the matvec
    against JAX (relative Frobenius 1e-4)."""
    jop, top, v_jax, model = resnet_reduce
    assert len(_by_name(jop, top)) == 14
    _assert_same_factors(jop, top)
    assert_same_vector(top @ from_jax_params(v_jax, model), jax_apply(jop, v_jax), model, MATVEC_TOL,
                        "REDUCE matvec")


@pytest.mark.parametrize("separate", [True, False], ids=["separate", "joint"])
def test_reduce_weight_sharing_mlp_matches_jax(separate):
    """REDUCE on an MLP along a sequence axis of 5 (type-2, MSE): factors
    and matvec against JAX (relative Frobenius 1e-4)."""
    model_fn, jparams, jdata, model, tdata = mlp_pair([4, 3, 2], 6, 50, seq=5)
    kw = dict(fisher_type="type-2", kfac_approx="reduce", separate_weight_and_bias=separate,
              check_deterministic=False)
    jop = JKFAC(model_fn, JMSELoss("mean"), jparams, jdata, **kw)
    top = KFACLinearOperator(model, MSELoss("mean"), dict(model.named_parameters()), tdata, **kw)
    _assert_same_factors(jop, top)
    v_jax = random_jax_vector(jparams, 1)
    assert_same_vector(top @ from_jax_params(v_jax, model), jax_apply(jop, v_jax), model, MATVEC_TOL,
                        "REDUCE matvec")


# ---------------------------------------------------------------------- #
# the randomized eigendecomposition and the sector inverse
# ---------------------------------------------------------------------- #
def _psd(rng, d, decay):
    Q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    return ((Q * np.exp(-decay * np.arange(d))) @ Q.T).astype(np.float32)


def test_randomized_eigh_matches_jax_given_its_test_matrix():
    """``randomized_eigh`` with JAX's own Gaussian draw: eigenvalues,
    projector ``U U^T`` and trace-preserving tail against JAX (1e-4)."""
    S = _psd(np.random.default_rng(3), 16, 0.5)
    key, rank = jax.random.key(2), 6
    lam_j, U_j, tail_j = jax.jit(lambda S: jrand.randomized_eigh(S, rank, key))(S)
    omega = np.asarray(jax.random.normal(key, (16, rank), dtype=jnp.float32))
    lam, U, tail = trand.randomized_eigh(
        torch.from_numpy(S), rank, power_iters=1, omega=torch.from_numpy(omega)
    )
    np.testing.assert_allclose(lam.numpy(), np.asarray(lam_j), rtol=EIGH_TOL, atol=1e-7)
    U_j = np.asarray(U_j)
    np.testing.assert_allclose((U @ U.T).numpy(), U_j @ U_j.T, atol=EIGH_TOL)
    np.testing.assert_allclose(float(tail), float(tail_j), rtol=EIGH_TOL)
    # the tail preserves the trace; rank >= D is the exact eigh
    assert abs(float(lam.sum() + tail * (16 - rank)) - np.trace(S)) < 1e-5 * np.trace(S)
    lam_f, _, tail_f = trand.randomized_eigh(torch.from_numpy(S), 16)
    np.testing.assert_allclose(lam_f.numpy(), np.linalg.eigvalsh(S), rtol=1e-5, atol=1e-7)
    assert float(tail_f) == 0.0


def test_range_core_matches_jax_given_its_test_matrix():
    """``_range_core`` on a stack of two factors with JAX's draw: the range
    projectors, the core spectra and the traces against JAX (1e-4)."""
    rng = np.random.default_rng(4)
    stacked = np.stack([_psd(rng, 12, 0.7), _psd(rng, 12, 0.3)])
    omega = np.asarray(jax.random.normal(jax.random.key(5), (2, 12, 4), dtype=jnp.float32))
    Q_j, core_j, tr_j = jax.jit(lambda s, o: jrand._range_core(s, o, 2))(stacked, omega)
    Q, core, tr = trand._range_core(torch.from_numpy(stacked), torch.from_numpy(omega), 2)
    Q_j = np.asarray(Q_j)
    np.testing.assert_allclose((Q @ Q.mT).numpy(), Q_j @ np.swapaxes(Q_j, 1, 2), atol=EIGH_TOL)
    np.testing.assert_allclose(
        torch.linalg.eigvalsh(core).numpy(), np.linalg.eigvalsh(np.asarray(core_j)),
        rtol=EIGH_TOL, atol=1e-7,
    )
    np.testing.assert_allclose(tr.numpy(), np.asarray(tr_j), rtol=1e-6)


def test_sector_inverse_matches_jax_and_dense():
    """``lr_damped_inverse_data`` + ``lr_apply`` against JAX and against the
    dense inverse of the reconstructed damped Kronecker product (1e-4)."""
    rng = np.random.default_rng(6)
    dA, rA, dG, rG, delta = 7, 3, 5, 2, 0.3
    U_A = np.linalg.qr(rng.standard_normal((dA, rA)))[0].astype(np.float32)
    U_G = np.linalg.qr(rng.standard_normal((dG, rG)))[0].astype(np.float32)
    eig_A = (np.abs(rng.standard_normal(rA)).astype(np.float32), U_A, np.float32(0.2))
    eig_G = (np.abs(rng.standard_normal(rG)).astype(np.float32), U_G, np.float32(0.1))
    comp = rng.standard_normal((dA * dG, 2)).astype(np.float32)
    out_j = jax.jit(
        lambda eA, eG, c: jrand.lr_apply(jrand.lr_damped_inverse_data(eA, eG, delta), c)
    )(eig_A, eig_G, comp)
    data = trand.lr_damped_inverse_data(
        tuple(map(torch.as_tensor, eig_A)), tuple(map(torch.as_tensor, eig_G)), delta
    )
    out = trand.lr_apply(data, torch.from_numpy(comp))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=1e-4, atol=1e-6)

    def recon(lam, U, tail):
        return (U * lam) @ U.T + tail * (np.eye(len(U)) - U @ U.T)

    dense = np.kron(recon(*eig_A), recon(*eig_G)) + delta * np.eye(dA * dG)
    np.testing.assert_allclose(out.numpy(), np.linalg.solve(dense, comp), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------- #
# KFACLinearOperator.inverse(rank=)
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def mlp_rank_case():
    model_fn, jparams, jdata, model, tdata = mlp_pair([20, 18, 16, 3], 4, 0)
    kw = dict(fisher_type="type-2", check_deterministic=False)
    jop = JKFAC(model_fn, JMSELoss("mean"), jparams, jdata, **kw)
    top = KFACLinearOperator(model, MSELoss("mean"), dict(model.named_parameters()), tdata, **kw)
    v_jax = random_jax_vector(jparams, 42)
    return jop, top, v_jax, model


def test_rank_inverse_above_true_rank_matches_exact_and_jax(mlp_rank_case):
    """Batch 4: every factor's true rank (at most 12) is below rank 14, so
    the randomized inverse equals the exact one (rtol 5e-3, atol 2e-4, as in
    JAX's test) and JAX's rank-14 inverse (same tolerance); bias blocks of
    18 and 16 take the sector route with a trivial second factor."""
    jop, top, v_jax, model = mlp_rank_case
    v = from_jax_params(v_jax, model)
    lowrank = top.inverse(damping=0.1, use_exact_damping=True, rank=14, rank_power_iters=2)
    kinds = {gi: kind for gi, (kind, _) in lowrank._blocks_data.items()}
    assert {top.groups[gi].name: k for gi, k in kinds.items()} == {
        "l0": "lreigh", "l0.bias": "lreigh", "l1": "lreigh", "l1.bias": "lreigh",
        "l2": "lreigh", "l2.bias": "eigh",
    }
    out = lowrank @ v
    exact = top.inverse(damping=0.1, use_exact_damping=True) @ v
    jout = jop.inverse(damping=0.1, use_exact_damping=True, rank=14, rank_power_iters=2) @ v_jax
    expected_jax = from_jax_params(jax.tree.map(np.asarray, jout), model)
    for name in v:
        np.testing.assert_allclose(out[name].numpy(), exact[name].numpy(),
                                   rtol=RANK_RTOL, atol=RANK_ATOL, err_msg=name)
        np.testing.assert_allclose(out[name].numpy(), expected_jax[name].numpy(),
                                   rtol=RANK_RTOL, atol=RANK_ATOL, err_msg=name)


def test_rank_at_least_every_dim_is_the_exact_inverse(mlp_rank_case):
    """``rank >= D`` for every factor: the exact ``eigh`` route, equal to
    the exact inverse to float32 roundoff (relative 1e-6), and repeated
    builds with the default generator are identical."""
    _, top, v_jax, model = mlp_rank_case
    v = from_jax_params(v_jax, model)
    full = top.inverse(damping=0.1, use_exact_damping=True, rank=64)
    assert {kind for kind, _ in full._blocks_data.values()} == {"eigh"}
    exact = top.inverse(damping=0.1, use_exact_damping=True) @ v
    for name, t in (full @ v).items():
        assert rel_fro(t.numpy(), exact[name].numpy()) < 1e-6, name
    a = top.inverse(damping=0.1, use_exact_damping=True, rank=8) @ v
    b = top.inverse(damping=0.1, use_exact_damping=True, rank=8) @ v
    assert all(torch.equal(a[n], b[n]) for n in a)


@pytest.mark.parametrize(
    "kwargs,error,match",
    [
        (dict(rank=4), ValueError, "rank= requires use_exact_damping=True"),
        (dict(rank=0, use_exact_damping=True), ValueError, "rank must be a positive int"),
        (dict(rank=2.5, use_exact_damping=True), ValueError, "rank must be a positive int"),
        (dict(use_exact_damping=True, use_heuristic_damping=True), ValueError,
         "Choose either heuristic or exact damping"),
    ],
    ids=["no_exact_damping", "zero", "float", "both_dampings"],
)
def test_rank_inverse_refusals(mlp_rank_case, kwargs, error, match):
    with pytest.raises(error, match=match):
        mlp_rank_case[1].inverse(damping=0.1, **kwargs)


def test_batched_randomized_eigh_refuses_a_mesh():
    # a mesh without the data axis; real meshes are in tests/test_torch_parallel.py
    with pytest.raises(ValueError, match="no axis 'data'"):
        trand.batched_randomized_eigh({0: torch.eye(3)}, 2, mesh=object())


@pytest.mark.parametrize("user_tf32", [False, True])
def test_full_float32_matmul_keeps_the_flags_readable(user_tf32):
    """The range finder's TF32 guard turns ``allow_tf32`` off inside and
    restores the user's value, through the one API the caller uses: a later
    ``allow_tf32`` write must leave ``get_float32_matmul_precision()``
    readable (a guard that set the precision through the other API made it
    raise on the card, where the range finder ran after such a write)."""
    from curvlinops_tpu_torch.utils.misc import full_float32_matmul

    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = user_tf32
        with full_float32_matmul():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is user_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        assert torch.get_float32_matmul_precision() == "highest"
        with full_float32_matmul():
            pass
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
