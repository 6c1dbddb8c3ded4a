"""The port's data parallelism on a 4-process gloo world, against the
mesh-less port and JAX's oracles, on the CPU.

The twins of ``tests/test_parallel.py`` (15), of
``tests/test_case_matrix.py::test_shard_params_report`` and of
``tests/test_held.py::test_held_mesh_matches_single_device``, and the
port's own traps: MC draws and cross-entropy's ``ignore_index`` under a
mesh, the Jacobians' rows, an uneven batch, the flash GPT's KFAC.

One world serves the module: a module-scoped fixture writes the numpy
inputs (``tests/cases.py``'s MLP cases and the twins' matrices, drawn with
numpy from the JAX tests' seeds: op by op, JAX's own draws compiled for 15
s), starts four processes of
``tests/torch_parallel_worker.py`` (which imports no JAX) that meet through
a ``FileStore`` (no TCP port to race for under ``-n 6``), waits at most
:data:`WAIT` seconds and kills them then, so that a hang fails the tests
instead of stalling the suite. Every check runs in the workers; the tests
here compare rank 0's results with the mesh and without it at the JAX
tests' tolerances, and both with JAX's jitted mesh-less oracles, for every
check whose result does not hang on the port's own random draws, at the
port's float32 tolerance against JAX (rtol 2e-4, atol 5e-6).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curvlinops_tpu import EFLinearOperator as JEF
from curvlinops_tpu import GGNDiagonalLinearOperator as JGGNDiag
from curvlinops_tpu import GGNLinearOperator as JGGN
from curvlinops_tpu import HessianLinearOperator as JHessian
from curvlinops_tpu import IdentityLinearOperator as JIdentity
from curvlinops_tpu import JacobianLinearOperator as JJacobian
from curvlinops_tpu import MINRESInverseLinearOperator as JMINRES
from curvlinops_tpu import TransposedJacobianLinearOperator as JJacobianT
from curvlinops_tpu.kfac.ekfac import EKFACLinearOperator as JEKFAC
from curvlinops_tpu.kfac.kfoc import KFOCLinearOperator as JKFOC
from curvlinops_tpu.kfac.operator import KFACLinearOperator as JKFAC
from tests.test_torch_helpers import capped_torch_threads, jax_name
from tests.utils import report_nonclose

_threads = capped_torch_threads()

ROOT = Path(__file__).resolve().parents[1]
WORLD, WAIT = 4, 120.0
RTOL_JAX, ATOL_JAX = 2e-4, 5e-6  # the port against the JAX package, float32


# ---------------------------------------------------------------------- #
# inputs
# ---------------------------------------------------------------------- #
def _port_vector(jparams: dict, seed: int) -> dict:
    """A standard normal vector by the port's parameter names
    (``nn.Linear`` holds ``W^T``)."""
    rng = np.random.default_rng(seed)
    out = {}
    for layer, p in jparams.items():
        out[f"{layer}.weight"] = rng.standard_normal(p["W"].T.shape).astype(np.float32)
        out[f"{layer}.bias"] = rng.standard_normal(p["b"].shape).astype(np.float32)
    return out


def _to_jax_layout(vec: dict) -> dict:
    layers = sorted({k.rsplit(".", 1)[0] for k in vec})
    return {l: {"W": jnp.asarray(vec[f"{l}.weight"].T), "b": jnp.asarray(vec[f"{l}.bias"])}
            for l in layers}


def _to_port_layout(tree: dict) -> dict:
    out = {}
    for layer, p in tree.items():
        out[f"{layer}.weight"] = np.asarray(p["W"]).T
        out[f"{layer}.bias"] = np.asarray(p["b"])
    return out


# tests/cases.py's MLP cases: layer sizes, loss, and the targets' draw
_MLP_CASES = {
    "mlp_mse": ([5, 8, 3], "MSELoss", lambda rng, n, c: rng.standard_normal((n, c))),
    "mlp_ce": ([6, 7, 4], "CrossEntropyLoss", lambda rng, n, c: rng.integers(0, c, n)),
    "mlp_bce": ([4, 6, 2], "BCEWithLogitsLoss",
                lambda rng, n, c: rng.integers(0, 2, (n, c)).astype(np.float64)),
}


def _mlp(name: str, seed: int, rows: int = 8, ignore=(), dtype=np.float32) -> dict:
    """A ``tests/cases.py`` MLP case (its sizes, loss and reduction; weights
    ``N(0, 1/d_in)``, biases ``N(0, 0.01)``) on one batch of ``rows``, drawn
    with numpy from the JAX test's seed, in ``dtype``."""
    kind, reduction = name.rsplit("_", 1)
    sizes, loss, draw_y = _MLP_CASES[kind]
    rng = np.random.default_rng(seed)
    params = {
        f"layer{i}": {"W": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(dtype),
                      "b": (0.1 * rng.standard_normal(b)).astype(dtype)}
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))
    }
    X = rng.standard_normal((rows, sizes[0])).astype(dtype)
    y = draw_y(rng, rows, sizes[-1])
    y = y.astype(dtype) if y.dtype.kind == "f" else y
    y[list(ignore)] = -100
    v = {k: a.astype(dtype) for k, a in _port_vector(params, seed).items()}
    return dict(params=params, X=X, y=y, loss=(loss, reduction), v=v)


def _spd(seed: int, shapes) -> dict:
    """Symmetric positive definite stacks ``A A^T + 0.1 I`` (the JAX twin's)."""
    rng, mats = np.random.default_rng(seed), {}
    for i, (n, d) in enumerate(shapes):
        A = rng.standard_normal((d, d) if n is None else (n, d, d)).astype(np.float32)
        mats[i] = A @ np.swapaxes(A, -1, -2) + np.float32(0.1) * np.eye(d, dtype=np.float32)
    return mats


def _decaying(seed: int) -> dict:
    """PSD matrices with eigenvalues ``(1 + i)^-2`` (the JAX twin's)."""
    rng, mats = np.random.default_rng(seed), {}
    for i, d in enumerate([24, 24, 10]):
        B = (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)
        lam = (1.0 + np.arange(d, dtype=np.float32)) ** -2.0
        mats[f"m{i}"] = np.einsum("de,e,fe->df", B, lam, B).astype(np.float32)
    return mats


def _held_case() -> dict:
    """``tests/test_held.py::_mlp_case(seed=4)``'s model (6 -> 8 -> 4, tanh,
    weights ``0.4 N(0, 1)``, zero biases) on one batch of 8, MSE."""
    rng = np.random.default_rng(4)
    params = {
        "l1": {"W": (0.4 * rng.standard_normal((6, 8))).astype(np.float32),
               "b": np.zeros(8, np.float32)},
        "l2": {"W": (0.4 * rng.standard_normal((8, 4))).astype(np.float32),
               "b": np.zeros(4, np.float32)},
    }
    X = rng.standard_normal((8, 6)).astype(np.float32)
    y = rng.standard_normal((8, 4)).astype(np.float32)
    return dict(params=params, X=X, y=y, loss=("MSELoss", "mean"), v=_port_vector(params, 1))


def _inputs() -> dict:
    jac = _mlp("mlp_mse_mean", 10, rows=16)
    X, y = jac.pop("X"), jac.pop("y")
    jac["batches"] = [(X[:8], y[:8]), (X[8:], y[8:])]
    jac["w"] = np.random.default_rng(10).standard_normal((16, y.shape[1])).astype(np.float32)
    return {
        "ggn_matvec": _mlp("mlp_ce_mean", 1),
        "hessian_gradient_and_loss": _mlp("mlp_mse_mean", 2),
        "kfac_factors": _mlp("mlp_ce_mean", 3),
        "mesh_2d_sharded_params": _mlp("mlp_ce_mean", 4),
        "ekfac": _mlp("mlp_ce_mean", 5),
        "ggn_diagonal": _mlp("mlp_ce_mean", 6),
        "mesh_distributed_eigh": {"mats": _spd(0, [(None, 6), (None, 6), (3, 4), (5, 4)])},
        # float64: float32 sums over four slices differ from one slice's at
        # roundoff, which the eigendecomposition (the exact-damped inverse)
        # and MINRES on H + 0.5 I (eigenvalues from -0.62 to 3.3) carry past
        # the twins' absolute tolerance on small entries (4e-6 on -0.0116;
        # 1e-4 on a solution of norm 16, where the mesh-less port itself is
        # 1.7e-4 from float64)
        "kfac_exact_damped_inverse": _mlp("mlp_mse_mean", 0, dtype=np.float64),
        "kfoc": _mlp("mlp_ce_mean", 7),
        "minres_solve": _mlp("mlp_mse_mean", 3, dtype=np.float64),
        "held_linearization": _mlp("mlp_ce_mean", 4),
        "kfac_rank_inverse": _mlp("mlp_mse_mean", 0),
        "batched_randomized_eigh_across_mesh": {"mats": _decaying(9)},
        "shard_params_report": {"params": {
            "big": np.zeros((8, 1024), np.float32),
            "embed": np.zeros((1024, 50), np.float32),  # only the LEADING dim is eligible
            "square": np.zeros((64, 64), np.float32),  # tie -> trailing dim wins
            "indivisible": np.zeros((9, 1023), np.float32),
            "small": np.zeros((8, 8), np.float32),
            "vec": np.zeros((1024,), np.float32),
        }},
        "held_mesh_matches_single_device": _held_case(),
        "mc_ggn": {"cases": {
            "ce_ignore": _mlp("mlp_ce_mean", 8, ignore=(0, 1, 2)),
            "bce": _mlp("mlp_bce_mean", 8),
            "mse": _mlp("mlp_mse_sum", 8),
        }},
        "mc_kfac": _mlp("mlp_ce_mean", 12, ignore=(0, 5)),
        # the first process's slice (rows 0-1) is all ignored, the second's half
        "ce_ignore_index": _mlp("mlp_ce_mean", 9, ignore=(0, 1, 2)),
        "jacobians": jac,
        "uneven_batch": _mlp("mlp_ce_mean", 1, rows=6),
        "ggn_diagonal_mc": _mlp("mlp_ce_mean", 11),
        "fused_mesh": _mlp("mlp_ce_mean", 13, rows=36),
    }


# ---------------------------------------------------------------------- #
# the world
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def world(tmp_path_factory) -> dict:
    """Run the workers once; rank 0's results, with the inputs."""
    directory = tmp_path_factory.mktemp("gloo_world")
    inputs = _inputs()
    torch.save(inputs, directory / "inputs.pt")
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])}
    logs = [open(directory / f"rank{r}.log", "wb") for r in range(WORLD)]
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "tests.torch_parallel_worker", str(directory), str(r),
             str(WORLD)],
            cwd=ROOT, env=env, stdout=logs[r], stderr=subprocess.STDOUT,
        )
        for r in range(WORLD)
    ]
    deadline = time.monotonic() + WAIT
    while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
        time.sleep(0.2)
    hung = [r for r, p in enumerate(procs) if p.poll() is None]
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    for f in logs:
        f.close()
    results_file = directory / "results.pt"
    if hung or not results_file.exists():
        tails = "\n".join(
            f"--- rank {r}\n" + (directory / f"rank{r}.log").read_text()[-3000:]
            for r in range(WORLD)
        )
        pytest.fail(f"gloo world failed (ranks still running after {WAIT} s: {hung}):\n{tails}")
    return {"results": torch.load(results_file, weights_only=False), "inputs": inputs}


def _result(world: dict, name: str) -> dict:
    res = world["results"][name]
    assert "error" not in res, f"{name} raised in a worker:\n{res.get('error')}"
    return res


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, np.asarray(tree)


# ---------------------------------------------------------------------- #
# the mesh against the mesh-less port
# ---------------------------------------------------------------------- #
# each twin's tolerance in tests/test_parallel.py (the traps at its tightest)
MESH_TOLERANCES = {
    "ggn_matvec": (1e-5, 1e-6),
    "hessian_gradient_and_loss": (1e-5, 1e-7),
    "kfac_factors": (1e-5, 1e-6),
    "mesh_2d_sharded_params": (1e-5, 1e-6),
    "ekfac": (1e-4, 1e-6),
    "ggn_diagonal": (1e-5, 1e-7),
    "mesh_distributed_eigh": (1e-5, 1e-6),
    "kfac_exact_damped_inverse": (1e-4, 1e-6),
    "kfoc": (1e-4, 1e-6),
    "minres_solve": (1e-4, 1e-5),
    "held_linearization": (1e-5, 1e-6),
    "kfac_rank_inverse": (1e-3, 1e-5),
    "batched_randomized_eigh_across_mesh": (1e-3, 1e-5),
    "held_mesh_matches_single_device": (1e-5, 1e-6),
    "mc_ggn": (1e-5, 1e-6),
    "mc_kfac": (1e-5, 1e-6),
    "ce_ignore_index": (1e-5, 1e-6),
    "jacobians": (1e-5, 1e-6),
    "ggn_diagonal_mc": (1e-5, 1e-7),
    "flash_gpt_kfac": (1e-5, 1e-6),
    "fused_mesh": (1e-5, 1e-6),
}


@pytest.mark.parametrize("name", sorted(MESH_TOLERANCES))
def test_mesh_matches_single_process(world, name):
    """Each check's result on the 4-process mesh equals the mesh-less port's.

    ``atol`` is in units of the result's largest entry where that exceeds 1:
    the MC Fisher of a summed MSE reaches 37, and float32 sums over four
    slices differ from one slice's by 4e-6 there."""
    res = _result(world, name)
    rtol, atol = MESH_TOLERANCES[name]
    mesh, single = dict(_leaves(res["mesh"])), dict(_leaves(res["single"]))
    assert mesh.keys() == single.keys() and mesh
    for path, b in single.items():
        scale = max(1.0, float(np.abs(b).max())) if b.dtype.kind == "f" and b.size else 1.0
        report_nonclose(mesh[path], b, rtol=rtol, atol=atol * scale, name=f"{name}{path}")


def test_fused_mesh_modes(world):
    """Under the mesh the batches fuse with JAX's mode records; the
    mesh-less operators compared with them stream. A Neumann series over
    either keeps no program: it runs eagerly."""
    res = _result(world, "fused_mesh")
    assert res["modes"] == {
        "uniform/mesh": "scan", "uniform/single": None,
        "ragged/mesh": "unroll", "ragged/single": None,
    }
    assert not any(res["series_programs"].values()) and len(res["series_programs"]) == 4


def test_make_mesh_rejects_positional_axis_names(world):
    assert _result(world, "make_mesh_rejects_positional_axis_names")["raised"]


def test_make_mesh_accepts_numpy_int(world):
    assert _result(world, "make_mesh_accepts_numpy_int")["size"] == WORLD


def test_2d_mesh_places_dtensors(world):
    """``shard_params`` on the ``(2, 2)`` mesh returns ``DTensor``s, which the
    operator gathers (its matvec is in ``test_mesh_matches_single_process``)."""
    assert _result(world, "mesh_2d_sharded_params")["dtensors"] == 4


def test_shard_params_report(world):
    """JAX's ``test_shard_params_report`` on a 4-process ``"model"`` mesh."""
    res = _result(world, "shard_params_report")
    report = res["report"]
    sharded = {name: dim for name, _, dim in report["sharded"]}
    replicated = {name: reason for name, _, reason in report["replicated"]}
    assert sharded == {"['big']": 1, "['embed']": 0, "['square']": 1}
    assert "no dim divisible" in replicated["['indivisible']"]
    assert "min_size" in replicated["['small']"]
    assert "fewer than 2 dims" in replicated["['vec']"]
    assert res["local_shapes"]["big"] == [8, 256] and res["local_shapes"]["vec"] == [1024]


def test_mesh_utilities(world):
    """``replicate``, ``shard_batch``, a mesh-placed prefetch and a mesh of
    the wrong size on the 4-process world (rank 0's view)."""
    res = _result(world, "mesh_utilities")
    np.testing.assert_array_equal(res["replicated"]["a"], np.zeros(3))
    np.testing.assert_array_equal(res["replicated"]["b"][0], np.arange(4))
    X = np.repeat(np.arange(8.0)[:, None], 2, axis=1)
    np.testing.assert_array_equal(res["shards"], X)  # the slices, in process order
    np.testing.assert_array_equal(res["prefetched"], X[:2])
    assert res["wrong_size"] is not None and "world of 4" in res["wrong_size"]


def test_uneven_batch_raises(world):
    """A batch of 6 on 4 processes is refused, as JAX refuses it."""
    raised = _result(world, "uneven_batch")["raised"]
    assert raised is not None and "does not divide" in raised


def test_ce_ignore_index_slices_differ(world):
    """The trap case really has a different ignored count on each slice."""
    y = world["inputs"]["ce_ignore_index"]["y"]
    counts = [(y[2 * r:2 * r + 2] != -100).sum() for r in range(WORLD)]
    assert len(set(counts)) == 3 and 0 in counts


# ---------------------------------------------------------------------- #
# the mesh against JAX's mesh-less oracles
# ---------------------------------------------------------------------- #
def _jax_problem(inp: dict):
    from curvlinops_tpu import losses as jlosses

    def model_fn(p, x):  # the case's layers in order (mlp_fn reads layer0, layer1, ...)
        names = sorted(p)
        h = x
        for i, n in enumerate(names):
            h = h @ p[n]["W"] + p[n]["b"]
            if i < len(names) - 1:
                h = jnp.tanh(h)
        return h

    loss_cls, reduction = inp["loss"]
    params = jax.tree.map(jnp.asarray, inp["params"])
    batches = inp["batches"] if "batches" in inp else [(inp["X"], inp["y"])]
    data = [(jnp.asarray(X), jnp.asarray(y)) for X, y in batches]
    return model_fn, getattr(jlosses, loss_cls)(reduction), params, data


def _jax_op(cls, inp: dict, **kw):
    model_fn, loss_fn, params, data = _jax_problem(inp)
    return cls(model_fn, loss_fn, params, data, check_deterministic=False, **kw)


def _jax_matvec(A, v: dict) -> dict:
    """``A @ v`` as one ``jax.jit`` program, by the port's names."""
    return _to_port_layout(jax.jit(lambda u: A @ u)(_to_jax_layout(v)))


def _jax_ggn_matvec(inp):
    return _jax_matvec(_jax_op(JGGN, inp), inp["v"])


def _jax_gradient_and_loss(inp):
    g, loss = _jax_op(JHessian, inp).gradient_and_loss()
    return [_to_port_layout(g), np.asarray(loss)]


def _jax_kfac_factors(inp):
    """JAX's type-2 factors, by the parameter each group covers."""
    A = _jax_op(JKFAC, inp, fisher_type="type-2")
    name = {gi: jax_name(g.weight_path or g.bias_path) for gi, g in enumerate(A.groups)}
    return {"aaT": {name[gi]: np.asarray(t) for gi, t in A._aaT.items()},
            "ggT": {name[gi]: np.asarray(t) for gi, t in A._ggT.items()}}


def _jax_ekfac(inp):
    """JAX's EKFAC matvec (its eigenvalues are in the eigenbasis's order and
    signs, its operator is not)."""
    return {"mv": _jax_matvec(_jax_op(JEKFAC, inp, fisher_type="type-2"), inp["v"])}


def _jax_kfoc(inp):
    return _jax_matvec(_jax_op(JKFOC, inp, fisher_type="type-2"), inp["v"])


def _jax_exact_damped_inverse(inp):
    with jax.enable_x64(True):
        A = _jax_op(JKFAC, inp, fisher_type="type-2")
        return _jax_matvec(A.inverse(damping=0.1, use_exact_damping=True), inp["v"])


def _jax_minres(inp):
    with jax.enable_x64(True):
        H = _jax_op(JHessian, inp)
        shifted = H + 0.5 * JIdentity(H.in_spec)
        x = JMINRES(shifted, maxiter=400, tol=1e-9) @ _to_jax_layout(inp["v"])
        return _to_port_layout(x)


def _jax_jacobians(inp):
    model_fn, _, params, data = _jax_problem(inp)
    J = JJacobian(model_fn, params, data, check_deterministic=False)
    JT = JJacobianT(model_fn, params, data, check_deterministic=False)
    Jv = np.asarray(jax.jit(lambda u: J @ u)(_to_jax_layout(inp["v"])))
    JTw = _to_port_layout(jax.jit(lambda w: JT @ w)(jnp.asarray(inp["w"])))
    return {"Jv": Jv, "JTw": JTw, "held_Jv": Jv, "held_JTw": JTw}


def _jax_ce_ignore_index(inp):
    """The exact products and the gradient (the MC Fisher and the MC KFAC
    draw from the port's generator, which JAX cannot reproduce)."""
    G = _jax_op(JGGN, inp)
    g, loss = G.gradient_and_loss()
    return {"ggn": _jax_matvec(G, inp["v"]), "ef": _jax_matvec(_jax_op(JEF, inp), inp["v"]),
            "grad": _to_port_layout(g), "loss": np.asarray(loss)}


def _jax_ggn_diagonal(inp):
    return _to_port_layout(_jax_op(JGGNDiag, inp).diagonal)


def _jax_held_dense(inp):
    """JAX's dense GGN, permuted into the port's flat order."""
    A = _jax_op(JGGN, inp)
    dense = np.asarray(jax.jit(lambda M: A @ M)(jnp.eye(A.shape[1], dtype=A.dtype)))
    index = jax.tree.map(
        lambda p: np.zeros(np.shape(p)), jax.tree.map(jnp.asarray, inp["params"])
    )
    leaves, treedef = jax.tree.flatten(index)
    start, numbered = 0, []
    for leaf in leaves:
        numbered.append(np.arange(start, start + leaf.size, dtype=np.float64).reshape(leaf.shape))
        start += leaf.size
    port = _to_port_layout(jax.tree.unflatten(treedef, numbered))
    perm = np.concatenate([port[k].reshape(-1) for k in port]).astype(int)
    return dense[perm][:, perm]


# every deterministic check; the MC draws and the port's generator's rank
# route (mc_*, ggn_diagonal_mc, flash_gpt_kfac, kfac_rank_inverse,
# batched_randomized_eigh_across_mesh) have no JAX counterpart, and the
# sharded eigh is held against numpy below
JAX_ORACLES = {
    "ggn_matvec": _jax_ggn_matvec,
    "hessian_gradient_and_loss": _jax_gradient_and_loss,
    "kfac_factors": _jax_kfac_factors,
    "mesh_2d_sharded_params": _jax_ggn_matvec,
    "ekfac": _jax_ekfac,
    "ggn_diagonal": _jax_ggn_diagonal,
    "kfac_exact_damped_inverse": _jax_exact_damped_inverse,
    "kfoc": _jax_kfoc,
    "minres_solve": _jax_minres,
    "held_linearization": _jax_ggn_matvec,
    "held_mesh_matches_single_device": _jax_held_dense,
    "ce_ignore_index": _jax_ce_ignore_index,
    "jacobians": _jax_jacobians,
}


@pytest.mark.parametrize("name", sorted(JAX_ORACLES))
def test_mesh_matches_jax(world, name):
    """The mesh result and the mesh-less port's against the JAX package's
    mesh-less operator, on every leaf the oracle computes: a fault the two
    paths share shows here."""
    res = _result(world, name)
    expected = dict(_leaves(JAX_ORACLES[name](world["inputs"][name])))
    assert expected
    for which in ("mesh", "single"):
        got = dict(_leaves(res[which]))
        assert expected.keys() <= got.keys(), (which, sorted(expected), sorted(got))
        for path in expected:
            report_nonclose(got[path], expected[path], rtol=RTOL_JAX, atol=ATOL_JAX,
                            name=f"{name} {which}{path}")


def test_mesh_eigh_matches_numpy(world):
    """The sharded ``batched_eigh``'s eigenvalues against float64 numpy."""
    res = _result(world, "mesh_distributed_eigh")
    for k, m in world["inputs"]["mesh_distributed_eigh"]["mats"].items():
        expected = np.linalg.eigvalsh(m.astype(np.float64))
        report_nonclose(res["mesh"]["w"][k], expected, rtol=1e-5, atol=1e-5, name=f"w{k}")
