"""One process of the 4-process gloo world behind ``tests/test_torch_parallel.py``.

Imports torch and the port, never JAX. Run as::

    python -m tests.torch_parallel_worker DIR RANK WORLD [nccl]

Each process joins a gloo world through a ``FileStore`` in ``DIR`` (every
process group with a 60 s timeout), reads the numpy inputs the test module
wrote to ``DIR/inputs.pt``, and runs every check in :data:`CHECKS` on a
4-process ``"data"`` mesh (or the check's own mesh) and without a mesh.
Rank 0 saves ``{check: {"mesh": ..., "single": ...} or {"error": ...}}`` to
``DIR/results.pt``; the test module compares them against each other and
against JAX's oracles. With a fourth argument ``nccl`` it is instead one
process of the card tests' NCCL world (:func:`nccl_main`).
"""

from __future__ import annotations

import os
import sys
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from curvlinops_tpu_torch import (
    EFLinearOperator,
    EKFACLinearOperator,
    GGNDiagonalLinearOperator,
    GGNLinearOperator,
    HessianLinearOperator,
    IdentityLinearOperator,
    JacobianLinearOperator,
    KFACLinearOperator,
    KFOCLinearOperator,
    MINRESInverseLinearOperator,
    NeumannInverseLinearOperator,
    losses,
)
from curvlinops_tpu_torch.kfac.chain import batched_eigh
from curvlinops_tpu_torch.kfac.randomized import batched_randomized_eigh
from curvlinops_tpu_torch.parallel import make_mesh, shard_params

TIMEOUT = timedelta(seconds=60)
CHECKS: dict = {}


def check(fn):
    """Register a check ``fn(inputs, mesh) -> result``."""
    CHECKS[fn.__name__] = fn
    return fn


class MLP(nn.Module):
    """The JAX tests' tanh MLP ``x @ W + b`` (tanh between layers), from its
    numpy parameters ``{name: {"W": [in, out], "b": [out]}}`` in layer order;
    ``nn.Linear`` holds ``W^T``."""

    def __init__(self, jparams: dict):
        super().__init__()
        self.names = list(jparams)
        for name, p in jparams.items():
            layer = nn.Linear(*p["W"].shape, dtype=torch.from_numpy(p["W"]).dtype)
            with torch.no_grad():
                layer.weight.copy_(torch.from_numpy(np.ascontiguousarray(p["W"].T)))
                layer.bias.copy_(torch.from_numpy(np.array(p["b"])))
            setattr(self, name, layer)

    def forward(self, x):  # noqa: D102
        for i, name in enumerate(self.names):
            x = getattr(self, name)(x)
            if i < len(self.names) - 1:
                x = torch.tanh(x)
        return x


def tensors(tree):
    """numpy leaves of a dict/list tree as tensors."""
    if isinstance(tree, dict):
        return {k: tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tensors(v) for v in tree)
    return torch.from_numpy(np.asarray(tree)) if isinstance(tree, np.ndarray) else tree


def arrays(tree):
    """Tensor leaves of a dict/tuple tree as numpy."""
    if isinstance(tree, dict):
        return {k: arrays(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [arrays(v) for v in tree]
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) else tree


def problem(inp: dict) -> tuple:
    """``(model, loss_fn, params, data)`` of an MLP case."""
    model = MLP(inp["params"])
    loss_cls, reduction = inp["loss"]
    loss_fn = getattr(losses, loss_cls)(reduction)
    batches = inp["batches"] if "batches" in inp else [(inp["X"], inp["y"])]
    return model, loss_fn, dict(model.named_parameters()), tensors(batches)


def mesh_and_single(build, apply, mesh) -> dict:
    """``apply`` of the operator ``build(mesh)`` with and without the mesh."""
    return {"mesh": arrays(apply(build(mesh))), "single": arrays(apply(build(None)))}


def both(cls, inp, mesh, apply, **kw) -> dict:
    model, loss_fn, params, data = problem(inp)
    return mesh_and_single(
        lambda m: cls(model, loss_fn, params, data, mesh=m, check_deterministic=False, **kw),
        apply, mesh,
    )


# ---- twins of tests/test_parallel.py ---------------------------------- #
@check
def make_mesh_rejects_positional_axis_names(inp, mesh):
    try:
        make_mesh(("data",), device_type="cpu")
    except TypeError as err:
        return {"raised": "axis_names" in str(err)}
    return {"raised": False}


@check
def make_mesh_accepts_numpy_int(inp, mesh):
    m = make_mesh(np.int64(4), device_type="cpu")
    return {"size": m.size()}


@check
def ggn_matvec(inp, mesh):
    return both(GGNLinearOperator, inp, mesh, lambda A: A @ tensors(inp["v"]))


@check
def hessian_gradient_and_loss(inp, mesh):
    return both(HessianLinearOperator, inp, mesh, lambda A: A.gradient_and_loss())


def _factors(A):
    """The Kronecker factors by the parameter each group covers (the JAX
    package numbers its groups its own way)."""
    name = {gi: g.weight_path or g.bias_path for gi, g in enumerate(A.groups)}
    return {"aaT": {name[gi]: t for gi, t in A._aaT.items()},
            "ggT": {name[gi]: t for gi, t in A._ggT.items()}}


@check
def kfac_factors(inp, mesh):
    return both(KFACLinearOperator, inp, mesh, _factors, fisher_type="type-2")


@check
def mesh_2d_sharded_params(inp, mesh):
    mesh2d = make_mesh(4, axis_names=("data", "model"), shape=(2, 2), device_type="cpu")
    model, loss_fn, params, data = problem(inp)
    v = tensors(inp["v"])
    sharded = shard_params(params, mesh2d, min_size=2)
    op = GGNLinearOperator(model, loss_fn, sharded, data, mesh=mesh2d, check_deterministic=False)
    single = GGNLinearOperator(model, loss_fn, params, data, check_deterministic=False)
    return {"mesh": arrays(op @ v), "single": arrays(single @ v),
            "dtensors": sum(type(t).__name__ == "DTensor" for t in sharded.values())}


@check
def ekfac(inp, mesh):
    return both(EKFACLinearOperator, inp, mesh,
                lambda A: {"eigenvalues": A.corrected_eigenvalues, "mv": A @ tensors(inp["v"])},
                fisher_type="type-2")


@check
def ggn_diagonal(inp, mesh):
    return both(GGNDiagonalLinearOperator, inp, mesh, lambda A: A.diagonal)


@check
def mesh_distributed_eigh(inp, mesh):
    mats = tensors(inp["mats"])

    def rec(out):
        return {k: torch.einsum("...ij,...j,...kj->...ik", v, w, v) for k, (w, v) in out.items()}

    plain, sharded = batched_eigh(mats), batched_eigh(mats, mesh=mesh)
    return {"mesh": arrays({"w": {k: w for k, (w, _) in sharded.items()}, "rec": rec(sharded)}),
            "single": arrays({"w": {k: w for k, (w, _) in plain.items()}, "rec": rec(plain)})}


@check
def kfac_exact_damped_inverse(inp, mesh):
    return both(KFACLinearOperator, inp, mesh,
                lambda A: A.inverse(damping=0.1, use_exact_damping=True) @ tensors(inp["v"]),
                fisher_type="type-2")


@check
def kfoc(inp, mesh):
    return both(KFOCLinearOperator, inp, mesh, lambda A: A @ tensors(inp["v"]),
                fisher_type="type-2")


@check
def minres_solve(inp, mesh):
    def solve(H):
        shifted = H + IdentityLinearOperator(H.in_spec) * 0.5
        return MINRESInverseLinearOperator(shifted, maxiter=400, tol=1e-9) @ tensors(inp["v"])

    return both(HessianLinearOperator, inp, mesh, solve)


@check
def held_linearization(inp, mesh):
    return both(GGNLinearOperator, inp, mesh, lambda A: A.linearized() @ tensors(inp["v"]))


@check
def kfac_rank_inverse(inp, mesh):
    def apply(A):
        inv = A.inverse(damping=0.1, use_exact_damping=True, rank=6,
                        rank_key=torch.Generator().manual_seed(3))
        return inv @ tensors(inp["v"])

    return both(KFACLinearOperator, inp, mesh, apply, fisher_type="type-2")


@check
def batched_randomized_eigh_across_mesh(inp, mesh):
    mats = tensors(inp["mats"])

    def run(m):
        out = batched_randomized_eigh(mats, 8, torch.Generator().manual_seed(9), mesh=m)
        return {k: list(v) for k, v in out.items()}

    return {"mesh": arrays(run(mesh)), "single": arrays(run(None))}


# ---- twins of the one-mesh tests of test_case_matrix.py and test_held.py #
@check
def shard_params_report(inp, mesh):
    model_mesh = make_mesh(4, ("model",), (4,), device_type="cpu")
    report: dict = {}
    placed = shard_params(tensors(inp["params"]), model_mesh, min_size=16, report=report)
    shapes = {k: list(t.to_local().shape) for k, t in placed.items()}
    return {"report": report, "local_shapes": shapes}


@check
def held_mesh_matches_single_device(inp, mesh):
    model, loss_fn, params, data = problem(inp)
    op = GGNLinearOperator(model, loss_fn, params, data, check_deterministic=False)
    held = GGNLinearOperator(model, loss_fn, params, data, check_deterministic=False,
                             mesh=mesh).linearized()
    return {"mesh": held.todense().numpy(), "single": op.todense().numpy()}


# ---- the mesh utilities themselves ----------------------------------- #
@check
def mesh_utilities(inp, mesh):
    """``replicate`` broadcasts the first process's values, ``shard_batch``
    and ``PrefetchToDevice(device=mesh)`` give each process its slice, and
    a mesh of the wrong size names the world size."""
    from curvlinops_tpu_torch import PrefetchToDevice
    from curvlinops_tpu_torch.parallel import replicate, shard_batch

    rank = dist.get_rank()
    mine = {"a": torch.full((3,), float(rank)), "b": [torch.arange(4) + 10 * rank]}
    X = torch.arange(8.0)[:, None].repeat(1, 2)
    (pX,) = next(iter(PrefetchToDevice([(X,)], device=mesh)))
    try:
        make_mesh(3, device_type="cpu")
        wrong = None
    except ValueError as err:
        wrong = str(err)
    gathered = [torch.zeros(2, 2) for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, shard_batch(X, mesh))
    return {"replicated": arrays(replicate(mine, mesh)), "shards": arrays(torch.cat(gathered)),
            "prefetched": arrays(pX), "wrong_size": wrong}


# ---- the port's own traps --------------------------------------------- #
@check
def fused_mesh(inp, mesh):
    """The fused matmat and gradient (``"scan"`` over uniform batches,
    ``"unroll"`` over ragged ones) with the mesh, and the mesh-less
    streamed ones; with each operator's mode record. A Neumann series over
    ``G + I`` runs eagerly over both (neither is ``capturable``: the mesh's
    sum follows each product), so it holds no program."""
    model, loss_fn, params, (batch,) = problem(inp)
    X, y = batch
    v = tensors(inp["v"])
    splits = {"uniform": [12, 12, 12], "ragged": [8, 12, 16]}
    out = {"mesh": {}, "single": {}, "modes": {}, "series_programs": {}}
    for name, sizes in splits.items():
        data = list(zip(X.split(sizes), y.split(sizes)))
        for key, m in (("mesh", mesh), ("single", None)):
            G = GGNLinearOperator(model, loss_fn, params, data, mesh=m, check_deterministic=False)
            G.fuse_batches = "auto" if m is not None else False
            grad, loss = G.gradient_and_loss()
            inv = NeumannInverseLinearOperator(G + IdentityLinearOperator(G.in_spec),
                                               num_terms=8, scale=0.5)
            out[key][name] = arrays({"matvec": G @ v, "grad": grad, "loss": loss,
                                     "neumann": inv @ v})
            state = G._batch_fn_cache.get("fused_state")
            out["modes"][f"{name}/{key}"] = None if state is None else state[0]
            out["series_programs"][f"{name}/{key}"] = "_program_cache" in inv.__dict__
    return out


@check
def mc_ggn(inp, mesh):
    """Each MC loss's draws under the mesh are the mesh-less operator's."""
    out = {"mesh": {}, "single": {}}
    for name, case in inp["cases"].items():
        res = both(GGNLinearOperator, case, mesh, lambda A: A @ tensors(case["v"]),
                   mc_samples=3, seed=7)
        out["mesh"][name], out["single"][name] = res["mesh"], res["single"]
    return out


@check
def mc_kfac(inp, mesh):
    return both(KFACLinearOperator, inp, mesh, _factors, fisher_type="mc", mc_samples=2)


@check
def ce_ignore_index(inp, mesh):
    """Cross-entropy with ignore_index and a different ignored count on each
    process (all of the first slice ignored), with the determinism probes."""
    model, loss_fn, params, data = problem(inp)
    v = tensors(inp["v"])

    def run(m):
        kw = dict(mesh=m, check_deterministic=True)
        G = GGNLinearOperator(model, loss_fn, params, data, **kw)
        F = GGNLinearOperator(model, loss_fn, params, data, mc_samples=2, **kw)
        EF = EFLinearOperator(model, loss_fn, params, data, **kw)
        K = KFACLinearOperator(model, loss_fn, params, data, **kw)
        grad, loss = G.gradient_and_loss()
        return arrays({"ggn": G @ v, "mc": F @ v, "ef": EF @ v, "kfac": K @ v,
                       "grad": grad, "loss": loss})

    return {"mesh": run(mesh), "single": run(None)}


@check
def jacobians(inp, mesh):
    model, _, params, data = problem(inp)
    v, w = tensors(inp["v"]), tensors(inp["w"])

    def run(m):
        J = JacobianLinearOperator(model, params, data, mesh=m)
        held = J.linearized()
        return arrays({"Jv": J @ v, "JTw": J.T @ w, "held_Jv": held @ v,
                       "held_JTw": held.adjoint() @ w})

    return {"mesh": run(mesh), "single": run(None)}


@check
def uneven_batch(inp, mesh):
    model, loss_fn, params, data = problem(inp)
    try:
        GGNLinearOperator(model, loss_fn, params, data, mesh=mesh)
    except ValueError as err:
        return {"raised": str(err)}
    return {"raised": None}


@check
def ggn_diagonal_mc(inp, mesh):
    return both(GGNDiagonalLinearOperator, inp, mesh, lambda A: A.diagonal, mc_samples=2)


@check
def flash_gpt_kfac(inp, mesh):
    from curvlinops_tpu_torch.models.gpt import TINY_GPT, shakespeare_nanogpt

    p = shakespeare_nanogpt(batch_size=4, config=TINY_GPT, device="cpu", attention_impl="flash")

    def build(m):
        return KFACLinearOperator(p.model, p.loss_fn, p.kfac_params, p.data, mc_samples=1,
                                  check_deterministic=False, mesh=m)

    return mesh_and_single(build, _factors, mesh)


def main(directory: str, rank: int, world: int) -> None:
    torch.set_num_threads(1)
    # the groups a DeviceMesh creates for a sub-axis take c10d's default
    # timeout (30 minutes); bound them as the world group is bounded
    dist.distributed_c10d.default_pg_timeout = TIMEOUT
    store = dist.FileStore(os.path.join(directory, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world, timeout=TIMEOUT)
    mesh = make_mesh(device_type="cpu")
    inputs = torch.load(os.path.join(directory, "inputs.pt"), weights_only=False)
    results, seconds = {}, {}
    for name, fn in CHECKS.items():
        start = time.perf_counter()
        try:
            results[name] = fn(inputs.get(name, {}), mesh)
        except Exception:  # noqa: BLE001  (reported by the test of this check)
            results[name] = {"error": traceback.format_exc()}
        seconds[name] = time.perf_counter() - start
    results["seconds"] = seconds
    if rank == 0:
        torch.save(results, os.path.join(directory, "results.tmp"))
        os.replace(os.path.join(directory, "results.tmp"), os.path.join(directory, "results.pt"))
    dist.destroy_process_group()


def nccl_main(directory: str, rank: int, world: int) -> None:
    """The card test's world: one process per CUDA device (NCCL), the
    narrow ResNet's float64 GGN matvec with the mesh and without it; rank 0
    saves the relative error to ``DIR/results.pt``."""
    from curvlinops_tpu_torch.models.resnet import narrow_resnet_problem

    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    store = dist.FileStore(os.path.join(directory, "store"), world)
    dist.init_process_group("nccl", store=store, rank=rank, world_size=world, timeout=TIMEOUT)
    mesh = make_mesh()
    p = narrow_resnet_problem(device=dev)
    v = {n: torch.randn(t.shape, generator=torch.Generator().manual_seed(0),
                        dtype=t.dtype).to(dev) for n, t in p.params.items()}
    out = {}
    for m in (None, mesh):
        G = GGNLinearOperator(p.model, p.loss_fn, p.params, p.data, mesh=m)
        out["mesh" if m else "single"] = torch.cat([t.reshape(-1) for t in (G @ v).values()])
    err = float((out["mesh"] - out["single"]).norm() / out["single"].norm())
    if rank == 0:
        torch.save({"rel_err": err, "backend": str(dist.get_backend())},
                   os.path.join(directory, "results.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    run = nccl_main if sys.argv[4:] == ["nccl"] else main
    run(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
