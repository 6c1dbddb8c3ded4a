"""Damped-Newton or influence-function solves: conjugate gradients on
``G + lambda I``, ``G`` the exact GGN of the mean cross-entropy over every
parameter and one resident batch (a closed loop, one caller).

Set-up makes the weights, the batch and a pool of right-hand sides on the
device from the seed, builds ``GGNLinearOperator`` (determinism
probe off, the batch fused into the operator's captured program), wraps
``G + lambda I`` in ``CGInverseLinearOperator`` with a fixed iteration count
and a zero tolerance, and runs the first solve (span ``first_solve``: the
warm-up, the capture of the chunked loop and its first replays). Solve ``i``
of the window takes right-hand side ``i`` mod the pool (span ``solve``). The
check runs the reference's CG on the last solve's right-hand side and
compares the final iterates and the residual norms of the solve's first
half.

The traffic's ``rhs`` says what the right-hand sides are: ``"gaussian"``,
standard normal vectors, or ``"gradient"``, the gradients of the mean loss
on further batches drawn from the seed (computed by the plain reference, as
an influence-function or Newton solve takes them), which lie in the GGN's
range where a Gaussian vector barely touches it.
"""

from __future__ import annotations

import torch


def setup(ctx) -> dict:
    """Weights, the batch, the right-hand sides, the operators and the
    first solve."""
    from curvlinops_tpu_torch import CGInverseLinearOperator, GGNLinearOperator
    from curvlinops_tpu_torch.losses import CrossEntropyLoss
    from curvlinops_tpu_torch.ops.dense import IdentityLinearOperator

    cfg, traffic = ctx.config, ctx.traffic
    with ctx.spans.setup("inputs"):
        n = traffic["right_hand_sides"]
        gradients = traffic["rhs"] == "gradient"
        weights, data = ctx.inputs(1 + n if gradients else 1)
        batch = data[0]
        if gradients:
            from perfbench.reference.curvature import gradient

            rhs = [gradient(ctx.reference, cfg, weights, X, y) for X, y in data[1:]]
        else:
            shapes = {k: t.shape for k, t in weights.items()}
            flat = torch.randn((n, sum(s.numel() for s in shapes.values())),
                               generator=ctx.generator, dtype=next(iter(weights.values())).dtype,
                               device=ctx.device)
            rhs = [dict(zip(shapes, (p.view(s) for p, s in zip(
                torch.split(row, [s.numel() for s in shapes.values()]), shapes.values()))))
                for row in flat]
        del data
    with ctx.spans.setup("model"):
        model = ctx.family.build_model(cfg, traffic, weights, ctx.device)
    params = dict(model.named_parameters())
    rhs = [{n: r[n] for n in params} for r in rhs]  # the operator's order of leaves
    G = GGNLinearOperator(model, CrossEntropyLoss("mean"), params, [batch],
                          check_deterministic=False)
    A = G + traffic["damping"] * IdentityLinearOperator(G.in_spec)
    solver = CGInverseLinearOperator(A, maxiter=traffic["iterations"], tol=0.0, atol=0.0)
    state = dict(model=model, solver=solver, rhs=rhs, batch=batch, weights=weights, last=None)
    with ctx.spans.setup("first_solve"):
        solver @ rhs[0]
    return state


def cycle(ctx) -> int:
    """Solves a cycle."""
    return 1


def unit(ctx, state: dict, i: int) -> None:
    """Solve ``i``; ends in a synchronize."""
    with ctx.spans("solve"):
        x = state["solver"] @ state["rhs"][i % len(state["rhs"])]
    ctx.synchronize()
    state["last"] = (i % len(state["rhs"]), x)


def end_to_end(ctx, unit_seconds: list, window_s: float) -> dict:
    """``solve_iter_ms``: the window over every iteration of its solves."""
    return {"solve_iter_ms": (1e3 * window_s / (len(unit_seconds) * ctx.traffic["iterations"]),
                              "ms")}


def outputs(ctx, state: dict) -> dict:
    """The last solve's right-hand side and final iterate; the program's
    model and operators are dropped from ``state``."""
    index, x = state["last"]
    info = state["solver"].last_info
    for key in ("model", "solver", "last"):
        state.pop(key)
    return dict(rhs=index, x=x, iterations=int(info["iterations"]),
                residuals=info["residual_history"][:, 0])


def reference_outputs(ctx, state: dict, program: dict, tf32: bool) -> dict:
    """The reference's CG iterate on the same right-hand side, in float32
    or, for the control, TF32."""
    from perfbench.reference import curvature as rc

    cfg, ref, traffic = ctx.config, ctx.reference, ctx.traffic
    X, y = state["batch"]
    weights, lam = state["weights"], traffic["damping"]

    def damped(v):
        Gv = rc.ggn_product(ref, cfg, weights, X, y, v)
        return {n: Gv[n] + lam * v[n] for n in v}

    with rc.precision(tf32):
        x, residuals = rc.cg(damped, state["rhs"][program["rhs"]], traffic["iterations"])
    return dict(rhs=program["rhs"], x=x, iterations=traffic["iterations"], residuals=residuals)


def compare(ctx, got: dict, ref: dict) -> dict:
    """The relative gap of the final iterates over all parameters; the worst
    relative gap of the residual norms after each iteration of the solve's
    first half, which round-off does not yet drive apart (float32 CG
    amplifies the products' last bits over the later iterations); and the
    iterations the program ran short of the traffic's count."""
    num = sum(float((got["x"][n].double() - ref["x"][n].double()).norm()) ** 2 for n in ref["x"])
    den = sum(float(ref["x"][n].double().norm()) ** 2 for n in ref["x"])
    half = ref["iterations"] // 2 + 1
    mine, theirs = got["residuals"][1:half].double(), ref["residuals"][1:half].double()
    return {"iterate_gap": (num / den) ** 0.5,
            "residual_gap": float(((mine - theirs.to(mine.device)).abs() / theirs).max()),
            "iterations_missing": float(ref["iterations"] - got["iterations"])}
