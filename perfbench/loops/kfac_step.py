"""KFAC-preconditioned training steps on fresh batches (a closed loop, one
caller).

Set-up makes the weights and a pool of batches on the device from the seed.
Step ``i`` takes batch ``i`` mod the pool and runs, in this order:

1. the gradient of the mean cross-entropy with respect to every parameter,
   by autograd through the program's model (span ``gradient``);
2. ``KFACLinearOperator(...)`` on that batch, the factor pass (span
   ``factor_pass``), with the traffic's Fisher type and weight-sharing
   treatment and the determinism probe off;
3. on every ``inverse_every``-th step (a refresh) the damped inverse of that
   step's factors (span ``inverse``);
4. the held inverse applied to the gradient of KFAC's parameters (span
   ``apply``).

The weights stay fixed, so every step does the same work. A cycle is
``inverse_every`` steps, the first a refresh. The check compares the last
cycle's refresh step and one more step of it, drawn from the seed, with the
plain reference: both gradients, both steps' factors, and both
preconditioned gradients (the second applies the refresh's inverse to a
later gradient).
"""

from __future__ import annotations

import random
import statistics

import torch


def setup(ctx) -> dict:
    """Weights, batches, the program's model, and one refresh step and one
    held step run as warm-up (every shape the window uses)."""
    from curvlinops_tpu_torch.losses import CrossEntropyLoss

    cfg, traffic = ctx.config, ctx.traffic
    with ctx.spans.setup("inputs"):
        # one batch more than the pool: the warm-up's, which the window never
        # takes, so no refresh of the window can repeat the warm-up's
        weights, batches = ctx.inputs(traffic["batches"] + 1)
    with ctx.spans.setup("model"):
        model = ctx.family.build_model(cfg, traffic, weights, ctx.device)
    params = dict(model.named_parameters())
    kfac_names = [n for layer in ctx.reference.kfac_layers(cfg) for n in layer if n]
    every = traffic["inverse_every"]
    state = dict(
        model=model, params=params, kfac_params={n: params[n] for n in kfac_names},
        loss_fn=CrossEntropyLoss("mean"), batches=batches[:-1], weights=weights, inverse=None,
        keep={}, kept=None, checked_offset=random.Random(ctx.seed).randrange(1, every),
    )
    with ctx.spans.setup("warm_up"):
        for i in range(2):
            unit(ctx, state, i, batches[-1])
    state["keep"], state["kept"] = {}, None
    return state


def cycle(ctx) -> int:
    """Steps a cycle: one refresh and the steps that hold its inverse."""
    return ctx.traffic["inverse_every"]


def unit(ctx, state: dict, i: int, batch: tuple | None = None) -> None:
    """Step ``i`` (see the module docstring) on ``batch``, by default the
    pool's batch ``i`` mod its size; ends in a synchronize."""
    from curvlinops_tpu_torch.kfac.operator import KFACLinearOperator

    traffic, spans = ctx.traffic, ctx.spans
    X, y = batch or state["batches"][i % len(state["batches"])]
    params = state["params"]
    with spans("gradient"):
        loss = state["loss_fn"](state["model"](X), y)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    with spans("factor_pass"):
        kfac = KFACLinearOperator(
            state["model"], state["loss_fn"], state["kfac_params"], [(X, y)],
            fisher_type=traffic["fisher_type"], kfac_approx=traffic["kfac_approx"],
            check_deterministic=False,
        )
    position = i % traffic["inverse_every"]
    if position == 0:
        with spans("inverse"):
            state["inverse"] = kfac.inverse(damping=traffic["damping"], use_heuristic_damping=True)
    with spans("apply"):
        step = state["inverse"] @ {n: grads[n] for n in state["kfac_params"]}
    ctx.synchronize()
    # the outputs of the cycle's refresh and of the drawn step are kept by
    # reference (no copy): the last whole cycle's are checked
    if position == 0:
        state["keep"] = {}
    if position in (0, state["checked_offset"]):
        state["keep"][position] = dict(batch=i % len(state["batches"]), gradient=grads,
                                       kfac=kfac, step=step)
        if len(state["keep"]) == 2:
            state["kept"] = state["keep"]


def end_to_end(ctx, unit_seconds: list, window_s: float) -> dict:
    """``kfac_step_ms`` (the window over its steps) and
    ``kfac_step_p90_ms`` (the 90th percentile of the steps' times)."""
    ms = [1e3 * s for s in unit_seconds]
    p90 = statistics.quantiles(ms, n=10, method="inclusive")[8] if len(ms) > 1 else ms[0]
    return {"kfac_step_ms": (1e3 * window_s / len(ms), "ms"), "kfac_step_p90_ms": (p90, "ms")}


def factors_by_param(kfac) -> dict:
    """The program's factors keyed as the reference's: ``{weight: (G, A),
    bias: (G,)}``."""
    state = kfac.state_dict()
    out = {}
    for gi, group in enumerate(kfac.groups):
        G = state["ggT"][str(gi)]
        if group.weight_path is not None:
            out[group.weight_path] = (G, state["aaT"][str(gi)])
        else:
            out[group.bias_path] = (G,)
    return out


def outputs(ctx, state: dict) -> dict:
    """What the check compares, taken from the program's kept steps; the
    program's model and operators are dropped from ``state``."""
    kept = state["kept"]
    if kept is None:
        raise RuntimeError("the window ended before a whole cycle")
    out = {
        pos: dict(batch=k["batch"], gradient=k["gradient"], factors=factors_by_param(k["kfac"]),
                  step=k["step"])
        for pos, k in kept.items()
    }
    for key in ("model", "params", "kfac_params", "inverse", "keep", "kept"):
        state.pop(key)
    return out


def reference_outputs(ctx, state: dict, program: dict, tf32: bool) -> dict:
    """The reference's outputs for the same steps (the refresh's inverse
    from the refresh's factors), in float32 or, for the control, TF32."""
    from perfbench.reference import curvature as rc

    cfg, ref = ctx.config, ctx.reference
    out, inverses = {}, None
    with rc.precision(tf32):
        for pos in sorted(program):
            X, y = state["batches"][program[pos]["batch"]]
            grad, factors = rc.step_outputs(ref, cfg, state["weights"], X, y)
            if pos == 0:
                inverses = rc.heuristic_inverse(factors, ctx.traffic["damping"])
            step = rc.apply_inverse(ref, inverses, grad)
            out[pos] = dict(batch=program[pos]["batch"], gradient=grad, factors=factors, step=step)
            del factors
    return out


def worst_leaf(a: dict, b: dict) -> float:
    """The worst leaf's gap ``||a - b||`` against the larger of the leaf's
    reference norm and the median leaf's (some leaves are all but zero)."""
    norms = {n: float(b[n].double().norm()) for n in b}
    floor = statistics.median(norms.values())
    return max(float((a[n].double() - b[n].double()).norm()) / max(norms[n], floor, 1e-30)
               for n in b)


def compare(ctx, got: dict, ref: dict) -> dict:
    """The gradient, factor and step gaps, each the worst over the checked
    steps."""
    grad = max(worst_leaf(got[p]["gradient"], ref[p]["gradient"]) for p in ref)
    step = max(worst_leaf(got[p]["step"], ref[p]["step"]) for p in ref)
    factor = 0.0
    for p in ref:
        for name, fs in ref[p]["factors"].items():
            for mine, theirs in zip(got[p]["factors"][name], fs):
                factor = max(factor, float((mine.double() - theirs.double()).norm()
                                           / theirs.double().norm()))
    return {"gradient_gap": grad, "factor_gap": factor, "step_gap": step}
