"""The check catches a broken timed path: each cell driven through the
harness on the CPU at a tiny size (the look for a chip skipped), sound and
then with one fault planted in the program underneath, against the cell's
own limits. A sound run comes out correct and every fault comes out not
correct: a step that leaves its state unchanged, half of the batch left out
(the mean taken over the rest), and an answer altered where it is
produced. (No cell spans chips, so there is no exchange to leave out.)"""

import time

import pytest
from tiny import CELLS

from perfbench import harness


def run(cell: str, trace: bool = False) -> dict:
    result, _ = harness.run_cell(harness.manifest(), cell, 2**31 + 11, 0.3, trace, "cpu",
                                 time.perf_counter(), config=CELLS[cell])
    return result


def half(data):
    (X, y), = data
    return [(X[: X.shape[0] // 2], y[: y.shape[0] // 2])]


def negate_first_leaf(tree: dict) -> dict:
    first = next(iter(tree))
    return {n: -t if n == first else t for n, t in tree.items()}


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell, trace):
    result = run(cell, trace)
    assert result["correct"], result["checks"]
    kind = "per_layer" if trace else "end_to_end"
    reported = {m["name"]: m for m in harness.cell_metrics(harness.manifest(), kind, cell)}
    assert set(result["metrics"]) <= set(reported)
    # without a card only the spans have something to read: a device trace
    # and a share of the card's peak are left out, never read as 0
    spans = {n for n, m in reported.items() if m["source"] == "host_clock" and "mfu" not in n}
    assert spans <= set(result["metrics"])


def kfac_fault(monkeypatch, fault: str) -> None:
    from curvlinops_tpu_torch.kfac.operator import KFACLinearOperator

    if fault == "state_unchanged":  # every refresh hands back the first inverse
        first = {}
        original = KFACLinearOperator.inverse

        def inverse(self, *args, **kwargs):
            return first.setdefault("inverse", original(self, *args, **kwargs))

        monkeypatch.setattr(KFACLinearOperator, "inverse", inverse)
    elif fault == "half_batch":
        original = KFACLinearOperator.__init__

        def init(self, model, loss_fn, params, data, **kwargs):
            original(self, model, loss_fn, params, half(data), **kwargs)

        monkeypatch.setattr(KFACLinearOperator, "__init__", init)
    else:  # the preconditioned gradient's first leaf negated
        original = KFACLinearOperator.inverse

        class Altered:
            def __init__(self, op):
                self.op = op

            def __matmul__(self, v):
                return negate_first_leaf(self.op @ v)

        monkeypatch.setattr(KFACLinearOperator, "inverse",
                            lambda self, *a, **k: Altered(original(self, *a, **k)))


def cg_fault(monkeypatch, fault: str) -> None:
    from curvlinops_tpu_torch import CGInverseLinearOperator, GGNLinearOperator
    from curvlinops_tpu_torch.solvers import cg

    if fault == "state_unchanged":  # every CG step returns the state it was given
        original = cg.cg_step

        def cg_step(mv, mp):
            step = original(mv, mp)

            def unchanged(k, state, consts):
                return state, step(k, state, consts)[1]

            return unchanged

        monkeypatch.setattr(cg, "cg_step", cg_step)
    elif fault == "half_batch":
        original = GGNLinearOperator.__init__

        def init(self, model, loss_fn, params, data, **kwargs):
            original(self, model, loss_fn, params, half(data), **kwargs)

        monkeypatch.setattr(GGNLinearOperator, "__init__", init)
    else:  # the solution's first leaf negated
        original = CGInverseLinearOperator._matmat
        monkeypatch.setattr(CGInverseLinearOperator, "_matmat",
                            lambda self, M: negate_first_leaf(original(self, M)))


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    (kfac_fault if "kfac" in cell else cg_fault)(monkeypatch, fault)
    result = run(cell)
    assert not result["correct"], result["checks"]
