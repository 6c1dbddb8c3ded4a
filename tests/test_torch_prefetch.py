"""The port's device-prefetching data pipeline (``utils/prefetch.py``) on the CPU.

Twins of ``tests/test_prefetch.py``: order-preserving and freshly
re-iterable, numpy leaves converted, placement on a ``torch.device`` or a
one-process CPU mesh, exceptions propagated, the producer stopped on early
exit, ``size < 1`` refused, and an operator's results unchanged by the
wrapper. The CUDA side (pinned copies on a side stream) is in
``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from curvlinops_tpu_torch import GGNLinearOperator, PrefetchToDevice, prefetch_to_device
from curvlinops_tpu_torch.losses import CrossEntropyLoss
from curvlinops_tpu_torch.parallel import make_mesh
from tests.test_torch_helpers import capped_torch_threads

_threads = capped_torch_threads()
CPU = torch.device("cpu")


def _batches(n=4, batch=8, d_in=5, n_cls=3, seed=0):
    rng = np.random.default_rng(seed)
    return [
        (torch.from_numpy(rng.normal(size=(batch, d_in)).astype(np.float32)),
         torch.from_numpy(rng.integers(0, n_cls, size=(batch,))))
        for _ in range(n)
    ]


def _producers() -> list:
    return [t for t in threading.enumerate() if t.name == "PrefetchToDevice"]


def test_order_preserved_and_reiterable():
    data = _batches()
    pf = PrefetchToDevice(data, size=2, device=CPU)
    for _ in range(2):  # two full passes, like the operators do
        got = list(pf)
        assert len(got) == len(data)
        for (gX, gy), (eX, ey) in zip(got, data):
            assert torch.equal(gX, eX) and torch.equal(gy, ey)


def test_leaves_are_on_device():
    (X, y), *_ = list(PrefetchToDevice(_batches(n=1), device="cpu"))
    assert isinstance(X, torch.Tensor) and X.device == CPU and y.device == CPU


def test_numpy_batches_are_converted():
    data = [(np.ones((2, 3), np.float32), np.zeros((2,), np.int32))]
    (X, y), *_ = list(PrefetchToDevice(data, device=CPU))
    assert isinstance(X, torch.Tensor) and isinstance(y, torch.Tensor)
    assert torch.equal(X, torch.ones(2, 3))


@pytest.fixture
def one_process_mesh():
    """A one-process CPU mesh; its process group is taken down afterwards
    if this test made it."""
    ours = not dist.is_initialized()
    yield make_mesh(device_type="cpu")
    if ours:
        dist.destroy_process_group()


def test_sharding_applied(one_process_mesh):
    """A ``torch.device`` places batches whole; a mesh places this
    process's slice (all of it on a one-process mesh)."""
    data = [(np.ones((8, 3), np.float32), np.zeros((8,), np.int32))]
    for device in (torch.device("cpu"), one_process_mesh):
        (X, y), *_ = list(PrefetchToDevice(data, device=device))
        assert X.device == CPU and tuple(X.shape) == (8, 3) and tuple(y.shape) == (8,)


def test_exception_propagates():
    def bad_iter():
        yield (torch.ones((2, 2)), torch.zeros((2,), dtype=torch.int32))
        raise RuntimeError("boom in the data pipeline")

    class BadIterable:
        def __iter__(self):
            return bad_iter()

    it = iter(PrefetchToDevice(BadIterable(), size=1, device=CPU))
    next(it)
    with pytest.raises(RuntimeError, match="boom in the data pipeline"):
        for _ in it:
            pass


def test_early_exit_stops_producer():
    produced = []

    def slow_iter():
        for i in range(100):
            produced.append(i)
            yield (torch.full((2,), i), torch.zeros((2,), dtype=torch.int32))

    class Slow:
        def __iter__(self):
            return slow_iter()

    it = iter(PrefetchToDevice(Slow(), size=2, device=CPU))
    next(it)
    it.close()  # consumer abandons the iterator
    for thread in _producers():
        thread.join(timeout=5.0)
    assert not _producers(), "producer kept running after consumer exit"
    n = len(produced)
    time.sleep(0.2)
    assert len(produced) == n < 100


def test_bad_size_rejected():
    with pytest.raises(ValueError, match="size"):
        PrefetchToDevice([], size=0, device=CPU)


def test_operator_results_identical_with_prefetch():
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(5, 7), torch.nn.Tanh(), torch.nn.Linear(7, 3))
    params = dict(model.named_parameters())
    data = _batches(n=3)
    G_plain = GGNLinearOperator(model, CrossEntropyLoss(), params, data)
    G_pref = GGNLinearOperator(
        model, CrossEntropyLoss(), params, prefetch_to_device(data, size=2, device=CPU)
    )
    v = {n: torch.from_numpy(np.random.default_rng(1).normal(size=p.shape).astype(np.float32))
         for n, p in params.items()}
    out_plain, out_pref = G_plain @ v, G_pref @ v
    for n in out_plain:
        np.testing.assert_allclose(out_pref[n].numpy(), out_plain[n].numpy(), rtol=1e-6)
