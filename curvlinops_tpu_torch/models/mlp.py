"""MNIST-scale MLP problem.

PyTorch counterpart of ``curvlinops_tpu/models/mlp.py``: the
784-1024-512-256-128-64-10 ReLU MLP with cross-entropy, batch 512. The
model is functional, ``mlp_apply(params, x)``, on the JAX package's
parameter tree (``{"dense0": {"W": [d_in, d_out], "b": [d_out]}, ...}``), so
weights cross between the packages unchanged; the curvature operators take
it as a plain callable. KFAC's collector needs ``nn.Linear`` modules:
:func:`mlp_module` is the same network as one.
"""

from __future__ import annotations

import torch
from torch import nn

from curvlinops_tpu_torch.losses import CrossEntropyLoss
from curvlinops_tpu_torch.models.common import Problem, he_normal, resolve_device

SIZES = (784, 1024, 512, 256, 128, 64, 10)


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """ReLU MLP forward pass ``[N, 784] -> [N, 10]``."""
    n = len(params)
    for i in range(n):
        layer = params[f"dense{i}"]
        x = x @ layer["W"] + layer["b"]
        if i < n - 1:
            x = torch.relu(x)
    return x


class MLP(nn.Module):
    """:func:`mlp_apply` as ``nn.Linear`` layers ``dense0``, ``dense1``, ...
    with ReLU between them."""

    def __init__(self, sizes):
        super().__init__()
        self.n = len(sizes) - 1
        for i, (d_in, d_out) in enumerate(zip(sizes[:-1], sizes[1:])):
            setattr(self, f"dense{i}", nn.Linear(d_in, d_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # noqa: D102
        for i in range(self.n):
            x = getattr(self, f"dense{i}")(x)
            if i < self.n - 1:
                x = torch.relu(x)
        return x


def mlp_module(params: dict) -> MLP:
    """:class:`MLP` at ``params`` (``weight = W^T``), on ``W``'s device and
    dtype."""
    Ws = [params[f"dense{i}"]["W"] for i in range(len(params))]
    model = MLP([Ws[0].shape[0]] + [W.shape[1] for W in Ws]).to(Ws[0].device, Ws[0].dtype)
    with torch.no_grad():
        for i, W in enumerate(Ws):
            getattr(model, f"dense{i}").weight.copy_(W.T)
            getattr(model, f"dense{i}").bias.copy_(params[f"dense{i}"]["b"])
    return model


def init_mlp(
    generator: torch.Generator, sizes=SIZES, dtype=torch.float32, device="cuda"
) -> dict:
    """He-normal weights and zero biases, drawn on the CPU from ``generator``
    and moved to ``device`` (raises without a CUDA device unless the caller
    asks for the CPU)."""
    device = resolve_device(device)
    return {
        f"dense{i}": {
            "W": he_normal((d_in, d_out), d_in, generator, dtype).to(device),
            "b": torch.zeros(d_out, dtype=dtype, device=device),
        }
        for i, (d_in, d_out) in enumerate(zip(sizes[:-1], sizes[1:]))
    }


def mnist_mlp(
    batch_size: int = 512, seed: int = 0, dtype=torch.float32, device="cuda"
) -> Problem:
    """Synthetic-MNIST MLP problem (uniform pixels, random labels)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = init_mlp(gen, dtype=dtype, device=device)
    X = torch.rand((batch_size, SIZES[0]), generator=gen, dtype=dtype).to(device)
    y = torch.randint(0, SIZES[-1], (batch_size,), generator=gen).to(device)
    return Problem(
        "synthetic_mnist_mlp", mlp_apply, CrossEntropyLoss("mean"), params, [(X, y)]
    )


def tiny_mlp_problem(device="cuda") -> Problem:
    """The MLP at sizes 6-7-4 in float64 with cross-entropy, three batches
    of four standard-normal inputs from seed 1: He-normal weights, biases
    from ``N(0, 0.01)``."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(1)
    params = init_mlp(gen, sizes=(6, 7, 4), dtype=torch.float64, device="cpu")
    for layer in params.values():
        layer["b"] += 0.1 * torch.randn(layer["b"].shape, generator=gen, dtype=torch.float64)
    X = torch.randn((12, 6), generator=gen, dtype=torch.float64)
    y = torch.randint(0, 4, (12,), generator=gen)
    params = {k: {name: t.to(device) for name, t in v.items()} for k, v in params.items()}
    data = [(Xb.to(device), yb.to(device)) for Xb, yb in zip(X.chunk(3), y.chunk(3))]
    return Problem("tiny_mlp", mlp_apply, CrossEntropyLoss("mean"), params, data)
