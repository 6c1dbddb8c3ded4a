"""Random probe matrices for the stochastic estimators.

PyTorch counterpart of ``curvlinops_tpu/estimators/sampling.py``. Probes
come from an explicit ``torch.Generator`` (the JAX package threads
``jax.random`` keys). Without one, :func:`next_default_generator` seeds a
fresh generator from a per-process counter, so repeated estimator calls
draw fresh probes (as the JAX package's fold-in counter does) while each
process run stays reproducible; the global RNG is never touched.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

_DEFAULT_COUNTER = itertools.count()


def next_default_generator(
    generator: torch.Generator | None = None, device: torch.device | str = "cpu"
) -> torch.Generator:
    """``generator`` if given, else a new generator on ``device`` seeded from
    the next value of a per-process counter.

    A fixed default would make repeated calls perfectly correlated:
    ``mean([hutchinson_trace(A, 10) for _ in range(100)])`` would carry the
    variance of one draw.
    """
    if generator is not None:
        return generator
    seed = np.random.SeedSequence([0, next(_DEFAULT_COUNTER)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


def rademacher(generator: torch.Generator, shape: tuple, dtype=torch.float32) -> torch.Tensor:
    """+-1 entries with equal probability, on the generator's device."""
    bits = torch.randint(0, 2, shape, generator=generator, device=generator.device)
    return bits.to(dtype).mul_(2).sub_(1)


def normal(generator: torch.Generator, shape: tuple, dtype=torch.float32) -> torch.Tensor:
    """Standard normal entries, on the generator's device."""
    return torch.randn(shape, generator=generator, dtype=dtype, device=generator.device)


def random_matrix(
    generator: torch.Generator,
    dim: int,
    num_cols: int,
    distribution: str,
    dtype=torch.float32,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """``[dim, num_cols]`` of i.i.d. probes from the named distribution,
    drawn on the generator's device and moved to ``device`` (if given).

    Raises:
        ValueError: For an unknown distribution name.
    """
    if distribution == "rademacher":
        G = rademacher(generator, (dim, num_cols), dtype)
    elif distribution == "normal":
        G = normal(generator, (dim, num_cols), dtype)
    else:
        raise ValueError(
            f"Unknown distribution {distribution!r}; use 'rademacher' or 'normal'."
        )
    return G if device is None else G.to(device)


def operator_probes(
    A, generator: torch.Generator | None, dim: int, num_cols: int, distribution: str
) -> torch.Tensor:
    """Probes for ``A``: ``[dim, num_cols]`` in ``A``'s dtype on ``A``'s
    device, from ``generator`` (or the next default generator, made on
    ``A``'s device)."""
    gen = next_default_generator(generator, A.device)
    return random_matrix(gen, dim, num_cols, distribution, A.dtype, A.device)
