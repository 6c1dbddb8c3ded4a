"""Operations and bytes, from the configuration's shapes alone.

Nothing here looks at what the program launches, so a kernel's roofline
and a step's share of the peak read the same work whatever implements it.

The peaks and the three bounds (:func:`bound`, :func:`flash_bound`,
:func:`eigh_bound`) are copied from ``chip_smoke.py`` unchanged (bounds in
seconds here, milliseconds there): float32-accurate products at the card's
fastest float32-accurate rate, 3xTF32 (495 / 3 TFLOP/s, NVIDIA's H100 SXM
data sheet), and HBM at 3.35 TB/s.

The counts of whole steps are what the work needs, a lower bound on what any
implementation does: ``F`` is a forward pass (two operations a
multiply-add of every conv, dense layer, attention product and head),
a gradient is ``3 F`` (the forward, the input and the weight gradients),
the empirical Fisher's output gradients are the gradient's own (a step
needs no second pass for them), each symmetric covariance ``sum x x^T`` of
``R`` rows of width ``d`` is ``R d (d + 1)``, a damped Cholesky inverse of
an ``n x n`` factor is ``n^3`` (``n^3 / 3`` to factor, ``2 n^3 / 3`` to
invert), and a Kronecker-factored apply is two products per block. A GGN
product is ``4 F``: the tangent through every layer (``2 F``) and the
pullback (``2 F``), with the primal pass held.

A family's own shapes are counted by its module, ``reference/<family>.py``
(``kfac_shapes``, ``forward_flops``), found by the configuration's
``family``: a configuration of a new family adds that module and edits
nothing here.
"""

from __future__ import annotations

import importlib

PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 495e12 / 3, 3.35e12
PEAK_NAME = "3xTF32, 495/3 = 165 TFLOP/s; 3.35 TB/s"
FLOAT32_BYTES = 4


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time in seconds of float32 work at the published peaks, and
    what bounds it."""
    ops_s, bytes_s = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"


def flash_bound(kernel: str, B: int, H: int, T: int, hd: int, elem: int) -> tuple[float, str]:
    """Least time of one flash kernel at ``[B, H, T, hd]``: the causal
    products over the T (T + 1) / 2 visible (query, key) pairs of each head,
    2 hd flops each (forward: q k^T, P v; dkv: q k^T, dO v^T, P^T dO,
    dS^T q; dq: q k^T, dO v^T, dS k), against each input read once and each
    output written once (``[B, H, T, hd]`` tensors of ``elem`` bytes, float32
    row statistics lse and di)."""
    pairs = B * H * T * (T + 1) / 2
    tensor, rows = B * H * T * hd * elem, B * H * T * 4
    products, nbytes = {
        "fwd": (2, 4 * tensor + rows),  # q, k, v -> o, lse
        "bwd_dkv": (4, 6 * tensor + 2 * rows),  # q, k, v, dO, lse, di -> dk, dv
        "bwd_dq": (3, 5 * tensor + 2 * rows),  # q, k, v, dO, lse, di -> dq
    }[kernel]
    return bound(products * 2 * hd * pairs, nbytes)


def eigh_bound(n: int) -> tuple[float, str]:
    """Least time of a float32 ``[n, n]`` eigendecomposition with vectors:
    the bytes (A read, w and V written) against 9 n^3 flops (the symmetric
    QR algorithm with eigenvectors)."""
    return bound(9 * n**3, (2 * n * n + n) * FLOAT32_BYTES)


def conv_cov_bound(batch: int, conv: dict) -> tuple[float, str]:
    """Least time of one conv input's patch covariance ``sum a a^T``: the
    symmetric ``[d, d]`` output's d (d + 1) / 2 dot products over the
    ``B * Ho * Wo`` patch rows, against the input read once and the output
    written once."""
    d = conv["k"] * conv["k"] * conv["c_in"]
    out = -(-conv["hw"] // conv["s"])
    rows = batch * out * out
    nbytes = (batch * conv["c_in"] * conv["hw"] ** 2 + d * d) * FLOAT32_BYTES
    return bound(rows * d * (d + 1), nbytes)


def family(cfg: dict):
    """The configuration's family module, ``reference/<family>.py``: its
    ``kfac_shapes`` and ``forward_flops`` count its layers."""
    return importlib.import_module(f"perfbench.reference.{cfg['family']}")


def forward_flops(cfg: dict) -> float:
    """``F``: one forward pass of a batch."""
    return family(cfg).forward_flops(cfg)


def kfac_layers(cfg: dict) -> list[dict]:
    """The layers KFAC covers in a configuration: rows, input and output
    widths, bias."""
    return family(cfg).kfac_shapes(cfg)


def covariance_flops(cfg: dict) -> float:
    """Both factors of every KFAC layer (a bias shares its weight's ``G``)."""
    return sum(layer["rows"] * (layer["d_in"] * (layer["d_in"] + 1)
                                + layer["d_out"] * (layer["d_out"] + 1))
               for layer in kfac_layers(cfg))


def inverse_flops(cfg: dict) -> float:
    """The heuristically damped inverse: a Cholesky inverse of each factor
    (a bias block's ``G`` is damped apart, so it is inverted apart)."""
    return sum(layer["d_in"] ** 3 + layer["d_out"] ** 3 * (1 + layer["bias"])
               for layer in kfac_layers(cfg))


def apply_flops(cfg: dict) -> float:
    """``G^-1 grad A^-1`` of every weight and ``G^-1 grad`` of every bias."""
    return sum(2 * layer["d_out"] * layer["d_in"] * (layer["d_out"] + layer["d_in"])
               + 2 * layer["d_out"] ** 2 * layer["bias"]
               for layer in kfac_layers(cfg))


def kfac_step_flops(cfg: dict, traffic: dict) -> float:
    """One KFAC-preconditioned step, the refresh's inverse spread over the
    steps it serves."""
    return (3 * forward_flops(cfg) + covariance_flops(cfg)
            + inverse_flops(cfg) / traffic["inverse_every"] + apply_flops(cfg))


def ggn_product_flops(cfg: dict) -> float:
    """One damped-GGN product ``(G + lambda I) v``."""
    return 4 * forward_flops(cfg)
