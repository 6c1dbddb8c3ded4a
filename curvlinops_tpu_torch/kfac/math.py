"""Weight-sharing-format math for KFAC factor computation (EXPAND).

PyTorch counterpart of ``curvlinops_tpu/kfac/math.py``. Every supported layer
is normalized to ``output[b, s] = W @ input[b, s] (+ bias)`` in the
weight-sharing format ``[batch, shared, features]``:

- linear inputs ``[B, *share, d_in]`` flatten their sharing dims;
- conv inputs (NCHW) are unfolded to ``[B, Ho*Wo, KH*KW*C]`` with the JAX
  package's kernel-offset-major, channel-minor ``(KH, KW, C)`` feature
  order, so factors compare element for element with the JAX package's; the
  canonical conv weight ``[O, C, KH, KW] -> [O, KH*KW*C]`` matches it;
- output gradients flatten their sharing dims to ``[V, B, S, d_out]``.

Covariance scalings follow the reference: ``aaT`` is divided by
``N_data * shared`` by the caller, ``ggT`` is multiplied by the loss
correction ``num_loss_terms^2 / (per_example_terms * N_data)`` for mean
reduction. Only ``KFACType.EXPAND`` is ported; REDUCE raises.

Conv metadata (from :mod:`curvlinops_tpu_torch.kfac.collector`): ``stride``
``(sh, sw)``, ``padding`` ``((lo_h, hi_h), (lo_w, hi_w))``, ``kernel``
``(kh, kw)``, ``C``, ``w_shape`` ``(O, C, kh, kw)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from curvlinops_tpu_torch.curvature.loss_hessian import KFACType


def _require_expand(kfac_approx) -> None:
    if KFACType(kfac_approx) != KFACType.EXPAND:
        raise NotImplementedError("kfac_approx='reduce' is not ported yet.")


def canonical_conv_weight(W: torch.Tensor) -> torch.Tensor:
    """``[O, C, KH, KW, *cols] -> [O, KH*KW*C, *cols]`` in (KH, KW, C) order."""
    rest = tuple(range(4, W.ndim))
    Wp = W.permute(0, 2, 3, 1, *rest)
    return Wp.reshape(W.shape[0], -1, *W.shape[4:])


def canonical_conv_weight_inverse(W_canon: torch.Tensor, meta: dict) -> torch.Tensor:
    """Inverse of :func:`canonical_conv_weight` (back to ``[O, C, KH, KW, *cols]``)."""
    O, C, KH, KW = meta["w_shape"]
    rest = tuple(range(4, W_canon.ndim + 2))
    return W_canon.reshape(O, KH, KW, C, *W_canon.shape[2:]).permute(0, 3, 1, 2, *rest)


def canonical_dense_weight(W: torch.Tensor) -> torch.Tensor:
    """A linear weight ``[out, in]`` is already canonical ``[d_out, d_in]``."""
    return W


def canonical_dense_weight_inverse(W_canon: torch.Tensor, meta: dict) -> torch.Tensor:
    """Inverse of :func:`canonical_dense_weight` (the identity)."""
    del meta
    return W_canon


def conv_output_size(size: int, kernel: int, stride: int, pads: tuple) -> int:
    """Output length of a zero-padded, undilated convolution along one dim."""
    return (size + pads[0] + pads[1] - kernel) // stride + 1


def extract_conv_patches(x: torch.Tensor, meta: dict) -> torch.Tensor:
    """Unfold an NCHW conv input to ``[B, Ho*Wo, KH*KW*C]`` in (KH, KW, C) order."""
    (ph0, ph1), (pw0, pw1) = meta["padding"]
    kh, kw = meta["kernel"]
    B, C = x.shape[0], x.shape[1]
    x = F.pad(x, (pw0, pw1, ph0, ph1))
    cols = F.unfold(x, (kh, kw), stride=meta["stride"])  # [B, C*kh*kw, S], (C, K) order
    S = cols.shape[-1]
    return cols.reshape(B, C, kh * kw, S).permute(0, 3, 2, 1).reshape(B, S, kh * kw * C)


def input_to_sharing_format(x: torch.Tensor, kind: str, meta: dict) -> torch.Tensor:
    """One layer input to ``[B, S, d_in]`` (EXPAND, no bias column)."""
    if kind == "conv":
        return extract_conv_patches(x, meta)
    return x.reshape(x.shape[0], -1, meta["d_in"])


def input_covariance(
    x: torch.Tensor,
    kind: str,
    meta: dict,
    kfac_approx: str,
    bias_pad: float | None = None,
) -> tuple[torch.Tensor, int]:
    """Input covariance ``sum_{b,s} a a^T`` and ``S``, without materializing
    the bias-padded input.

    The padded covariance has the closed block form::

        [[ sum a a^T,   p * colsum(a)],
         [ p*colsum^T,  p^2 * B * S  ]]

    Returns:
        ``(cov [d(+1), d(+1)] float32, S)``; bf16 inputs are multiplied in
        float32 (exact products) and accumulated in float32.
    """
    _require_expand(kfac_approx)
    a = input_to_sharing_format(x, kind, meta)
    B, S, d = a.shape
    a2 = a.reshape(B * S, d).float()
    cov = a2.T @ a2
    if bias_pad is None:
        return cov, S
    r = a2.sum(dim=0) * bias_pad
    corner = torch.full((1, 1), float(bias_pad) ** 2 * B * S, dtype=cov.dtype, device=cov.device)
    top = torch.cat([cov, r[:, None]], dim=1)
    bot = torch.cat([r[None, :], corner], dim=1)
    return torch.cat([top, bot], dim=0), S


def grad_to_sharing_format(
    g: torch.Tensor, kind: str, meta: dict, kfac_approx: str
) -> torch.Tensor:
    """Layer-output gradients ``[V, B, *out]`` to ``[V, B, S, d_out]``.

    Conv outputs are NCHW, so ``[V, B, O, Ho, Wo]`` moves its channels last.
    """
    _require_expand(kfac_approx)
    V, B = g.shape[0], g.shape[1]
    if kind == "conv":
        g = g.movedim(2, -1)
        return g.reshape(V, B, -1, g.shape[-1])
    return g.reshape(V, B, -1, meta["d_out"])


def loss_correction(
    batch_size: int, num_per_example_loss_terms: int, reduction: str, n_data: int
) -> float:
    """Gradient-covariance correction for the loss reduction."""
    if reduction == "sum":
        return 1.0
    num_loss_terms = batch_size * num_per_example_loss_terms
    return num_loss_terms**2 / (num_per_example_loss_terms * n_data)


def gradient_covariance(g: torch.Tensor, correction) -> torch.Tensor:
    """``ggT = correction * sum_{v,b,s} g g^T`` over ``[V, B, S, d]``, in float32."""
    g2 = g.reshape(-1, g.shape[-1]).float()
    return correction * (g2.T @ g2)
