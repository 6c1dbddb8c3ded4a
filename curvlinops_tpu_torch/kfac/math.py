"""Weight-sharing-format math for KFAC factor computation.

PyTorch counterpart of ``curvlinops_tpu/kfac/math.py``. Every supported layer
is normalized to ``output[b, s] = W @ input[b, s] (+ bias)`` in the
weight-sharing format ``[batch, shared, features]``:

- linear inputs ``[B, *share, d_in]`` flatten their sharing dims (EXPAND) or
  average them (REDUCE);
- conv inputs (``[B, C, *spatial]``, one or two spatial axes) are unfolded
  to ``[B, prod(out), prod(K)*C]`` with the JAX package's kernel-offset-major,
  channel-minor ``(*K, C)`` feature order, so factors compare element for
  element with the JAX package's; the canonical conv weight
  ``[O, C, *K] -> [O, prod(K)*C]`` matches it. Dilated kernels take every
  ``d``-th element of a window; grouped convs average the input over the
  channel groups first (JAX's ``_group_average_channels``, exact when the
  input channels are replicated across groups). REDUCE needs only the
  location mean of the patches, which :func:`extract_averaged_patches`
  takes from strided slices of the input without the patch tensor;
- output gradients flatten (EXPAND) or sum (REDUCE) their sharing dims to
  ``[V, B, S, d_out]``.

Embedding lookups (``nn.Embedding``) are dense layers with one-hot inputs:
the canonical weight is the transposed table ``[C, V]``, the input
covariance is exactly diagonal (:func:`embedding_input_counts`), and EKFAC's
correction is a segment sum over token ids
(:func:`eigenvalue_correction_embedding`).

Covariance scalings follow the reference: ``aaT`` is divided by
``N_data * shared`` by the caller, ``ggT`` is multiplied by the loss
correction ``num_loss_terms^2 / (per_example_terms * N_data)`` for mean
reduction. :func:`eigenvalue_correction` holds EKFAC's corrected
eigenvalues.

Conv metadata (from :mod:`curvlinops_tpu_torch.kfac.collector`), one entry
per spatial axis: ``stride``, ``padding`` (``(lo, hi)`` pairs), ``kernel``,
``dilation``; ``C``, ``groups``, ``w_shape`` ``(O, C // groups, *K)`` (the
weight operand's), and for a function-level use the views from the weight
leaf to that operand (``w_views``).
"""

from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F

from curvlinops_tpu_torch.curvature.loss_hessian import KFACType


def canonical_conv_weight(W: torch.Tensor, meta: dict) -> torch.Tensor:
    """A conv weight leaf (with trailing column axes) to canonical
    ``[O, prod(K)*C, *cols]`` in ``(*K, C)`` order: the leaf's views replayed
    to the ``[O, C, *K]`` operand, then its channel axis moved last."""
    W = apply_weight_views(W, meta.get("w_views") or ())
    n = len(meta["w_shape"])
    Wp = W.permute(0, *range(2, n), 1, *range(n, W.ndim))
    return Wp.reshape(W.shape[0], -1, *W.shape[n:])


def canonical_conv_weight_inverse(W_canon: torch.Tensor, meta: dict) -> torch.Tensor:
    """Inverse of :func:`canonical_conv_weight` (back to the leaf layout)."""
    O, C, *K = meta["w_shape"]
    n, cols = len(meta["w_shape"]), W_canon.shape[2:]
    W = W_canon.reshape(O, *K, C, *cols)
    W = W.permute(0, n - 1, *range(1, n - 1), *range(n, n + len(cols)))
    return invert_weight_views(W, meta.get("w_views") or (), n)


def apply_weight_views(W: torch.Tensor, views) -> torch.Tensor:
    """Replay the views between a weight leaf and its layer operand
    (``("reshape", shape, in_shape)`` and ``("permute", dims, in_shape)``
    steps, as the collector records them); trailing axes beyond the leaf's
    (columns) ride along."""
    for kind, arg, in_shape in views:
        cols = W.shape[len(in_shape):]
        if kind == "reshape":
            W = W.reshape(*arg, *cols)
        elif kind == "permute":
            W = W.permute(*arg, *range(len(arg), W.ndim))
        else:
            raise ValueError(f"Non-invertible weight view {kind!r}.")
    return W


def invert_weight_views(W: torch.Tensor, views, leaf_ndim: int) -> torch.Tensor:
    """Inverse of :func:`apply_weight_views`; ``W`` holds the operand's
    layout in its first axes and columns after them."""
    ndim = len(views[-1][1]) if views else leaf_ndim
    for kind, arg, in_shape in reversed(views):
        cols = W.shape[ndim:]
        if kind == "reshape":
            W = W.reshape(*in_shape, *cols)
        elif kind == "permute":
            inv = [arg.index(d) for d in range(len(arg))]
            W = W.permute(*inv, *range(len(arg), W.ndim))
        else:
            raise ValueError(f"Non-invertible weight view {kind!r}.")
        ndim = len(in_shape)
    return W


def canonical_dense_weight(W: torch.Tensor, meta: dict) -> torch.Tensor:
    """A dense weight leaf (with trailing column axes) to canonical
    ``[d_out, d_in, *cols]``.

    A module's ``[out, in]`` weight (also a stacked ``[L, out, in]`` one) is
    already canonical. A function-level use replays its views to the
    operand and orders the operand's free axes before its contracted ones
    (``w_free + w_contract``): HuggingFace's ``[in, out]`` ``Conv1D`` weight
    and ``W.T`` land in the space of an ``nn.Linear`` weight.
    """
    if "w_free" not in meta:
        return W
    n = len(meta["w_leaf_shape"])
    cols = W.shape[n:]
    W = apply_weight_views(W, meta["w_views"])
    perm = meta["w_free"] + meta["w_contract"]
    W = W.permute(*perm, *range(len(perm), W.ndim))
    return W.reshape(meta["d_out"], meta["d_in"], *cols)


def canonical_dense_weight_inverse(W_canon: torch.Tensor, meta: dict) -> torch.Tensor:
    """Inverse of :func:`canonical_dense_weight` (back to the leaf layout)."""
    if "w_free" not in meta:
        return W_canon
    cols = W_canon.shape[2:]
    op_shape = meta["w_operand_shape"]
    perm = meta["w_free"] + meta["w_contract"]
    inv = [perm.index(d) for d in range(len(perm))]
    W = W_canon.reshape(*[op_shape[d] for d in perm], *cols)
    W = W.permute(*inv, *range(len(perm), W.ndim))
    return invert_weight_views(W, meta["w_views"], len(meta["w_leaf_shape"]))


def canonical_embedding_weight(W: torch.Tensor) -> torch.Tensor:
    """An embedding table ``[V, C, *cols]`` to canonical ``[C, V, *cols]``."""
    return W.transpose(0, 1)


def canonical_embedding_weight_inverse(W_canon: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`canonical_embedding_weight`."""
    return W_canon.transpose(0, 1)


def embedding_input_counts(idx: torch.Tensor, vocab: int, dtype: torch.dtype) -> torch.Tensor:
    """Exact diagonal input covariance of a lookup (un-normalized).

    One-hot inputs make ``aaT = sum_{b,s} onehot onehot^T`` exactly
    ``diag(token counts)``; no ``[V, V]`` matrix is formed (GPT-2's vocab
    would need 10 GiB). The counts are exact integers, returned in float32
    (float64 for a float64 ``dtype``), the factors' accumulation dtype.
    """
    counts = torch.bincount(idx.reshape(-1), minlength=vocab)
    return counts.to(torch.float64 if dtype == torch.float64 else torch.float32)


def conv_output_size(size: int, kernel: int, stride: int, pads: tuple, dilation: int = 1) -> int:
    """Output length of a zero-padded convolution along one dim."""
    return (size + pads[0] + pads[1] - dilation * (kernel - 1) - 1) // stride + 1


def _group_average_channels(x: torch.Tensor, meta: dict) -> torch.Tensor:
    """Average a ``[B, C, *spatial]`` input over channel groups (JAX's
    ``_group_average_channels``, the reference's grouped convolutions)."""
    groups = meta.get("groups", 1)
    if groups == 1:
        return x
    B, C = x.shape[0], x.shape[1]
    return x.reshape(B, groups, C // groups, *x.shape[2:]).mean(dim=1)


def _padded(x: torch.Tensor, meta: dict) -> torch.Tensor:
    """The group-averaged input, zero-padded: ``F.pad`` takes the last axis first."""
    pads = [p for lo_hi in reversed(meta["padding"]) for p in lo_hi]
    return F.pad(_group_average_channels(x, meta), pads)


def extract_conv_patches(x: torch.Tensor, meta: dict) -> torch.Tensor:
    """Unfold a ``[B, C, *spatial]`` conv input to ``[B, prod(out), prod(K)*C]``
    in ``(*K, C)`` order.

    The patches are a strided view of the zero-padded input
    (``Tensor.unfold`` over each dilated window, then every ``d``-th element),
    made contiguous in the canonical order by one copy (``F.unfold`` launches
    one im2col kernel per sample on CUDA).
    """
    x = _padded(x, meta)
    nd = len(meta["kernel"])
    dilation = meta.get("dilation", (1,) * nd)
    for i, (k, s, d) in enumerate(zip(meta["kernel"], meta["stride"], dilation)):
        x = x.unfold(2 + i, d * (k - 1) + 1, s)
        if d > 1:
            x = x[..., ::d]
    # [B, C, *out, *K] -> [B, *out, *K, C]
    out = x.shape[2 : 2 + nd]
    x = x.permute(0, *range(2, 2 + 2 * nd), 1)
    return x.reshape(x.shape[0], math.prod(out), -1)


def extract_averaged_patches(x: torch.Tensor, meta: dict) -> torch.Tensor:
    """Location-averaged conv patches ``[B, 1, prod(K)*C]`` without the
    ``[B, S, d_in]`` patch tensor.

    REDUCE needs only the per-sample mean over output locations of the
    unfolded input: for each kernel offset that is the mean of one strided
    slice of the zero-padded input. The JAX package's refusals (batch
    groups) and fallbacks (input dilation, negative padding) concern convs
    that ``F.conv1d``/``F.conv2d`` cannot express; a crop is an ``F.pad`` of
    the input before the call.
    """
    x = _padded(x, meta)
    kernel, strides = meta["kernel"], meta["stride"]
    nd = len(kernel)
    dilation = meta.get("dilation", (1,) * nd)
    B, C = x.shape[:2]
    out = [conv_output_size(n, k, s, (0, 0), d)
           for n, k, s, d in zip(x.shape[2:], kernel, strides, dilation)]
    means = []
    for offset in itertools.product(*(range(k) for k in kernel)):  # kernel-offset-major
        window = tuple(
            slice(o * d, o * d + (n - 1) * s + 1, s)
            for o, d, n, s in zip(offset, dilation, out, strides)
        )
        means.append(x[(slice(None), slice(None), *window)].mean(dim=tuple(range(2, 2 + nd))))
    return torch.stack(means, dim=1).reshape(B, 1, -1)


def input_to_sharing_format(
    x: torch.Tensor,
    kind: str,
    meta: dict,
    kfac_approx: str = KFACType.EXPAND,
    bias_pad: float | None = None,
) -> torch.Tensor:
    """One layer input to ``[B, S, d_in (+1)]``; REDUCE gives ``S = 1``.

    ``bias_pad`` appends a constant column (the joint weight+bias block).
    """
    reduce = KFACType(kfac_approx) == KFACType.REDUCE
    if kind == "conv" and reduce:
        a = extract_averaged_patches(x, meta)
    else:
        if kind == "conv":
            a = extract_conv_patches(x, meta)
        else:
            a = x.reshape(x.shape[0], -1, meta["d_in"])
        if reduce:
            a = a.mean(dim=1, keepdim=True)
    if bias_pad is not None:
        a = torch.cat([a, a.new_full((*a.shape[:-1], 1), bias_pad)], dim=-1)
    return a


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
        ``(cov [d(+1), d(+1)], S)`` in float32, or float64 for a float64
        input; bf16 inputs are multiplied in float32 (exact products) and
        accumulated in float32.
    """
    a = input_to_sharing_format(x, kind, meta, kfac_approx)
    B, S, d = a.shape
    a2 = _accumulation_dtype(a.reshape(B * S, d))
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
    """Layer-output gradients ``[V, B, *out]`` to ``[V, B, S, d_out]``;
    REDUCE sums the sharing dims (``S = 1``).

    Conv outputs are NCHW, so ``[V, B, O, Ho, Wo]`` moves its channels last.
    """
    V, B = g.shape[0], g.shape[1]
    if kind == "conv":
        g = g.movedim(2, -1)
        g = g.reshape(V, B, -1, g.shape[-1])
    else:
        g = g.reshape(V, B, -1, meta["d_out"])
    if KFACType(kfac_approx) == KFACType.REDUCE:
        g = g.sum(dim=2, keepdim=True)
    return g


def loss_correction(
    batch_size: int, num_per_example_loss_terms: int, reduction: str, n_data: int
) -> float:
    """Gradient-covariance correction for the loss reduction."""
    if reduction == "sum":
        return 1.0
    num_loss_terms = batch_size * num_per_example_loss_terms
    return num_loss_terms**2 / (num_per_example_loss_terms * n_data)


def _accumulation_dtype(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the dtype covariances accumulate in: float32, or float64 for
    a float64 tensor."""
    return t if t.dtype == torch.float64 else t.float()


def gradient_covariance(g: torch.Tensor, correction) -> torch.Tensor:
    """``ggT = correction * sum_{v,b,s} g g^T`` over ``[V, B, S, d]``, in
    float32 (float64 for a float64 ``g``)."""
    g2 = _accumulation_dtype(g.reshape(-1, g.shape[-1]))
    return correction * (g2.T @ g2)


def _batched_weight_grads_sq(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """``sum_{v,b} (left_vb^T right_b)^2`` for ``left [V, B, S, m]`` and
    ``right [B, S, n]``: the squared per-sample products, summed."""
    P = left.transpose(-1, -2) @ right  # [V, B, m, n], right broadcast over V
    return (P * P).sum(dim=(0, 1))


def eigenvalue_correction_embedding(
    g: torch.Tensor, Q_g: torch.Tensor, idx: torch.Tensor, vocab: int
) -> torch.Tensor:
    r"""EKFAC corrected eigenvalues of an embedding group.

    The diagonal input covariance's eigenbasis is the identity, so
    ``lam[d, v] = sum_{vec,n} ( sum_s (Q_g^T g_{vec,n,s})[d] 1[idx_{n,s} = v] )^2``:
    a per-sample segment sum over token ids (``index_add_`` into
    ``B * vocab`` segments) instead of a dense rotation.

    Args:
        g: ``[V_vec, B, S, D1]`` output gradients (KFAC-scaled).
        Q_g: ``[D1, D1]`` eigenvectors of the gradient covariance.
        idx: token ids ``[B, S]`` (the uses' ids concatenated along ``S``).
        vocab: vocabulary size (canonical input dim).

    Returns:
        ``[D1, vocab]`` correction.
    """
    Vv, B, S, D1 = g.shape
    rot = (g @ Q_g).movedim(0, 2).reshape(B * S, Vv * D1)  # rows (b, s)
    seg_ids = (idx.reshape(B, S) + vocab * torch.arange(B, device=idx.device)[:, None]).reshape(-1)
    seg = rot.new_zeros(B * vocab, Vv * D1).index_add_(0, seg_ids, rot)
    seg = seg.reshape(B, vocab, Vv, D1)
    return torch.einsum("bvad,bvad->dv", seg, seg)


def eigenvalue_correction(
    g: torch.Tensor,
    Q_g: torch.Tensor,
    a: torch.Tensor | None,
    Q_a: torch.Tensor | None,
    force_strategy: str | None = None,
) -> torch.Tensor:
    r"""EKFAC corrected eigenvalues ``sum_{v,n} (Q_g^T P_vn Q_a)^2``.

    ``P_vn = sum_s g_vns a_ns^T`` are per-sample weight gradients in sharing
    format. Two contraction orders with different peak memory, selected as
    in the reference: per-example gradients (``N*D1*D2``) or Gramians
    (``N*S^2*(D1+D2)``), the latter iff ``S^2 (D1 + D2) < D1 D2``. Every
    contraction is a pairwise product; per-example gradients rotate before
    or after the per-sample product, whichever costs fewer operations.

    Args:
        g: ``[V, B, S, D1]`` output gradients (KFAC-scaled).
        Q_g: ``[D1, D1]`` eigenvectors of the gradient covariance.
        a: ``[B, S, D2]`` inputs (with the bias column when joint), or
            ``None`` for a bias-only group.
        Q_a: ``[D2, D2]`` eigenvectors of the input covariance, or ``None``.
        force_strategy: ``'gramian'``, ``'per_example_gradients'`` or
            ``None`` (the rule above).

    Returns:
        ``[D1, D2]`` correction (``[D1]`` for the bias case).

    Raises:
        ValueError: For an unknown ``force_strategy`` or inconsistent
            ``a``/``Q_a``.
    """
    if force_strategy not in ("gramian", "per_example_gradients", None):
        raise ValueError(f"Invalid force_strategy: {force_strategy}.")
    if (a is None) != (Q_a is None):
        raise ValueError("a and Q_a must both be None or both be arrays.")
    if a is None:  # bias-only: P_vn = sum_s g_vns
        rot = g.sum(dim=2) @ Q_g  # [V, B, D1]
        return (rot * rot).sum(dim=(0, 1))

    S, D1, D2 = g.shape[2], Q_g.shape[0], Q_a.shape[0]
    if correction_strategy(S, D1, D2, force_strategy) == "gramian":
        a_rot = a @ Q_a  # [B, S, D2]
        g_rot = g @ Q_g  # [V, B, S, D1]
        B = a.shape[0]
        # lam[i, j] = sum_{b,s,t} (sum_v g_rot[vbsi] g_rot[vbti]) a_rot[bsj] a_rot[btj]
        g_gram = (g_rot[:, :, :, None, :] * g_rot[:, :, None, :, :]).sum(dim=0)
        a_gram = a_rot[:, :, None, :] * a_rot[:, None, :, :]  # [B, S, S, D2]
        return g_gram.reshape(B * S * S, D1).T @ a_gram.reshape(B * S * S, D2)
    if S * (D1 * D1 + D2 * D2) < D1 * D2 * (D1 + D2):
        # rotate the S rows first, then form the rotated per-sample products
        return _batched_weight_grads_sq(g @ Q_g, a @ Q_a)
    P = g.transpose(-1, -2) @ a  # [V, B, D1, D2]
    rotated = (Q_g.T @ P) @ Q_a
    return (rotated * rotated).sum(dim=(0, 1))


def correction_strategy(S: int, D1: int, D2: int, force_strategy: str | None = None) -> str:
    """EKFAC's contraction for sharing length ``S`` and factor dims ``D1``,
    ``D2``: ``'gramian'`` iff ``S^2 (D1 + D2) < D1 D2`` (less memory than
    the per-example gradients), unless forced."""
    if force_strategy is not None:
        return force_strategy
    return "gramian" if S * S * (D1 + D2) < D1 * D2 else "per_example_gradients"
