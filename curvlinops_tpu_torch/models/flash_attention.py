"""Causal flash attention with hand-written Hopper kernels, forward and backward.

Counterpart of JAX's stock Pallas TPU flash attention
(``jax.experimental.pallas.ops.tpu.flash_attention``), which
``curvlinops_tpu/models/gpt.py`` calls for ``attention_impl="flash"``. Its
three Pallas kernels (forward, ``bwd_dkv``, ``bwd_dq``) are CUDA C++ for
``sm_90a`` here (``csrc/flash_attention.cu``; its header says what bounds
them and how they are laid out), compiled with ``nvcc`` at first use and
called through ``ctypes`` (:mod:`curvlinops_tpu_torch.utils.cuda_build`).
All three run their products on the tensor cores (``mma.sync`` TF32, each
float32 operand split into two TF32 parts, "3xTF32", and short tensor-core
sums added in float32, for float32 accuracy; the helpers are shared with
the conv kernel in ``../csrc/tf32_mma.cuh``), stream their tiles through a
two-stage ``cp.async`` ring, and keep ``P`` and ``dS`` in registers between
the two products of each tile. The forward splits each element once per CTA
(``q`` into registers, each streamed ``k`` and ``v`` tile into shared hi/lo
pairs).

:func:`flash_attention` is a ``torch.autograd.Function`` on the JAX layout
``[B, H, T, hd]``. Its forward returns ``o`` and keeps the per-row
logsumexp (float32) for the backward, which computes
``di = sum(o * dO, -1)`` in plain torch (as JAX does outside its kernels)
and launches the ``dkv`` and ``dq`` kernels. The backward is a second
Function with a ``vmap`` rule that folds the vmapped dimension into ``B``,
so a batched backward (``torch.func.vmap`` over ``torch.autograd.grad``, as
the KFAC factor pass runs for several grad-output vectors) launches each
kernel once; the forward has the same rule.

On a CPU tensor the Functions compute the plain versions
(:func:`flash_attention_plain`, :func:`flash_attention_bwd_plain`, which
calls :func:`flash_attention_bwd_dkv_plain` and
:func:`flash_attention_bwd_dq_plain`, one for each kernel); on a
CUDA tensor they launch the kernels or raise. Launches are counted in
:data:`launches` (``"fwd"``, ``"bwd_dkv"``, ``"bwd_dq"``).

Unlike the TPU kernel, whose default 128-row blocks need ``T % 128 == 0``,
the kernels take any ``T`` (the ragged tile is masked). They take float32
and bfloat16 with head dims 16, 32, 64 and 128, and accumulate in float32.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from curvlinops_tpu_torch.utils import cuda_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128)
launches = {"fwd": 0, "bwd_dkv": 0, "bwd_dq": 0}
"""Kernel launches so far, by kernel; a run sets them to 0 to count its own."""


def _bind(lib: ctypes.CDLL) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [I] * 5 + [F, P]  # is_bf16, B*H, T, hd, causal, sm_scale, stream
    for name, n_ptrs in (
        ("flash_attention_fwd", 5),
        ("flash_attention_bwd_dkv", 8),
        ("flash_attention_bwd_dq", 7),
    ):
        fn = getattr(lib, name)
        fn.argtypes = [P] * n_ptrs + tail
        fn.restype = ctypes.c_int


# ---------------------------------------------------------------------- #
# plain versions
# ---------------------------------------------------------------------- #
def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _scores(q, k, causal: bool, sm_scale: float) -> torch.Tensor:
    ct = _compute_dtype(q.dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), k.to(ct)) * sm_scale
    if causal:
        T_q, T_k = s.shape[-2:]
        mask = torch.ones((T_q, T_k), dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    return s


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, sm_scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward: einsum softmax with a causal mask.

    Returns:
        ``(o [B, H, T, hd] in q.dtype, lse [B, H, T])``, computed in float32
        (float64 for float64 inputs).
    """
    s = _scores(q, k, causal, sm_scale)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", torch.exp(s - lse[..., None]), v.to(s.dtype))
    return o.to(q.dtype), lse


def _probabilities(q, k, lse, causal: bool, sm_scale: float) -> torch.Tensor:
    s = _scores(q, k, causal, sm_scale)
    return torch.exp(s - lse.to(s.dtype)[..., None])  # masked entries: exp(-inf) = 0


def _ds(p, v, do, di) -> torch.Tensor:
    dp = torch.einsum("bhqd,bhkd->bhqk", do.to(p.dtype), v.to(p.dtype))
    return p * (dp - di.to(p.dtype)[..., None])


def flash_attention_bwd_dkv_plain(
    q, k, v, do, lse, di, *, causal: bool = True, sm_scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the ``dkv`` kernel: ``(dk, dv)`` from the forward's
    logsumexp ``lse`` and ``di = sum(o * dO, -1)`` (formulas at
    :func:`flash_attention_bwd_plain`)."""
    p = _probabilities(q, k, lse, causal, sm_scale)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.to(p.dtype))
    dk = torch.einsum("bhqk,bhqd->bhkd", _ds(p, v, do, di), q.to(p.dtype)) * sm_scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_plain(
    q, k, v, do, lse, di, *, causal: bool = True, sm_scale: float
) -> torch.Tensor:
    """Plain version of the ``dq`` kernel: ``dq`` from ``lse`` and ``di``."""
    p = _probabilities(q, k, lse, causal, sm_scale)
    dq = torch.einsum("bhqk,bhkd->bhqd", _ds(p, v, do, di), k.to(p.dtype)) * sm_scale
    return dq.to(q.dtype)


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward, by the explicit formulas::

        P = exp(sm_scale q k^T - lse),  dv = P^T dO,
        dS = P * (dO v^T - di),  di = sum(o * dO, -1),
        dq = sm_scale dS k,  dk = sm_scale dS^T q.

    Returns:
        ``(dq, dk, dv)`` in the inputs' dtype.
    """
    di = (o.to(_compute_dtype(o.dtype)) * do.to(_compute_dtype(do.dtype))).sum(-1)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, do, lse, di, causal=causal, sm_scale=sm_scale)
    dq = flash_attention_bwd_dq_plain(q, k, v, do, lse, di, causal=causal, sm_scale=sm_scale)
    return dq, dk, dv


# ---------------------------------------------------------------------- #
# kernel launches (CUDA tensors only)
# ---------------------------------------------------------------------- #
def _check_cuda(q: torch.Tensor, *others: torch.Tensor) -> tuple[int, int, int, int]:
    """Raise on what the kernels do not take; return ``(B, H, T, hd)``."""
    if q.device.type != "cuda":
        raise ValueError(f"Unsupported device {q.device}.")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"The kernels take float32 or bfloat16, got {q.dtype}.")
    if q.ndim != 4:
        raise ValueError(f"Expected [B, H, T, hd], got shape {tuple(q.shape)}.")
    for t in (q, *others):
        if t.device != q.device or t.dtype != q.dtype:
            raise TypeError("q, k, v (and o, dO) must share one device and dtype.")
        if t.shape != q.shape:
            raise ValueError(f"Shape {tuple(t.shape)} differs from q's {tuple(q.shape)}.")
        if not t.is_contiguous():
            raise ValueError("The kernels take contiguous [B, H, T, hd] tensors.")
        if t.data_ptr() % 16:
            raise ValueError("The kernels load 16-byte chunks: tensors must be 16-byte aligned.")
    B, H, T, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"Head dim {hd} is not one of {HEAD_DIMS}.")
    return B, H, T, hd


def _row_stats(t: torch.Tensor, shape: tuple) -> int:
    if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"Row statistics must be contiguous float32 {shape}.")
    return t.data_ptr()


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}.")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_fwd_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, sm_scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel: ``(o, lse)`` as :func:`flash_attention_plain`."""
    B, H, T, hd = _check_cuda(q, k, v)
    lib = cuda_build.load(SOURCE, _bind)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        int(q.dtype == torch.bfloat16), B * H, T, hd, int(causal), float(sm_scale), _stream(q),
    )
    _raise_on(err, "flash_attention_fwd")
    launches["fwd"] += 1
    return o, lse


def flash_attention_bwd_dkv_kernel(
    q, k, v, do, lse, di, *, causal: bool, sm_scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the ``dkv`` kernel: ``(dk, dv)``."""
    B, H, T, hd = _check_cuda(q, k, v, do)
    lib = cuda_build.load(SOURCE, _bind)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = lib.flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        _row_stats(lse, (B, H, T)), _row_stats(di, (B, H, T)), dk.data_ptr(), dv.data_ptr(),
        int(q.dtype == torch.bfloat16), B * H, T, hd, int(causal), float(sm_scale), _stream(q),
    )
    _raise_on(err, "flash_attention_bwd_dkv")
    launches["bwd_dkv"] += 1
    return dk, dv


def flash_attention_bwd_dq_kernel(
    q, k, v, do, lse, di, *, causal: bool, sm_scale: float
) -> torch.Tensor:
    """Launch the ``dq`` kernel: ``dq``."""
    B, H, T, hd = _check_cuda(q, k, v, do)
    lib = cuda_build.load(SOURCE, _bind)
    dq = torch.empty_like(q)
    err = lib.flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        _row_stats(lse, (B, H, T)), _row_stats(di, (B, H, T)), dq.data_ptr(),
        int(q.dtype == torch.bfloat16), B * H, T, hd, int(causal), float(sm_scale), _stream(q),
    )
    _raise_on(err, "flash_attention_bwd_dq")
    launches["bwd_dq"] += 1
    return dq


def flash_attention_fwd(q, k, v, *, causal: bool, sm_scale: float):
    """Forward ``(o, lse)``: the plain version on the CPU, the kernel on CUDA."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, sm_scale=sm_scale)
    return flash_attention_fwd_kernel(q, k, v, causal=causal, sm_scale=sm_scale)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool, sm_scale: float):
    """Backward ``(dq, dk, dv)``: the plain version on the CPU, the ``dkv``
    and ``dq`` kernels on CUDA."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, sm_scale=sm_scale)
    _check_cuda(q, k, v, o, do)
    di = (o.float() * do.float()).sum(-1)
    dk, dv = flash_attention_bwd_dkv_kernel(q, k, v, do, lse, di, causal=causal, sm_scale=sm_scale)
    dq = flash_attention_bwd_dq_kernel(q, k, v, do, lse, di, causal=causal, sm_scale=sm_scale)
    return dq, dk, dv


# ---------------------------------------------------------------------- #
# autograd
# ---------------------------------------------------------------------- #
def _fold(info, in_dims, tensors) -> list[torch.Tensor]:
    """Fold each tensor's vmapped dim (broadcast where it has none) into ``B``."""
    n = info.batch_size
    out = []
    for t, d in zip(tensors, in_dims):
        t = t.expand(n, *t.shape) if d is None else t.movedim(d, 0)
        out.append(t.reshape(n * t.shape[1], *t.shape[2:]).contiguous())
    return out


def _unfold(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.reshape(n, t.shape[0] // n, *t.shape[1:])


class _FlashAttentionBackward(torch.autograd.Function):
    """``(dq, dk, dv)`` of :class:`_FlashAttention`; not differentiable again."""

    @staticmethod
    def forward(q, k, v, o, lse, do, causal, sm_scale):  # noqa: D102
        return flash_attention_bwd(q, k, v, o, lse, do, causal=causal, sm_scale=sm_scale)

    @staticmethod
    def setup_context(ctx, inputs, output):  # noqa: D102
        pass

    @staticmethod
    def backward(ctx, *grads):  # noqa: D102
        raise NotImplementedError("Flash attention is differentiable once (reverse mode).")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, lse, do, causal, sm_scale):  # noqa: D102
        n = info.batch_size
        folded = _fold(info, in_dims, (q, k, v, o, lse, do))
        grads = _FlashAttentionBackward.apply(*folded, causal, sm_scale)
        return tuple(_unfold(g, n) for g in grads), (0, 0, 0)


class _FlashAttention(torch.autograd.Function):
    """``(o, lse)`` of causal attention; ``lse`` is not differentiable."""

    @staticmethod
    def forward(q, k, v, causal, sm_scale):  # noqa: D102
        return flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale)

    @staticmethod
    def setup_context(ctx, inputs, output):  # noqa: D102
        q, k, v, causal, sm_scale = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, do, _dlse):  # noqa: D102
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _FlashAttentionBackward.apply(
            q, k, v, o, lse, do.contiguous(), ctx.causal, ctx.sm_scale
        )
        return dq, dk, dv, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, sm_scale):  # noqa: D102
        n = info.batch_size
        o, lse = _FlashAttention.apply(*_fold(info, in_dims, (q, k, v)), causal, sm_scale)
        return (_unfold(o, n), _unfold(lse, n)), (0, 0)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, sm_scale: float
) -> torch.Tensor:
    """Causal attention ``softmax(sm_scale q k^T) v`` on ``[B, H, T, hd]``.

    Differentiable once, in reverse mode (like the JAX kernel's
    ``custom_vjp``). Inputs are made contiguous first.

    Raises:
        TypeError, ValueError: On a CUDA tensor the kernels do not take
            (dtype other than float32/bfloat16, shapes that differ, a head
            dim outside :data:`HEAD_DIMS`).
    """
    o, _ = _FlashAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), causal, float(sm_scale)
    )
    return o
