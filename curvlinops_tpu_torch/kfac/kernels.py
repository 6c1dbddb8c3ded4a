"""Hand-written Hopper kernel for the KFAC conv input covariance.

Counterpart of ``curvlinops_tpu/kfac/pallas_kernels.py``: the fused implicit
im2col plus the unnormalized input covariance ``sum_{b,s} a a^T`` of a 2-D
convolution, which never materializes the ``[B, Ho*Wo, KH*KW*C]`` patch
tensor. The kernel is CUDA C++ for ``sm_90a``
(``csrc/conv_input_covariance.cu``; its header says what bounds it and how it
is laid out), running its products on the TF32 tensor cores with the 3xTF32
split for float32 accuracy, compiled with ``nvcc`` into a shared library at
first use and called through ``ctypes``
(:mod:`curvlinops_tpu_torch.utils.cuda_build`).

:func:`conv_input_covariance` launches the kernel for a CUDA tensor and
raises on anything it does not take; for a CPU tensor it computes
:func:`conv_input_covariance_plain` (``F.pad`` + ``unfold``, a reorder to
(KH, KW, C) and a matmul). It counts its launches in
``conv_input_covariance.launches``.

The JAX kernel's VMEM bound ``d <= 1200`` does not apply: the accumulator
lives in device memory, so the gate keeps only the geometry conditions.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from curvlinops_tpu_torch.curvature.loss_hessian import KFACType
from curvlinops_tpu_torch.kfac import math as kmath
from curvlinops_tpu_torch.utils import cuda_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "conv_input_covariance.cu"
_TILE = 64  # output tile edge of the kernel
_BK = 32  # rows per slab of the kernel (one short tensor-core sum)
_CTAS_PER_SM = 3  # resident CTAs of the kernel per SM (its shared memory allows three)
_MIN_ROWS_PER_SPLIT = 512
_MAX_SPLITS = 16


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.conv_input_covariance
    fn.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 14
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int


def _geometry(x_shape: tuple, meta: dict) -> dict | None:
    """Static conv geometry of an NCHW input; ``None`` if the kernel cannot
    express it (dilation, groups, negative padding)."""
    if len(x_shape) != 4 or meta.get("dilation", (1, 1)) != (1, 1):
        return None
    if meta.get("groups", 1) != 1:
        return None
    (ph0, ph1), (pw0, pw1) = meta["padding"]
    if min(ph0, ph1, pw0, pw1) < 0:
        return None
    B, C, H, W = x_shape
    kh, kw = meta["kernel"]
    sh, sw = meta["stride"]
    return dict(
        B=B, C=C, H=H, W=W, kh=kh, kw=kw, sh=sh, sw=sw, ph=ph0, pw=pw0,
        Ho=kmath.conv_output_size(H, kh, sh, (ph0, ph1)),
        Wo=kmath.conv_output_size(W, kw, sw, (pw0, pw1)),
        d_in=kh * kw * C,
    )


def conv_cov_kernel_supported(x_shape: tuple, meta: dict) -> bool:
    """Whether the kernel handles this conv: the JAX gate's geometry
    conditions (no dilation or groups, non-negative padding, ``kh*kw <= 9``,
    ``C >= 16``, ``C % 8 == 0``) without its VMEM bound on ``d``, so the
    bias pad, which only adds to ``d``, does not matter."""
    geo = _geometry(x_shape, meta)
    if geo is None:
        return False
    return geo["kh"] * geo["kw"] <= 9 and geo["C"] >= 16 and geo["C"] % 8 == 0


def conv_input_covariance_plain(
    x: torch.Tensor, meta: dict, bias_pad: float | None = None
) -> tuple[torch.Tensor, int]:
    """Plain PyTorch version: ``F.pad`` + ``unfold``, (KH, KW, C) reorder, matmul.

    Returns:
        ``(cov [d, d], S = Ho*Wo)``, accumulated and returned in float32 for a
        float32 or bfloat16 ``x``.
    """
    return kmath.input_covariance(x, "conv", meta, KFACType.EXPAND, bias_pad=bias_pad)


def _splits(n_tiles: int, R: int, n_sms: int) -> tuple[int, int]:
    """``(splits, rows per split)`` of the row reduction over ``blockIdx.z``:
    as many splits as fit the tiles' CTAs into one wave of
    ``_CTAS_PER_SM`` resident CTAs per SM (layers with many tiles take one),
    at most ``_MAX_SPLITS`` and none under ``_MIN_ROWS_PER_SPLIT`` rows.
    Every split but the last is a whole number of ``_BK``-row slabs."""
    splits = max(1, min(n_sms * _CTAS_PER_SM // n_tiles, _MAX_SPLITS, R // _MIN_ROWS_PER_SPLIT))
    rows = -(-(-(-R // splits)) // _BK) * _BK
    return -(-R // rows), rows


def conv_input_covariance(
    x: torch.Tensor, meta: dict, bias_pad: float | None = None
) -> tuple[torch.Tensor, int]:
    """Unnormalized patch covariance ``sum_{b,s} a a^T`` of a conv input and ``S``.

    Args:
        x: Conv layer input ``[B, C, H, W]``, float32 or bfloat16.
        meta: Conv metadata from the collector.
        bias_pad: Append a constant column (1.0 has-bias / 0.0 padded) for
            joint weight+bias groups.

    Returns:
        ``(cov [d, d] float32, S = Ho*Wo)`` with ``d = KH*KW*C (+1)`` in
        the (KH, KW, C) order, accumulated in float32.

    Raises:
        ValueError: For a geometry the kernel does not take, or a tensor on
            neither the CPU nor a CUDA device.
        TypeError: For a dtype other than float32/bfloat16.
        RuntimeError: If the launch fails.
    """
    if x.device.type == "cpu":
        return conv_input_covariance_plain(x, meta, bias_pad)
    if x.device.type != "cuda":
        raise ValueError(f"Unsupported device {x.device}.")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"Kernel takes float32 or bfloat16, got {x.dtype}.")
    if not conv_cov_kernel_supported(tuple(x.shape), meta):
        raise ValueError(f"Unsupported conv geometry for the kernel: {meta}.")
    if x.numel() >= 2**31:
        raise ValueError("The kernel indexes its input with 32-bit integers: too many elements.")
    geo = _geometry(tuple(x.shape), meta)
    S = geo["Ho"] * geo["Wo"]
    R = geo["B"] * S
    d = geo["d_in"] + (bias_pad is not None)
    tiles = -(-d // _TILE)
    n_sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits, rows_per_split = _splits(tiles * (tiles + 1) // 2, R, n_sms)

    lib = cuda_build.load(SOURCE, _bind)
    x_nhwc = x.permute(0, 2, 3, 1).contiguous()
    if x_nhwc.data_ptr() % 16:  # the kernel gathers 16-byte chunks
        x_nhwc = x_nhwc.clone()
    ws = torch.empty((splits, d, d), dtype=torch.float32, device=x.device)
    # float32 for bfloat16 inputs too: a covariance rounded to bfloat16 is
    # indefinite by about 2^-9 of its norm, and exact damping then divides by
    # eigenvalue products near -damping
    out = torch.empty((d, d), dtype=torch.float32, device=x.device)
    # the library sets its attributes and launches on the current device
    with torch.cuda.device(x.device):
        err = lib.conv_input_covariance(
            x_nhwc.data_ptr(), ws.data_ptr(), out.data_ptr(),
            int(x.dtype == torch.bfloat16),
            geo["B"], geo["H"], geo["W"], geo["C"], geo["kh"], geo["kw"],
            geo["sh"], geo["sw"], geo["ph"], geo["pw"], geo["Ho"], geo["Wo"],
            int(bias_pad is not None), float(bias_pad or 0.0),
            splits, rows_per_split, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"conv_input_covariance kernel launch failed: CUDA error {err}.")
    conv_input_covariance.launches += 1
    return out, S


conv_input_covariance.launches = 0
