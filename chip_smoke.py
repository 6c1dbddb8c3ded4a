#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. requires a CUDA device and prints the card's name and power limit;
2. builds every kernel source (``curvlinops_tpu_torch/kfac/csrc``,
   ``curvlinops_tpu_torch/models/csrc``) with ``nvcc``, all at once, and
   prints the build times and, for each kernel at the main paths' types
   (float32; head dim 64), its ``ptxas`` registers and spills and its SASS
   instruction count and TF32 tensor-core (``HMMA``) instructions from
   ``cuobjdump -sass``;
3. ResNet-18/CIFAR-10 at batch 512: holds the conv input-covariance kernel
   against its plain PyTorch version on every kernel-eligible conv input,
   captured from a real forward pass (float32; plus one bias-pad and one
   bfloat16 case), times both with CUDA events, prints each geometry's CTAs
   (tiles x row splits) and share of its bound, and times
   ``torch.matmul(P^T, P)`` on the materialised patch matrix ``P`` as the
   library yardstick (timed only; the port never calls it);
4. drives that main path, KFAC on ResNet-18 at batch 512: factor build with
   the MC Fisher through the kernel, heuristic and exact damped inverses
   applied to the gradient, and the Kronecker matvec; it checks that the
   kernel ran, that the factors agree with a build on the plain path, and
   that the results are finite; then the exactness oracle (one datum,
   type-2, a conv with one output position: KFAC equals the block-diagonal
   GGN);
5. nanoGPT at GPT-2 small width (12 layers, 12 heads, 768 wide, T = 1024,
   vocab 50304, batch 4): holds the three flash-attention kernels (forward,
   ``bwd_dkv``, ``bwd_dq``) against their plain versions on block 0's real
   ``q, k, v`` and a seeded ``dO``, in float32 and bfloat16, and times
   each kernel, its plain version and ``F.scaled_dot_product_attention``
   (timed only; the port never calls it), each kernel's share of its bound,
   the forward against SDPA's forward, and the backward pair
   (``bwd_dkv`` + ``bwd_dq``) against SDPA's one backward call;
6. drives that main path, KFAC on the flash GPT: MC factor build with the
   determinism probe, the gradient, the heuristic damped inverse applied to
   it, and the KFAC matvec; it checks that each flash kernel ran at least
   once per layer, that the results are finite, and that empirical-Fisher
   factors through the kernels agree with the einsum path's;
7. runs each main path's factor pass, inverse and matvec once more under
   ``torch.profiler`` and prints device time by kernel and the busy share;
8. prints a JSON line of kernel results and, last, a JSON status line.

Each kernel's bound is the larger of its bytes (each input read once, each
output written once) at 3.35 TB/s and its float32 products at the card's
fastest float32-accurate rate, 3xTF32 (495 / 3 TFLOP/s).

TF32 is off throughout: ``torch.backends.cudnn.allow_tf32`` defaults to
True and would put the plain path's convolutions at three decimal digits.
Any failed check raises, and the script exits nonzero without a status line.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
BATCH = 512  # ResNet-18/CIFAR-10
GPT_BATCH = 4  # nanoGPT, GPT-2 small
GPT_CONFIG = None  # None: GPTConfig(), GPT-2 small at full width and depth
DEVICE = "cuda:0"  # one card
F32_TOL = 1e-4  # relative Frobenius error, float32: summation order differs
BF16_TOL = 1e-2  # both versions round the float32 result to bfloat16 (2^-8)
FACTOR_TOL = 1e-4  # KFAC factors, kernel path vs plain path
ORACLE_RTOL, ORACLE_ATOL = 1e-3, 1e-5  # as in the port's CPU oracle tests
# published H100 SXM peaks (NVIDIA's data sheet), dense: TF32 tensor cores
# (495 TFLOP/s) and HBM3 bandwidth. Every bound states float32 products at the
# card's fastest float32-accurate route, 3xTF32 (three TF32 products per
# float32 product), whatever route the kernel takes; bfloat16 products would
# be at 989 TFLOP/s.
PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 495e12 / 3, 3.35e12
PEAK_NAME = "3xTF32, 495/3 = 165 TFLOP/s; 3.35 TB/s"
# the port's own kernels, listed in every profile wherever they rank
PORT_KERNELS = ("cov_tiles_kernel", "reduce_mirror_kernel", "flash_fwd_kernel",
                "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def time_ms(fn, torch, reps: int = 20) -> float:
    """Median device time of ``fn`` in ms, from CUDA events around each call."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def alternated_ms(plain, kernel, torch) -> tuple[float, float]:
    """``(kernel ms, plain ms)``, each the mean of two medians taken in the
    order plain, kernel, kernel, plain to spread drift evenly."""
    p1, k1, k2, p2 = (time_ms(f, torch) for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def device_profile(torch, label: str, fn) -> None:
    """One warm run of ``fn`` under ``torch.profiler``: wall and device ms,
    busy share (device over wall; the profiler inflates wall time, not
    device time), the largest device items by name and the port's kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    device_ms = sum(ms for ms, _ in by_name.values())
    print(
        f"profile, {label}: wall {wall_ms:.3f} ms, device {device_ms:.3f} ms, "
        f"busy {device_ms / wall_ms:.3f}"
    )
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for rank, (name, (ms, n)) in enumerate(ranked):
        if rank < 8 or any(k in name for k in PORT_KERNELS):
            print(f"    {ms:.3f} ms x{n} {name[:110]}")


def _main_kernel(mangled: str) -> str | None:
    """The port kernel a mangled name instantiates, if it is the float32 (head
    dim 64) instantiation the main paths run."""
    name = next((k for k in PORT_KERNELS if k in mangled), None)
    return name if "IfEE" in mangled or "IfLi64EE" in mangled else None


def ptxas_usage(build_log: str) -> dict:
    """``{kernel: "N registers, spills"}`` of the main paths' instantiations,
    from ``nvcc -Xptxas -v`` (a function's properties follow its name)."""
    usage, name = {}, None
    for line in build_log.splitlines():
        if "Function properties for " in line:
            name = _main_kernel(line.split("Function properties for ")[1])
        elif name and "spill" in line:
            usage[name] = line.strip()
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            usage[name] = f"{regs} registers, {usage.get(name, '')}"
            name = None
    return usage


def sass_counts(lib_path: Path) -> dict:
    """``{kernel: (instructions, HMMA instructions)}`` of the float32 (head
    dim 64) instantiations in a built library, from ``cuobjdump -sass``."""
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = _main_kernel(line.split("Function : ")[1].strip())
            if name:
                counts[name] = (0, 0)
        elif name and re.search(r"/\*[0-9a-f]{4}\*/", line):
            n, hmma = counts[name]
            counts[name] = (n + 1, hmma + ("HMMA" in line))
    return counts


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time in ms of float32 work at the published peaks (float32
    products at the 3xTF32 rate), and what bounds it."""
    ops_ms, bytes_ms = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device, and none is available.")
    port = REPO / "curvlinops_tpu_torch"
    if not ((port / "kfac" / "csrc").is_dir() and (port / "models" / "csrc").is_dir()):
        raise SystemExit("chip_smoke.py must run from the root of a checkout of the repo.")
    sys.path.insert(0, str(REPO))
    from curvlinops_tpu_torch.kfac import kernels
    from curvlinops_tpu_torch.models import flash_attention as fa
    from curvlinops_tpu_torch.utils import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)

    # ---- 1. build: one nvcc per source, all started together ---------- #
    sources = [kernels.SOURCE, fa.SOURCE]
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = list(pool.map(cuda_build.build, sources))
    for lib_path, build_s, build_log in builds:
        print(f"build: {build_s:.2f} s -> {lib_path.relative_to(REPO)}")
        for kernel, usage in ptxas_usage(build_log).items():
            print(f"  ptxas: {kernel} (float32): {usage}")
        for kernel, (n, hmma) in sass_counts(lib_path).items():
            print(f"  sass: {kernel} (float32): {n} instructions, {hmma} HMMA (TF32 tensor core)")

    entries = [resnet_phases(torch, dev, kernels)]
    entries += gpt_phases(torch, dev, fa)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


# ---------------------------------------------------------------------- #
# ResNet-18/CIFAR-10 and the conv input-covariance kernel
# ---------------------------------------------------------------------- #
def resnet_phases(torch, dev, kernels) -> dict:
    """Kernel against plain on the real conv inputs, then the KFAC main
    path; returns the kernel's JSON entry."""
    from curvlinops_tpu_torch.kfac.collector import TracedModel
    from curvlinops_tpu_torch.kfac.math import extract_conv_patches
    from curvlinops_tpu_torch.kfac.operator import KFACLinearOperator
    from curvlinops_tpu_torch.models.resnet import cifar10_resnet18

    t0 = time.perf_counter()
    problem = cifar10_resnet18(batch_size=BATCH, seed=0, device=dev)
    X, y = problem.data[0]
    torch.cuda.synchronize()
    print(f"problem: ResNet-18/CIFAR-10, batch {BATCH}, {time.perf_counter() - t0:.2f} s")
    traced = TracedModel(problem.model, problem.kfac_params, X)
    _, inputs, _ = traced.apply_with_io(problem.kfac_params, X)
    eligible = [
        (u, inputs[u.layer_id].detach())
        for u in traced.layers
        if u.kind == "conv"
        and kernels.conv_cov_kernel_supported(tuple(inputs[u.layer_id].shape), u.meta)
    ]
    n_convs = sum(u.kind == "conv" for u in traced.layers)
    print(f"eligible convs: {len(eligible)} of {n_convs}")
    if len(eligible) != 19:
        raise RuntimeError(f"expected 19 kernel-eligible convs, found {len(eligible)}")

    max_abs, max_rel = 0.0, 0.0
    timed: dict = {}
    print(f"conv, input [B, C, H, W], kernel, stride, d, CTAs (tiles x splits), kernel ms, "
          f"plain ms, matmul(P^T P) ms, bound ms ({PEAK_NAME}), share of bound, rel err")
    for u, x in eligible:
        cov, S = kernels.conv_input_covariance(x, u.meta)
        plain, plain_S = kernels.conv_input_covariance_plain(x, u.meta)
        torch.cuda.synchronize()
        err = rel_err(cov, plain)
        if S != plain_S or not err < F32_TOL:
            raise RuntimeError(f"{u.name}: kernel vs plain relative error {err} (tol {F32_TOL})")
        max_abs = max(max_abs, float((cov - plain).abs().max()))
        max_rel = max(max_rel, err)
        geo = (tuple(x.shape), u.meta["kernel"], u.meta["stride"])
        d, R = cov.shape[0], x.shape[0] * S
        if geo not in timed:
            k_ms, p_ms = alternated_ms(
                lambda: kernels.conv_input_covariance_plain(x, u.meta),
                lambda: kernels.conv_input_covariance(x, u.meta), torch,
            )
            # the library yardstick: one matmul on the materialised patch
            # matrix (its extraction not timed)
            P = extract_conv_patches(x, u.meta).reshape(R, d)
            lib_ms = time_ms(lambda: torch.matmul(P.T, P), torch)
            del P
            # the symmetric [d, d] output needs d (d + 1) / 2 dot products
            # over the B*S patch rows; x is read once, the output written once
            flops = R * d * (d + 1)
            nbytes = (x.numel() + d * d) * x.element_size()
            timed[geo] = (k_ms, p_ms, *bound(flops, nbytes), lib_ms)
        k_ms, p_ms, b_ms, _, lib_ms = timed[geo]
        tiles = -(-d // kernels._TILE)
        n_tiles = tiles * (tiles + 1) // 2
        splits, _ = kernels._splits(
            n_tiles, R, torch.cuda.get_device_properties(x.device).multi_processor_count
        )
        print(
            f"{u.name}, {list(x.shape)}, {u.meta['kernel']}, {u.meta['stride']}, {d}, "
            f"{n_tiles * splits} ({n_tiles} x {splits}), {k_ms:.4f}, {p_ms:.4f}, {lib_ms:.4f}, "
            f"{b_ms:.4f}, {b_ms / k_ms:.3f}, {err:.2e}"
        )
    per_conv = [timed[(tuple(x.shape), u.meta["kernel"], u.meta["stride"])] for u, x in eligible]
    kernel_ms, plain_ms, bound_ms = (sum(t[i] for t in per_conv) for i in range(3))
    library_ms = sum(t[4] for t in per_conv)
    # what bounds the sum: operations unless the bytes-bound convs dominate it
    by_ops = sum(t[2] for t in per_conv if t[3] == "operations")
    bound_by = "operations" if by_ops >= bound_ms / 2 else "bytes"
    print(
        f"all 19 eligible convs: kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"matmul(P^T P) {library_ms:.3f} ms, bound {bound_ms:.3f} ms, "
        f"share of bound {bound_ms / kernel_ms:.3f}"
    )

    u0, x0 = eligible[0]
    cov, _ = kernels.conv_input_covariance(x0, u0.meta, bias_pad=1.0)
    plain, _ = kernels.conv_input_covariance_plain(x0, u0.meta, bias_pad=1.0)
    err = rel_err(cov, plain)
    print(f"bias_pad=1.0 ({u0.name}): rel err {err:.2e} (tol {F32_TOL})")
    if not err < F32_TOL:
        raise RuntimeError("bias-pad case disagrees")
    xb = x0.to(torch.bfloat16)
    cov, _ = kernels.conv_input_covariance(xb, u0.meta)
    plain, _ = kernels.conv_input_covariance_plain(xb, u0.meta)
    err = rel_err(cov, plain)
    print(f"bfloat16 ({u0.name}): rel err {err:.2e} (tol {BF16_TOL}), dtype {cov.dtype}")
    if cov.dtype != torch.bfloat16 or not err < BF16_TOL:
        raise RuntimeError("bfloat16 case disagrees")
    del inputs, eligible, traced

    # ---- the main path: KFAC on ResNet-18 at batch 512 ----------------- #
    kernels.conv_input_covariance.launches = 0
    t0 = time.perf_counter()
    kfac = KFACLinearOperator(
        problem.model, problem.loss_fn, problem.kfac_params, problem.data,
        fisher_type="mc", use_kernel=True,
    )
    torch.cuda.synchronize()
    build_kfac_s = time.perf_counter() - t0
    grad = gradient(torch, problem)
    t0 = time.perf_counter()
    inv_h = kfac.inverse(damping=1e-3, use_heuristic_damping=True)
    step_h = inv_h @ grad
    torch.cuda.synchronize()
    inv_h_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    inv_e = kfac.inverse(damping=1e-3, use_exact_damping=True)
    step_e = inv_e @ grad
    torch.cuda.synchronize()
    inv_e_s = time.perf_counter() - t0
    Kg = kfac @ grad
    torch.cuda.synchronize()
    launches = kernels.conv_input_covariance.launches
    matvec_ms = time_ms(lambda: kfac @ grad, torch, reps=10)
    print(
        f"KFAC build {build_kfac_s:.3f} s ({len(kfac.groups)} groups, "
        f"{kfac.shape[0]} parameters), heuristic inverse + apply {inv_h_s:.3f} s, "
        f"exact inverse + apply {inv_e_s:.3f} s, matvec {matvec_ms:.3f} ms"
    )
    print(f"kernel launches in the main path: {launches}")
    if launches < 19:
        raise RuntimeError(f"the main path launched the kernel {launches} times, expected >= 19")
    check_finite(grad, {"K g": Kg, "heuristic step": step_h, "exact step": step_e})

    ref = KFACLinearOperator(
        problem.model, problem.loss_fn, problem.kfac_params, problem.data,
        fisher_type="mc", use_kernel=False, check_deterministic=False,
    )
    compare_factors(kfac, ref, FACTOR_TOL, "kernel vs plain path")

    # warm builds, plain path against kernel path (plain, kernel, kernel, plain)
    runs = {False: [], True: []}
    for use_kernel in (False, True, True, False):
        runs[use_kernel].append(warm_build(torch, problem, use_kernel=use_kernel))
    for use_kernel, label in ((False, "plain"), (True, "kernel")):
        report_warm(runs[use_kernel], f"{label} path")
    for use_kernel, label in ((True, "kernel"), (False, "plain")):
        comp = factor_computer(problem, use_kernel=use_kernel)
        device_profile(torch, f"ResNet-18 factor pass, {label} path", comp.compute)
    device_profile(torch, "ResNet-18 heuristic inverse + apply",
                   lambda: kfac.inverse(damping=1e-3, use_heuristic_damping=True) @ grad)
    device_profile(torch, "ResNet-18 exact inverse + apply",
                   lambda: kfac.inverse(damping=1e-3, use_exact_damping=True) @ grad)
    device_profile(torch, "ResNet-18 matvec", lambda: kfac @ grad)

    oracle_err = exactness_oracle(torch, dev, KFACLinearOperator, kernels)
    print(f"one-datum type-2 oracle through the kernel: max abs err {oracle_err:.2e}")
    print(
        "kernels: conv_input_covariance "
        f"launches={launches} max_abs_err={max_abs:.3e} max_rel_fro_err={max_rel:.3e}"
    )
    return {
        "name": "conv_input_covariance",
        "route": "cuda",
        "source": "curvlinops_tpu_torch/kfac/csrc/conv_input_covariance.cu",
        "replaces": "curvlinops_tpu/kfac/pallas_kernels.py:82",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        # no PyTorch call computes a patch covariance from x: the yardstick is
        # matmul(P^T, P) on the materialised patch matrix, extraction not timed
        "library_ms": library_ms,
    }


def gradient(torch, problem) -> dict:
    """Gradient of the problem's loss w.r.t. its KFAC parameters."""
    params = {n: p.detach().requires_grad_(True) for n, p in problem.kfac_params.items()}
    X, y = problem.data[0]
    loss = problem.loss_fn(torch.func.functional_call(problem.model, params, (X,)), y)
    return dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


def check_finite(grad: dict, outputs: dict) -> None:
    for name, out in outputs.items():
        for pname, t in out.items():
            if t.shape != grad[pname].shape or not t.isfinite().all():
                raise RuntimeError(f"{name}: {pname} is not finite or has the wrong shape")


def compare_factors(a, b, tol: float, label: str) -> None:
    worst = max(rel_err(a._aaT[gi], b._aaT[gi]) for gi in a._aaT)
    worst_g = max(rel_err(a._ggT[gi], b._ggT[gi]) for gi in a._ggT)
    print(f"factors, {label}: aaT rel err {worst:.2e}, ggT rel err {worst_g:.2e} (tol {tol})")
    if not (worst < tol and worst_g < tol):
        raise RuntimeError(f"KFAC factors differ ({label})")


def factor_computer(problem, **kwargs):
    """The MC factor pass of the main path, without the determinism probe."""
    from curvlinops_tpu_torch.kfac.computer import KFACComputer

    return KFACComputer(
        problem.model, problem.loss_fn, problem.kfac_params, problem.data,
        fisher_type="mc", check_deterministic=False, **kwargs,
    )


def warm_build(torch, problem, **kwargs) -> list[float]:
    """Seconds for tracing, the determinism probe and the factor pass."""
    t0 = time.perf_counter()
    comp = factor_computer(problem, **kwargs)
    marks = [t0, time.perf_counter()]
    for step in (comp._determinism_probe, comp.compute):
        step()
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    return [b - a for a, b in zip(marks[:-1], marks[1:])]


def report_warm(runs: list, label: str) -> None:
    trace_s, probe_s, factors_s = (sum(r[i] for r in runs) / len(runs) for i in range(3))
    print(
        f"warm build, {label}: trace {trace_s * 1e3:.1f} ms, "
        f"determinism probe {probe_s * 1e3:.1f} ms, factors {factors_s * 1e3:.1f} ms"
    )


def exactness_oracle(torch, dev, KFACLinearOperator, kernels) -> float:
    """One datum, type-2, a kernel-eligible conv with one output position:
    KFAC must equal the block-diagonal GGN."""
    from torch import nn

    from curvlinops_tpu_torch.losses import CrossEntropyLoss

    gen = torch.Generator().manual_seed(5)
    model = nn.Sequential(
        nn.Conv2d(16, 4, 3, bias=False), nn.Flatten(), nn.Tanh(), nn.Linear(4, 3, bias=False)
    )
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    model = model.to(dev)
    X = torch.randn((1, 16, 3, 3), generator=gen).to(dev)
    y = torch.tensor([1], device=dev)
    loss_fn = CrossEntropyLoss("mean")
    params = {n: p.detach() for n, p in model.named_parameters()}
    before = kernels.conv_input_covariance.launches
    kfac = KFACLinearOperator(model, loss_fn, params, [(X, y)], fisher_type="type-2", use_kernel=True)
    if kernels.conv_input_covariance.launches == before:
        raise RuntimeError("the oracle's conv did not go through the kernel")

    names = list(params)
    sizes = [params[n].numel() for n in names]
    flat = torch.cat([params[n].reshape(-1) for n in names])

    def unflat(v):
        return {n: t.reshape(params[n].shape) for n, t in zip(names, torch.split(v, sizes))}

    pred = torch.func.functional_call(model, params, (X,))
    J = torch.func.jacrev(lambda v: torch.func.functional_call(model, unflat(v), (X,)).reshape(-1))(flat)
    H = torch.func.hessian(lambda pf: loss_fn(pf.reshape(pred.shape), y))(pred.detach().reshape(-1))
    ggn = J.T @ H @ J
    expected = torch.zeros_like(ggn)
    start = 0
    for g in kfac.groups:  # bias-free layers: one block per weight, in parameter order
        n = params[g.weight_path].numel()
        expected[start:start + n, start:start + n] = ggn[start:start + n, start:start + n]
        start += n
    dense = kfac.todense()
    if not torch.allclose(dense, expected, rtol=ORACLE_RTOL, atol=ORACLE_ATOL):
        raise RuntimeError("KFAC through the kernel is not exact on the one-datum oracle")
    return float((dense - expected).abs().max())


# ---------------------------------------------------------------------- #
# nanoGPT (GPT-2 small) and the flash-attention kernels
# ---------------------------------------------------------------------- #
FLASH_KERNELS = ("fwd", "bwd_dkv", "bwd_dq")


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


def gpt_phases(torch, dev, fa) -> list[dict]:
    """The flash kernels against their plain versions on block 0's real
    inputs, then the KFAC main path on the flash GPT; returns the kernels'
    JSON entries."""
    import torch.nn.functional as F

    from curvlinops_tpu_torch.kfac.operator import KFACLinearOperator
    from curvlinops_tpu_torch.models.gpt import GPTConfig, shakespeare_nanogpt

    config = GPT_CONFIG or GPTConfig()
    t0 = time.perf_counter()
    problem = shakespeare_nanogpt(GPT_BATCH, config, seed=0, device=dev, attention_impl="flash")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in problem.params.values())
    print(
        f"problem: nanoGPT {config.n_layer} layers, {config.n_head} heads, width "
        f"{config.n_embd}, T {config.block_size}, vocab {config.vocab_size}, batch "
        f"{GPT_BATCH}, {n_params} parameters, {time.perf_counter() - t0:.2f} s"
    )

    # ---- kernels against plain on block 0's q, k, v ------------------- #
    model, (X, _) = problem.model, problem.data[0]
    B, T = X.shape
    H, hd = config.n_head, config.n_embd // config.n_head
    with torch.no_grad():
        qkv = model.h0.attn_qkv(model.h0.ln1(model.wte[X] + model.wpe[:T]))
    q, k, v = (
        t.reshape(B, T, H, hd).transpose(1, 2).contiguous() for t in qkv.split(config.n_embd, -1)
    )
    do = torch.randn(q.shape, generator=torch.Generator(dev).manual_seed(1), device=dev)
    kw = dict(causal=True, sm_scale=hd**-0.5)
    max_abs = dict.fromkeys(FLASH_KERNELS, 0.0)
    print(f"flash kernels vs plain, q k v dO [{B}, {H}, {T}, {hd}] of block 0:")
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        qd, kd, vd, dod = (t.to(dtype) for t in (q, k, v, do))
        o_ref, lse_ref = fa.flash_attention_plain(qd, kd, vd, **kw)
        di = (o_ref.float() * dod.float()).sum(-1)
        args = (qd, kd, vd, dod, lse_ref, di)
        pairs = {
            "fwd": zip(("o", "lse"), fa.flash_attention_fwd_kernel(qd, kd, vd, **kw), (o_ref, lse_ref)),
            "bwd_dkv": zip(
                ("dk", "dv"), fa.flash_attention_bwd_dkv_kernel(*args, **kw),
                fa.flash_attention_bwd_dkv_plain(*args, **kw),
            ),
            "bwd_dq": zip(
                ("dq",), (fa.flash_attention_bwd_dq_kernel(*args, **kw),),
                (fa.flash_attention_bwd_dq_plain(*args, **kw),),
            ),
        }
        torch.cuda.synchronize()
        for kernel, outputs in pairs.items():
            for name, a, b in outputs:
                err = rel_err(a, b)
                print(f"  {kernel} {name} {dtype}: rel err {err:.2e} (tol {tol}), dtype {a.dtype}")
                if a.dtype != b.dtype or not err < tol:
                    raise RuntimeError(f"flash {kernel} disagrees with its plain version on {name}")
                if dtype == torch.float32:
                    max_abs[kernel] = max(max_abs[kernel], float((a - b).abs().max()))

    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, **kw)
    di = (o_ref * do).sum(-1)
    args = (q, k, v, do, lse_ref, di)
    timing = {
        "fwd": alternated_ms(
            lambda: fa.flash_attention_plain(q, k, v, **kw),
            lambda: fa.flash_attention_fwd_kernel(q, k, v, **kw), torch,
        ),
        "bwd_dkv": alternated_ms(
            lambda: fa.flash_attention_bwd_dkv_plain(*args, **kw),
            lambda: fa.flash_attention_bwd_dkv_kernel(*args, **kw), torch,
        ),
        "bwd_dq": alternated_ms(
            lambda: fa.flash_attention_bwd_dq_plain(*args, **kw),
            lambda: fa.flash_attention_bwd_dq_kernel(*args, **kw), torch,
        ),
    }
    # the library yardstick, timed only: SDPA forward, and its backward, one
    # call that computes dq, dk and dv together (listed for both backward kernels)
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    print(f"  SDPA forward vs plain: rel err {rel_err(o_lib.detach(), o_ref):.2e}")
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), torch)
    lib_bwd = time_ms(
        lambda: torch.autograd.grad(o_lib, (ql, kl, vl), do, retain_graph=True), torch
    )
    library = {"fwd": lib_fwd, "bwd_dkv": lib_bwd, "bwd_dq": lib_bwd}
    bounds = {n: flash_bound(n, B, H, T, hd, q.element_size()) for n in FLASH_KERNELS}
    print(f"kernel, kernel ms, plain ms, SDPA ms, bound ms ({PEAK_NAME}), bound by (float32), "
          f"share of bound")
    for n in FLASH_KERNELS:
        print(f"  {n}, {timing[n][0]:.4f}, {timing[n][1]:.4f}, {library[n]:.4f}, "
              f"{bounds[n][0]:.4f}, {bounds[n][1]}, {bounds[n][0] / timing[n][0]:.3f}")
    print(f"  forward {timing['fwd'][0]:.4f} ms, SDPA forward {lib_fwd:.4f} ms, "
          f"forward / SDPA {timing['fwd'][0] / lib_fwd:.3f}")
    # SDPA's backward computes dq, dk and dv in one call: the pair is what competes with it
    pair_ms = timing["bwd_dkv"][0] + timing["bwd_dq"][0]
    pair_bound = bounds["bwd_dkv"][0] + bounds["bwd_dq"][0]
    print(f"  backward pair bwd_dkv + bwd_dq {pair_ms:.4f} ms, SDPA backward {lib_bwd:.4f} ms, "
          f"pair / SDPA {pair_ms / lib_bwd:.3f}, bound {pair_bound:.4f} ms")
    del qkv, q, k, v, do, o_ref, lse_ref, di, args, ql, kl, vl, o_lib

    # ---- the main path: KFAC on the flash GPT ------------------------- #
    for n in fa.launches:
        fa.launches[n] = 0
    t0 = time.perf_counter()
    kfac = KFACLinearOperator(
        problem.model, problem.loss_fn, problem.kfac_params, problem.data, fisher_type="mc",
    )
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    grad = gradient(torch, problem)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step = kfac.inverse(damping=1e-3, use_heuristic_damping=True) @ grad
    torch.cuda.synchronize()
    inv_s = time.perf_counter() - t0
    Kg = kfac @ grad
    torch.cuda.synchronize()
    launches = dict(fa.launches)
    matvec_ms = time_ms(lambda: kfac @ grad, torch, reps=10)
    print(
        f"GPT KFAC build {build_s:.3f} s ({len(kfac.groups)} groups, {kfac.shape[0]} "
        f"parameters), gradient {grad_s:.3f} s, heuristic inverse + apply {inv_s:.3f} s, "
        f"matvec {matvec_ms:.3f} ms"
    )
    print(f"flash kernel launches in the main path: {launches}")
    if min(launches.values()) < config.n_layer:
        raise RuntimeError(f"a flash kernel ran fewer than {config.n_layer} times: {launches}")
    check_finite(grad, {"K g": Kg, "heuristic step": step})
    device_profile(torch, "GPT heuristic inverse + apply",
                   lambda: kfac.inverse(damping=1e-3, use_heuristic_damping=True) @ grad)
    device_profile(torch, "GPT matvec", lambda: kfac @ grad)
    del kfac, step, Kg

    # empirical Fisher (no sampling): flash path against the einsum path
    reference = shakespeare_nanogpt(GPT_BATCH, config, seed=0, device=dev, attention_impl="einsum")
    ops = [
        KFACLinearOperator(
            p.model, p.loss_fn, p.kfac_params, p.data,
            fisher_type="empirical", check_deterministic=False,
        )
        for p in (problem, reference)
    ]
    compare_factors(*ops, FACTOR_TOL, "empirical, flash vs einsum path")
    del ops

    # warm builds, einsum path against flash path (einsum, flash, flash, einsum)
    runs = {"einsum": [], "flash": []}
    for impl, p in (("einsum", reference), ("flash", problem), ("flash", problem),
                    ("einsum", reference)):
        runs[impl].append(warm_build(torch, p))
    for impl in ("einsum", "flash"):
        report_warm(runs[impl], f"GPT {impl} path")
    for impl, p in (("flash", problem), ("einsum", reference)):
        device_profile(torch, f"GPT factor pass, {impl} path", factor_computer(p).compute)

    return [
        {
            "name": f"flash_attention_{n}",
            "route": "cuda",
            "source": "curvlinops_tpu_torch/models/csrc/flash_attention.cu",
            "replaces": "curvlinops_tpu/models/gpt.py:65",
            "launches": launches[n],
            "max_abs_err": max_abs[n],
            "ms": timing[n][0],
            "plain_ms": timing[n][1],
            "bound_ms": bounds[n][0],
            "bound_by": bounds[n][1],
            "library_ms": library[n],
        }
        for n in FLASH_KERNELS
    ]


if __name__ == "__main__":
    main()
