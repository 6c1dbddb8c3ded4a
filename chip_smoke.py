#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. requires a CUDA device and prints the card's name and power limit;
2. builds the conv input-covariance kernel from
   ``curvlinops_tpu_torch/kfac/csrc`` with ``nvcc`` and prints the build time;
3. holds the kernel against its plain PyTorch version on every
   kernel-eligible conv input of ResNet-18/CIFAR-10 at batch 512, captured
   from a real forward pass (float32; plus one bias-pad and one bfloat16
   case), and times both with CUDA events;
4. drives the main path, KFAC on ResNet-18 at batch 512: factor build with
   the MC Fisher through the kernel, heuristic and exact damped inverses
   applied to the gradient, and the Kronecker matvec; it checks that the
   kernel ran, that the factors agree with a build on the plain path, and
   that the results are finite;
5. checks the kernel path against the exactness oracle (one datum, type-2,
   a conv with one output position: KFAC equals the block-diagonal GGN);
6. prints a JSON line of kernel results and, last, a JSON status line.

TF32 is off throughout: ``torch.backends.cudnn.allow_tf32`` defaults to
True and would put the plain path's convolutions at three decimal digits.
Any failed check raises, and the script exits nonzero without a status line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
BATCH = 512
DEVICE = "cuda:0"  # one card
F32_TOL = 1e-4  # relative Frobenius error, float32: summation order differs
BF16_TOL = 1e-2  # both versions round the float32 result to bfloat16 (2^-8)
FACTOR_TOL = 1e-4  # KFAC factors, kernel path vs plain path
ORACLE_RTOL, ORACLE_ATOL = 1e-3, 1e-5  # as in the port's CPU oracle tests


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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device, and none is available.")
    if not (REPO / "curvlinops_tpu_torch" / "kfac" / "csrc").is_dir():
        raise SystemExit("chip_smoke.py must run from the root of a checkout of the repo.")
    sys.path.insert(0, str(REPO))
    from curvlinops_tpu_torch.kfac import kernels
    from curvlinops_tpu_torch.kfac.collector import TracedModel
    from curvlinops_tpu_torch.kfac.computer import KFACComputer
    from curvlinops_tpu_torch.kfac.operator import KFACLinearOperator
    from curvlinops_tpu_torch.models.resnet import cifar10_resnet18

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)

    # ---- 1. build ------------------------------------------------------ #
    lib_path, build_s, build_log = kernels.build_kernel()
    print(f"build: {build_s:.2f} s -> {lib_path.relative_to(REPO)}")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- 2. kernel vs plain on the real conv inputs -------------------- #
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
    print("conv, input [B, C, H, W], kernel, stride, d, kernel ms, plain ms, rel err")
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
        if geo not in timed:
            # alternate plain, kernel, kernel, plain to spread drift evenly
            p1 = time_ms(lambda: kernels.conv_input_covariance_plain(x, u.meta), torch)
            k1 = time_ms(lambda: kernels.conv_input_covariance(x, u.meta), torch)
            k2 = time_ms(lambda: kernels.conv_input_covariance(x, u.meta), torch)
            p2 = time_ms(lambda: kernels.conv_input_covariance_plain(x, u.meta), torch)
            timed[geo] = ((k1 + k2) / 2, (p1 + p2) / 2)
        k_ms, p_ms = timed[geo]
        print(
            f"{u.name}, {list(x.shape)}, {u.meta['kernel']}, {u.meta['stride']}, "
            f"{cov.shape[0]}, {k_ms:.4f}, {p_ms:.4f}, {err:.2e}"
        )
    kernel_ms = sum(timed[(tuple(x.shape), u.meta["kernel"], u.meta["stride"])][0] for u, x in eligible)
    plain_ms = sum(timed[(tuple(x.shape), u.meta["kernel"], u.meta["stride"])][1] for u, x in eligible)
    print(f"all 19 eligible convs: kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms")

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

    # ---- 3. the main path: KFAC on ResNet-18 at batch 512 -------------- #
    kernels.conv_input_covariance.launches = 0
    t0 = time.perf_counter()
    kfac = KFACLinearOperator(
        problem.model, problem.loss_fn, problem.kfac_params, problem.data,
        fisher_type="mc", use_kernel=True,
    )
    torch.cuda.synchronize()
    build_kfac_s = time.perf_counter() - t0
    params = {n: p.detach().requires_grad_(True) for n, p in problem.kfac_params.items()}
    loss = problem.loss_fn(torch.func.functional_call(problem.model, params, (X,)), y)
    grad = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
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
    for name, out in (("K g", Kg), ("heuristic step", step_h), ("exact step", step_e)):
        for pname, t in out.items():
            if t.shape != grad[pname].shape or not torch.isfinite(t).all():
                raise RuntimeError(f"{name}: {pname} is not finite or has the wrong shape")

    ref = KFACLinearOperator(
        problem.model, problem.loss_fn, problem.kfac_params, problem.data,
        fisher_type="mc", use_kernel=False, check_deterministic=False,
    )
    worst = 0.0
    for gi in kfac._aaT:
        worst = max(worst, rel_err(kfac._aaT[gi], ref._aaT[gi]))
    worst_g = max(rel_err(kfac._ggT[gi], ref._ggT[gi]) for gi in kfac._ggT)
    print(f"factors, kernel vs plain path: aaT rel err {worst:.2e}, ggT rel err {worst_g:.2e}")
    if not (worst < FACTOR_TOL and worst_g < FACTOR_TOL):
        raise RuntimeError("KFAC factors differ between the kernel and the plain path")

    # warm builds, plain path against kernel path (plain, kernel, kernel, plain)
    def warm_build(use_kernel: bool) -> list[float]:
        """Seconds for tracing, the determinism probe and the factor pass."""
        t0 = time.perf_counter()
        comp = KFACComputer(
            problem.model, problem.loss_fn, problem.kfac_params, problem.data,
            fisher_type="mc", use_kernel=use_kernel, check_deterministic=False,
        )
        marks = [t0, time.perf_counter()]
        for step in (comp._determinism_probe, comp.compute):
            step()
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        return [b - a for a, b in zip(marks[:-1], marks[1:])]

    runs = {False: [], True: []}
    for use_kernel in (False, True, True, False):
        runs[use_kernel].append(warm_build(use_kernel))
    for use_kernel, label in ((False, "plain"), (True, "kernel")):
        trace_s, probe_s, factors_s = (sum(r[i] for r in runs[use_kernel]) / 2 for i in range(3))
        print(
            f"warm build, {label} path: trace {trace_s * 1e3:.1f} ms, "
            f"determinism probe {probe_s * 1e3:.1f} ms, factors {factors_s * 1e3:.1f} ms"
        )

    # ---- 4. exactness oracle through the kernel ------------------------ #
    oracle_err = exactness_oracle(torch, dev, KFACLinearOperator, kernels)
    print(f"one-datum type-2 oracle through the kernel: max abs err {oracle_err:.2e}")

    print(
        "kernels: conv_input_covariance "
        f"launches={launches} max_abs_err={max_abs:.3e} max_rel_fro_err={max_rel:.3e}"
    )
    print(json.dumps({"kernels": [{
        "name": "conv_input_covariance",
        "route": "cuda",
        "source": "curvlinops_tpu_torch/kfac/csrc/conv_input_covariance.cu",
        "replaces": "curvlinops_tpu/kfac/pallas_kernels.py:82",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


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


if __name__ == "__main__":
    main()
