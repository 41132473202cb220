#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

1. Preflight: find the card (exit non-zero without one), print its name,
   the device count and nvidia-smi's name and power limit.
2. Build the kernels from psgd_torch_tpu_torch/ops/csrc with nvcc (sm_90a)
   and print the -Xptxas -v report (registers, shared memory, spills).
3. Hold each kernel against its plain PyTorch version on the same inputs at
   the main path's shapes: the noise kernel bit for bit, the NS update
   within the tolerances stated below, the norm bound under the true norm.
   Time kernel, plain version and (for the noise) torch.rand with CUDA
   events.
4. Main path: GPT-2 124M, batch 4 x 1024, bf16 compute, trained by
   KronWhiten in the bench configuration (momentum whitening, bf16 Q and
   momentum, max_skew 2, norm_k 128, weight decay 0.01, one preconditioner
   per layer) for 5 steps at update probability 1.0 and 5 at 0.1, on one
   fixed batch.  Fails on a non-finite loss, a final loss not below the
   first, or launch counts other than 8 NS updates and 16 noise launches
   per fit step.
5. Prints the kernels' JSON line, then the fixed last line.

Any failed phase raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch

from psgd_torch_tpu_torch.models import gpt2
from psgd_torch_tpu_torch.ops import kernels
from psgd_torch_tpu_torch.ops.linalg import width_norm_k
from psgd_torch_tpu_torch.optim import KronWhiten

# H100 SXM published peaks (dense): bf16 tensor cores, float32 without
# tensor cores, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
NS_PER_FIT_STEP = 8
NOISE_PER_FIT_STEP = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn in ms, from CUDA events around iters calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def preflight() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {name}  count: {torch.cuda.device_count()}  "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    return name, smi


def build() -> None:
    t0 = time.perf_counter()
    path, report = kernels.build()
    kernels.library()
    log(f"built {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in report.splitlines():
        if "ptxas" in line or "error" in line.lower():
            log(f"  {line.strip()}")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def check_noise(dev) -> dict:
    """Noise kernel, unit and fused mode, bit-exact against plain."""
    row = None
    gen = torch.Generator(device=dev).manual_seed(7)
    for shape, dtype in (((12, 768, 2304), torch.bfloat16),
                         ((1, 1024, 768), torch.float32)):
        b = shape[0]
        seeds = torch.randint(-2**31, 2**31 - 1, (b, 2), generator=gen,
                              device=dev, dtype=torch.int64).to(torch.int32)
        g = torch.randn(shape, generator=gen, device=dev).to(dtype)
        unit_k = kernels.unit_noise(seeds, shape[1:], dtype)
        unit_p = kernels.unit_noise_plain(seeds, shape[1:], dtype)
        damp_k = kernels.damped_noise(g, seeds, 1e-9)
        damp_p = kernels.damped_noise_plain(g, seeds, 1e-9)
        torch.cuda.synchronize()
        for what, k, p in (("unit", unit_k, unit_p), ("fused", damp_k, damp_p)):
            if not torch.equal(_bits(k), _bits(p)):
                bad = int((_bits(k) != _bits(p)).sum())
                raise AssertionError(f"noise {what} {shape} {dtype}: {bad} "
                                     "elements differ from the plain version")
        u = unit_k.float()
        log(f"noise {shape} {dtype}: unit and fused bit-exact; unit mean "
            f"{u.mean().item():.2e} var {u.var().item():.4f} "
            f"range [{u.min().item():.4f}, {u.max().item():.4f}]")
        numel, size = math.prod(shape), torch.finfo(dtype).bits // 8
        ms_unit = cuda_ms(lambda: kernels.unit_noise(seeds, shape[1:], dtype), 20)
        ms_fused = cuda_ms(lambda: kernels.damped_noise(g, seeds, 1e-9), 20)
        ms_rand = cuda_ms(lambda: torch.rand(shape, dtype=dtype, device=dev), 20)
        ms_plain_unit = cuda_ms(
            lambda: kernels.unit_noise_plain(seeds, shape[1:], dtype), 3, 1)
        ms_plain_fused = cuda_ms(
            lambda: kernels.damped_noise_plain(g, seeds, 1e-9), 3, 1)
        bound_unit = numel * size / PEAK_BYTES * 1e3
        bound_fused = 2 * numel * size / PEAK_BYTES * 1e3
        log(f"  unit  kernel {ms_unit:.4f} ms  plain {ms_plain_unit:.3f} ms  "
            f"torch.rand {ms_rand:.4f} ms  bound {bound_unit:.4f} ms (bytes)")
        log(f"  fused kernel {ms_fused:.4f} ms  plain {ms_plain_fused:.3f} ms  "
            f"bound {bound_fused:.4f} ms (bytes)")
        if row is None:   # the main path's stacked shape
            row = dict(ms=ms_fused, plain_ms=ms_plain_fused,
                       bound_ms=bound_fused, max_abs_err=0.0)
    return row


def check_ns(dev) -> dict:
    """NS update kernel against the plain version on the same inputs.

    Tolerances: with f32 Q the kernel and the plain version do the same f32
    arithmetic in another order: q' within 1e-4 relative (Frobenius), L
    within 1e-4.  With bf16 Q the kernel rounds product operands to bf16
    (the TPU kernel's precision) where the plain version keeps f32: q'
    within 1e-2, L within 2e-2.  The norm bound (L' - term2 with L = 0)
    must stay <= 1.001 x the true norm (eigvalsh)."""
    row = None
    gen = torch.Generator(device=dev).manual_seed(11)
    for b, n, dtype in ((12, 768, torch.bfloat16), (1, 1024, torch.bfloat16),
                        (2, 768, torch.float32)):
        m = 3 * n
        x = torch.randn((b, n, m), generator=gen, device=dev)
        term1 = (x @ x.transpose(1, 2) / m).to(dtype)
        a = 1e-2 * torch.randn((b, n, n), generator=gen, device=dev)
        q = (torch.eye(n, device=dev) + a).to(dtype)
        lips = torch.zeros(b, device=dev)
        term2 = torch.full((b,), 1.0, device=dev)
        seeds = torch.randint(-2**31, 2**31 - 1, (b, 2), generator=gen,
                              device=dev, dtype=torch.int64).to(torch.int32)
        args = (term1, q, lips, term2, seeds, 0.1, 0.9)
        qk, lk = kernels.fused_ns_update(*args, k=128)
        qp, lp = kernels.fused_ns_update_plain(*args, k=128)
        torch.cuda.synchronize()
        if not (torch.isfinite(qk.float()).all() and torch.isfinite(lk).all()):
            raise AssertionError(f"NS kernel {b}x{n} {dtype}: non-finite output")
        q_err = ((qk.float() - qp.float()).norm() / qp.float().norm()).item()
        l_err = ((lk - lp).abs() / lp.abs()).max().item()
        true = torch.linalg.eigvalsh(term1.float())[:, -1]
        ratio = ((lk - term2) / true).max().item()
        tol_q, tol_l = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 2e-2)
        max_abs = (qk.float() - qp.float()).abs().max().item()
        log(f"ns {b}x{n}x{n} {dtype}: q rel err {q_err:.2e} (tol {tol_q}), "
            f"L rel err {l_err:.2e} (tol {tol_l}), bound/true max "
            f"{ratio:.5f}, max abs err {max_abs:.3e}")
        if q_err > tol_q or l_err > tol_l or ratio > 1.001:
            raise AssertionError(f"NS kernel {b}x{n} {dtype} disagrees with "
                                 "the plain version")
        ms = cuda_ms(lambda: kernels.fused_ns_update(*args, k=128), 10)
        ms_plain = cuda_ms(lambda: kernels.fused_ns_update_plain(*args, k=128),
                           5, 1)
        k = width_norm_k(128, n)
        flops = b * (6 * n ** 3 + 8 * 2 * k * n * n)
        size = torch.finfo(dtype).bits // 8
        nbytes = b * (3 * n * n * size + 3 * 4)
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        bound = max(flops / peak, nbytes / PEAK_BYTES) * 1e3
        by = "operations" if flops / peak >= nbytes / PEAK_BYTES else "bytes"
        log(f"  kernel {ms:.3f} ms  plain {ms_plain:.3f} ms  bound "
            f"{bound:.4f} ms ({by}; {flops / 1e9:.2f} GFLOP)  kernel rate "
            f"{flops / ms / 1e9:.1f} TFLOP/s")
        if row is None:   # the main path's stacked shape
            row = dict(ms=ms, plain_ms=ms_plain, bound_ms=bound, bound_by=by,
                       max_abs_err=max_abs)
    return row


def _train_tiny(device, steps: int = 3):
    """A tiny GPT-2 trained by KronWhiten (f32 Q, p = 1) on ``device``; the
    same seeds on every device, so the Philox draws are the same."""
    cfg = gpt2.tiny_config(n_layer=2, n_head=4, n_embd=128, block_size=64,
                           vocab_size=512, compute_dtype=torch.float32)
    model = gpt2.GPT2(cfg, device="cpu").to(device)   # same weights everywhere
    x, y = gpt2.synthetic_lm_batch(torch.Generator().manual_seed(2), 2, 64,
                                   512, device=device)
    p0 = [p.detach().clone() for p in model.parameters()]
    opt = KronWhiten(model.named_parameters(), lr=1e-3, momentum=0.9,
                     whiten_grad=False, preconditioner_max_skew=2.0,
                     preconditioner_init_scale=1.0, norm_k=32,
                     weight_decay=0.01, device=device,
                     scanned_layers=gpt2.scanned_layers_mask(model))
    for _ in range(steps):
        opt.zero_grad()
        gpt2.loss_gpt2(model, x, y).backward()
        opt.step()
    return torch.cat([(p.detach() - q).flatten().cpu()
                      for p, q in zip(model.parameters(), p0)])


def check_small_path(dev) -> None:
    """The whole optimizer on the card (kernels) against the CPU (plain
    versions, which the CPU tests hold against the JAX package): 3 steps of
    a tiny GPT-2 with f32 Q.  Same seeds and draws on both sides; the total
    parameter change agrees within 1e-3 (Frobenius-relative: f32 sums in
    another order, in the model and in the kernels)."""
    on_card = _train_tiny(dev)
    on_cpu = _train_tiny(torch.device("cpu"))
    rel = ((on_card - on_cpu).norm() / on_cpu.norm()).item()
    log(f"small path (tiny GPT-2, 3 steps, f32 Q): card vs CPU plain, "
        f"parameter change rel err {rel:.2e} (tol 1e-3)")
    if not rel < 1e-3:
        raise AssertionError("the card's optimizer disagrees with the plain "
                             "path on a small input")


def main_path(dev, card: str, steps_p1: int = 5, steps_p01: int = 5):
    cfg = gpt2.gpt2_124m(compute_dtype=torch.bfloat16)
    model = gpt2.GPT2(cfg, device=dev, seed=0)
    tokens, targets = gpt2.synthetic_lm_batch(
        torch.Generator().manual_seed(1), 4, cfg.block_size, cfg.vocab_size,
        device=dev)
    opt = KronWhiten(
        model.named_parameters(), lr=1e-3 / 4, weight_decay=0.01,
        momentum=0.9, whiten_grad=False, preconditioner_max_skew=2.0,
        preconditioner_init_scale=1.0,
        preconditioner_update_probability=lambda c: 1.0 if c < steps_p1 else 0.1,
        preconditioner_dtype=torch.bfloat16, momentum_dtype=torch.bfloat16,
        norm_k=128, scanned_layers=gpt2.scanned_layers_mask(model), device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"main path: GPT-2 124M ({n_params / 1e6:.1f}M params), batch 4 x "
        f"{cfg.block_size}, bf16 compute, KronWhiten bench configuration")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, step_ms, opt_ms, fitted = [], [], [], []
    for step in range(steps_p1 + steps_p01):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = gpt2.loss_gpt2(model, tokens, targets)
        loss.backward()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fits0 = opt.fit_steps
        opt.step()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        losses.append(loss.item())
        step_ms.append((t2 - t0) * 1e3)
        opt_ms.append((t2 - t1) * 1e3)
        fitted.append(opt.fit_steps - fits0)
        log(f"  step {step:2d} p={'1.0' if step < steps_p1 else '0.1'} "
            f"fit={fitted[-1]} loss {losses[-1]:.4f}  step {step_ms[-1]:.1f} ms"
            f"  optimizer {opt_ms[-1]:.1f} ms")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fits = sum(fitted)
    launches = {"fused_ns_update": kernels.fused_ns_update.launches,
                "damped_noise": kernels.damped_noise.launches}
    log(f"  fit steps {fits}; launches {launches}; peak memory {peak_gb:.2f} GB")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses[0]} -> {losses[-1]}")
    if launches["fused_ns_update"] != NS_PER_FIT_STEP * fits or \
            launches["damped_noise"] != NOISE_PER_FIT_STEP * fits or fits == 0:
        raise AssertionError(f"launch counts {launches} for {fits} fit steps")
    fit_opt = [t for t, f in zip(opt_ms[1:], fitted[1:]) if f]
    nofit_opt = [t for t, f in zip(opt_ms[1:], fitted[1:]) if not f]
    log(f"  [{card}] optimizer step (median, first step excluded): fit "
        f"{_median(fit_opt)} ms, no fit {_median(nofit_opt)} ms")
    log(f"  [{card}] train step (median): p=1.0 "
        f"{_median(step_ms[1:steps_p1])} ms, p=0.1 "
        f"{_median(step_ms[steps_p1:])} ms; peak memory {peak_gb:.2f} GB")
    return launches, (model, opt, tokens, targets)


_NS_KERNELS = ("gemm_kernel", "row_stats_kernel", "select_kernel",
               "start_kernel", "row_norm_kernel", "bound_scalars_kernel",
               "transpose_sub_kernel", "combine_kernel")


def _category(kernel: str) -> str:
    if any(k in kernel for k in _NS_KERNELS):
        return "NS update chain (ours)"
    if "noise_kernel" in kernel:
        return "noise (ours)"
    if "nvjet" in kernel or "gemm" in kernel.lower() or "cutlass" in kernel:
        return "cuBLAS matmuls (model, P apply, term1)"
    if "sdpa" in kernel or "flash" in kernel or "fmha" in kernel:
        return "attention (cuDNN)"
    if "reduce_kernel" in kernel or "SoftMax" in kernel:
        return "PyTorch reductions and softmax"
    return "PyTorch elementwise and copies"


def profile_steps(state, card: str) -> None:
    """Where one training step's device time goes, for a fit step (p = 1)
    and a step without a fit (p = 0), from torch.profiler's CUDA kernel
    events.  The full tables go to the git-ignored output directory."""
    from pathlib import Path
    from torch.profiler import ProfilerActivity, profile
    model, opt, tokens, targets = state
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    group = opt.param_groups[0]
    for label, prob in (("fit step (p=1)", 1.0), ("no-fit step (p=0)", 0.0)):
        group["preconditioner_update_probability"] = prob
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            gpt2.loss_gpt2(model, tokens, targets).backward()
            opt.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # kernels only: user ranges such as Optimizer.step#... span kernels
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "#" not in e.key and not e.key.startswith("Optimizer.")]
        dev_us = {e.key: (getattr(e, "self_device_time_total", 0.0) or
                          getattr(e, "self_cuda_time_total", 0.0), e.count)
                  for e in kern}
        total_ms = sum(t for t, _ in dev_us.values()) / 1e3
        if total_ms == 0.0:
            log(f"  profile {label}: the profiler saw no device time")
            continue
        cats = {}
        for k, (t, c) in dev_us.items():
            cat = _category(k)
            tt, cc = cats.get(cat, (0.0, 0))
            cats[cat] = (tt + t, cc + c)
        log(f"  [{card}] profile {label}: wall {wall_ms:.1f} ms (profiler "
            f"on), kernels {total_ms:.1f} ms, device idle share "
            f"{max(0.0, 1 - total_ms / wall_ms):.2f}")
        for cat, (t, c) in sorted(cats.items(), key=lambda x: -x[1][0]):
            log(f"    {t / 1e3:8.2f} ms  {c:5d} launches  {cat}")
        fname = out_dir / f"chip_smoke_profile_{'fit' if prob else 'nofit'}.txt"
        with open(fname, "w") as fh:
            fh.write(f"{card}\n{label}\n")
            for k, (t, c) in sorted(dev_us.items(), key=lambda x: -x[1][0]):
                fh.write(f"{t / 1e3:10.3f} ms {c:6d}  {k}\n")


def _median(xs):
    return round(sorted(xs)[len(xs) // 2], 2) if xs else None


def main() -> int:
    name, smi = preflight()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # full float32 products in every plain version and in the model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build()
    noise = check_noise(dev)
    ns = check_ns(dev)
    check_small_path(dev)
    launches, state = main_path(dev, smi)
    profile_steps(state, smi)
    log(smi)
    rows = [
        dict(name="fused_ns_update", route="cuda",
             source="psgd_torch_tpu_torch/ops/csrc/ns_update.cu",
             replaces="psgd_torch_tpu/ops/pallas_kernels.py:142",
             launches=launches["fused_ns_update"],
             max_abs_err=ns["max_abs_err"], ms=ns["ms"],
             plain_ms=ns["plain_ms"], bound_ms=ns["bound_ms"],
             bound_by=ns["bound_by"], library_ms=None),
        dict(name="damped_noise", route="cuda",
             source="psgd_torch_tpu_torch/ops/csrc/noise.cu",
             replaces="psgd_torch_tpu/ops/pallas_kernels.py:626",
             launches=launches["damped_noise"],
             max_abs_err=noise["max_abs_err"], ms=noise["ms"],
             plain_ms=noise["plain_ms"], bound_ms=noise["bound_ms"],
             bound_by="bytes", library_ms=None),
    ]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
