#!/usr/bin/env python3
"""The dense-factor NS update across factor widths on the card: the H100
counterpart of tools/bench_ns_widths.py.

For each width n, B = max(1, 9216 // n) factors of JAX's problem (term1 =
A Aᵀ / n + 0.1 I with A standard normal, q = 0.9 I + 0.02 N, L = 1,
term2 = n, lr 0.1, betaL 0.9, norm_k 128 in bf16 and 32 in f32) go
through the route ``kernels.ns_route`` picks (or ``--force-path``'s, the
route entries ``kernels.fused_ns_update`` dispatches to; a route that
cannot run at a width is reported as such, never replaced).  Per width it
reports the route's ms (CUDA events, the median of 10 calls after two
warm-up calls; no slope timing: the card has no fixed call
latency to subtract), JAX's FLOP model b (6n³ + 16kn²) (``ns_flops``; k the
subspace dim the route takes, ``width_norm_k``: 128 above n = 1024), the
TFLOP/s and their share of the card's peak (989 bf16, 67 f32), the bound
max(bytes / 3.35 TB/s, FLOP / peak) with term1 and q read and q' written
once, the plain version's ms (the same route composed of the plain
PyTorch pieces: the counterpart of the JAX sweep's "xla" column, not a
yardstick), and q' and L' against the plain version (``kernels.ROUTE_TOL``)
with the spd bound (L' - term2) over the true norm of term1.

    python3 tools/bench_ns_widths_torch.py [--sizes 768,1024,...]
        [--dtype bfloat16|float32] [--force-path split|tiled] [--json PATH]
        [--device cuda]

Writes nothing unless ``--json`` is given (``build/`` is git-ignored).
Each time it prints stands beside the card's name and power limit.  On
the CPU (``--device cpu``) every wrapper runs its plain version, so the
"route" is its plain composition, timed on the host clock.  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from psgd_torch_tpu_torch.ops import kernels  # noqa: E402
from psgd_torch_tpu_torch.ops.linalg import width_norm_k  # noqa: E402

SIZES = (768, 1024, 1280, 1536, 2048, 3072, 4096)
WORK = 12 * 768           # B = max(1, WORK // n), as the JAX sweep
PEAK = {torch.bfloat16: 989e12, torch.float32: 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12
NORM_K = {torch.bfloat16: 128, torch.float32: 32}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
LR, BETA_L = 0.1, 0.9


def ns_flops(b: int, n: int, k: int) -> int:
    """JAX's model (tools/bench_ns_widths.py ``ns_flops``): three full
    products (step, RQ, RRQ) and about eight thin k x n x n ones (the
    bounds)."""
    return b * (3 * 2 * n ** 3 + 8 * 2 * k * n * n)


def problem(n: int, dtype, device):
    """JAX's inputs for width n, drawn from a generator seeded n:
    (term1, q, lips, term2, seeds)."""
    b = max(1, WORK // n)
    gen = torch.Generator(device=device).manual_seed(n)
    a = torch.randn((b, n, n), generator=gen, device=device) / n ** 0.5
    eye = torch.eye(n, device=device)
    term1 = (a @ a.mT + 0.1 * eye).to(dtype)
    del a
    q = (0.9 * eye + 0.02 * torch.randn((b, n, n), generator=gen,
                                        device=device)).to(dtype)
    seeds = torch.stack([torch.arange(b, dtype=torch.int32),
                         torch.arange(b, dtype=torch.int32) + 7], -1).to(device)
    return (term1, q, torch.ones(b, device=device),
            torch.full((b,), float(n), device=device), seeds)


def _times(fn, repeats: int, device) -> list:
    """ms of each of ``repeats`` calls after two warm-up calls: CUDA events
    on the card, the host clock elsewhere."""
    for _ in range(2):
        fn()
    out = []
    for _ in range(repeats):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
    return out


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _true_norm(term1):
    return torch.linalg.eigvalsh(term1.float())[:, -1]


def route_for(n: int, dtype, force_path=None) -> str:
    """The route a width runs: ``force_path``, else ``kernels.ns_route``'s."""
    return force_path or kernels.ns_route(n, dtype)


def width(n: int, dtype, device, force_path=None, repeats: int = 10) -> dict:
    """One width's record (module docstring).  ``error`` is None, or why
    the route could not run there."""
    device = torch.device(device)
    b, k = max(1, WORK // n), NORM_K[dtype]
    route = route_for(n, dtype, force_path)
    flops = ns_flops(b, n, width_norm_k(k, n))
    size = torch.finfo(dtype).bits // 8
    t_ops, t_bytes = flops / PEAK[dtype], b * 3 * n * n * size / PEAK_BYTES
    rec = dict(n=n, b=b, dtype=str(dtype).removeprefix("torch."), route=route,
               k=width_norm_k(k, n), gflop=flops / 1e9,
               bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               error=None)
    args = problem(n, dtype, device) + (LR, BETA_L)
    run = lambda: kernels.fused_ns_update(*args, k=k, route=route)  # noqa: E731
    run_p = lambda: kernels.fused_ns_update_plain(*args, k=k, route=route)  # noqa: E731
    try:
        qk, lk = run()
    except (ValueError, RuntimeError) as e:   # out of memory included
        rec["error"] = f"{type(e).__name__}: {str(e)[:200]}"
        return rec
    qp, lp = run_p()
    f = qp.float()
    tol_q, tol_l = kernels.ROUTE_TOL[dtype]
    q_err = ((qk.float() - f).norm() / f.norm()).item()
    l_err = ((lk - lp).abs() / lp.abs()).max().item()
    ratio = ((lk - args[3]) / _true_norm(args[0])).max().item()
    finite = bool(torch.isfinite(qk.float()).all() and torch.isfinite(lk).all())
    del qk, lk, qp, lp, f
    ms = _median(_times(run, repeats, device))
    plain_ms = _median(_times(run_p, max(1, repeats // 5), device))
    rec.update(ms=ms, tflops=flops / ms / 1e9, share=flops / (ms / 1e3) / PEAK[dtype],
               plain_ms=plain_ms, q_rel_err=q_err, l_rel_err=l_err,
               bound_over_true=ratio, tol_q=tol_q, tol_l=tol_l, finite=finite,
               within=finite and q_err <= tol_q and l_err <= tol_l and ratio <= 1.001)
    return rec


def sweep(sizes, dtype, device, force_path=None, repeats: int = 10) -> list:
    """``width``'s record for each n of ``sizes`` in ``dtype``."""
    out = []
    for n in sizes:
        out.append(width(n, dtype, device, force_path, repeats))
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def card() -> str:
    """nvidia-smi's name and power limit of the card, or what stands in."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return "no card (nvidia-smi not available)"


def describe(rec: dict, where: str) -> str:
    head = f"n={rec['n']:5d} B={rec['b']:2d} {rec['dtype']} {rec['route']:>6s}"
    if rec["error"]:
        return f"{head}: does not run ({rec['error']})"
    return (f"{head}: {rec['ms']:.3f} ms  {rec['gflop']:.1f} GFLOP  "
            f"{rec['tflops']:.1f} TFLOP/s ({100 * rec['share']:.1f}% of peak)  "
            f"bound {rec['bound_ms']:.3f} ms ({rec['bound_by']})  plain "
            f"{rec['plain_ms']:.2f} ms  q' {rec['q_rel_err']:.2e} (tol "
            f"{rec['tol_q']:g})  L' {rec['l_rel_err']:.2e}  bound/true "
            f"{rec['bound_over_true']:.5f}  [{where}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--force-path", default=None, choices=["split", "tiled"])
    ap.add_argument("--json", default=None, help="write the records to this file")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA device is available; pass --device cpu", file=sys.stderr)
        return 1
    if args.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
    where = card() if args.device.startswith("cuda") else "CPU, plain versions"
    records = sweep([int(s) for s in args.sizes.split(",")], DTYPES[args.dtype],
                    args.device, args.force_path)
    for rec in records:
        print(describe(rec, where), flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"card": where, "dtype": args.dtype,
                       "force_path": args.force_path, "results": records}, fh,
                      indent=1)
        print(f"wrote {args.json}")
    return int(any(r["error"] or not r["within"] for r in records))


if __name__ == "__main__":
    sys.exit(main())
