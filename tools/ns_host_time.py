#!/usr/bin/env python3
"""Host and device time per call of the port's single NS route on one card.

    python3 tools/ns_host_time.py [--root DIR] [--calls 10] [--repeats 30]

Imports psgd_torch_tpu_torch from DIR (default: the checkout this file is
in), builds its kernels, and times ``kernels.fused_ns_update`` in bf16 at
(12, 768) and (1, 768), the stacks the GPT-2 124M fit step sends the
single route.  Per call it prints:

* host: the time to issue one call's chain of launches, from
  ``time.perf_counter`` around ``--calls`` calls that are not synchronized
  (the least and the median of ``--repeats`` such loops; the loop is
  short enough that the launch queue does not fill);
* loop: the time per call of the same loop up to its end on the card
  (CUDA events, median);
* kernels: the card's kernel time per call (torch.profiler).

Where host is close to loop, the chain is bound by the host.  Run it on
two checkouts one after the other on the same card to compare them: the
card's name and power limit are printed first.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch


def _problem(b, n, dev):
    gen = torch.Generator(device=dev).manual_seed(n)
    a = torch.randn((b, n, n), generator=gen, device=dev)
    term1 = a @ a.mT / n + 0.5 * torch.eye(n, device=dev)
    q = 0.7 * torch.eye(n, device=dev) + 0.02 * torch.randn(
        (b, n, n), generator=gen, device=dev)
    seeds = torch.arange(2 * b, dtype=torch.int32, device=dev).reshape(b, 2) * 7919
    return (term1.bfloat16(), q.bfloat16(), torch.zeros(b, device=dev),
            torch.full((b,), 3.0, device=dev), seeds, 0.1, 0.9)


def _times(fn, calls, repeats):
    fn()
    torch.cuda.synchronize()
    host, loop = [], []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host.append((time.perf_counter() - t0) * 1e3 / calls)
        end.record()
        end.synchronize()
        loop.append(start.elapsed_time(end) / calls)
    return min(host), statistics.median(host), statistics.median(loop)


def _kernel_ms(fn, calls):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total += (getattr(e, "self_device_time_total", 0.0) or
                      getattr(e, "self_cuda_time_total", 0.0))
    return total / 1e3 / calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from psgd_torch_tpu_torch.ops import kernels
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"package: {Path(kernels.__file__).resolve().parents[1]}")
    dev = torch.device("cuda", 0)
    for b, n in ((12, 768), (1, 768)):
        problem = _problem(b, n, dev)
        run = lambda: kernels.fused_ns_update(*problem, k=128)
        least, host, loop = _times(run, args.calls, args.repeats)
        print(f"single route ({b}, {n}) bf16: host {least:.4f} (least) / {host:.4f} "
              f"(median) ms/call, loop "
              f"{loop:.4f} ms/call, kernels {_kernel_ms(run, args.calls):.4f} ms/call")
    return 0


if __name__ == "__main__":
    sys.exit(main())
