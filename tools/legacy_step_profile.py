#!/usr/bin/env python3
"""Where a legacy optimizer's LeNet5 step spends its time, on the card.

    python3 tools/legacy_step_profile.py

For XMat, SPLU (rank 10) and Affine whitening over LeNet5 (batch 64 of
``synthetic_mnist``, one fixed batch, so no data is made and no loss is
read back inside the step): the mean step time over 5 steps after 3
warm-up steps (host clock around synchronized steps), then one step under
``torch.profiler`` (CPU and CUDA), its operators by CPU time and the
self CUDA total, whose ratio to the step time is the device's busy share.
Prints the card's name and power limit first.  Imports nothing of JAX;
needs the card.
"""

from __future__ import annotations

import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from psgd_torch_tpu_torch.models import lenet5  # noqa: E402
from psgd_torch_tpu_torch.optim import SPLU, Affine, XMat  # noqa: E402

ARMS = (("XMat", lambda ps, dev: XMat(ps, lr=0.05, device=dev)),
        ("SPLU", lambda ps, dev: SPLU(ps, lr=0.05, rank=10, device=dev)),
        ("Affine", lambda ps, dev: Affine(ps, lr=0.05, device=dev)))


def main() -> None:
    chip_smoke.preflight()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    for label, make in ARMS:
        params = lenet5.init_lenet5(torch.Generator().manual_seed(0), device=dev)
        opt = make(params, dev)
        x, y = lenet5.synthetic_mnist(torch.Generator().manual_seed(1), 64,
                                      device=dev)

        def step():
            opt.zero_grad()
            lenet5.loss_lenet5(params, x, y).backward()
            opt.step()

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        print(f"{label}: {(time.perf_counter() - t0) / 5 * 1e3:.2f} ms a step",
              flush=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cpu_time_total", row_limit=18),
              flush=True)


if __name__ == "__main__":
    main()
