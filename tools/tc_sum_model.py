#!/usr/bin/env python3
"""How closely ``linalg.tensor_core_matmul`` models the port's tensor-core
GEMM on one card.

    python3 tools/tc_sum_model.py

Builds a small library around ``tc_gemm<kDiv, float>`` of
psgd_torch_tpu_torch/ops/csrc/ns_gemm_sm90.cuh (the product ``norm_bound``
runs in bf16) with nvcc into build/kernels/, runs it on the thin products
of the bound (k = 128 bf16 rows times a bf16 SPD matrix, divisor 1) at
n = 384 and 2560, and prints, for the model and for two other summation
orders (PyTorch's f32 matmul, which the plain versions use, and the exact
sum rounded once), the share of f32 entries equal to the GEMM's to the
bit, the mean distance in units in the last place, and the share of
entries whose bf16 rounding differs from the GEMM's (a flipped rounding
of the bound's iterate is what moves the bound).

Then, for ``norm_bound`` in bf16 on the gpu tests' problems over several
seeds (B x n = 3 x 200, 3 x 384, 2 x 2560, 22 x 2560; spd and skew), it
prints how far the kernel is from the plain bound, how far from the plain
bound summed by the model, and ``kernels.norm_bound_rtol``.  Imports
nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from psgd_torch_tpu_torch.ops import kernels, linalg  # noqa: E402

HARNESS = r"""
#include "ns_gemm_sm90.cuh"
extern "C" int tc_thin(const void* x, const void* a, float* w, int k, int n, int batch,
                       const float* s) {
  tc_gemm<kDiv, float>((const __nv_bfloat16*)x, (const __nv_bfloat16*)a, w, nullptr, k, n, n,
                       batch, s, nullptr, nullptr, 0);
  cudaDeviceSynchronize();
  return tc_status();
}
"""


def _build() -> ctypes.CDLL:
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = kernels.BUILD_DIR / "tc_sum_model.cu"
    lib = kernels.BUILD_DIR / "tc_sum_model.so"
    src.write_text(HARNESS)
    subprocess.run([kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared", "-I",
                    str(kernels.CSRC), str(src), "-o", str(lib)], check=True)
    return ctypes.CDLL(str(lib))


def _ulps(a, b):
    return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    lib, dev = _build(), torch.device("cuda", 0)
    for b, n in ((2, 384), (2, 2560)):
        gen = torch.Generator(device=dev).manual_seed(n)
        g = torch.randn((b, n, n), generator=gen, device=dev)
        a = (g @ g.mT / n + 0.5 * torch.eye(n, device=dev)).bfloat16()
        x = torch.randn((b, 128, n), generator=gen, device=dev)
        x = (x / x.norm(dim=-1, keepdim=True)).bfloat16()
        w = torch.empty((b, 128, n), dtype=torch.float32, device=dev)
        ones = torch.ones(b, device=dev)
        torch.cuda.synchronize()
        err = lib.tc_thin(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(a.data_ptr()),
                          ctypes.c_void_p(w.data_ptr()), 128, n, b,
                          ctypes.c_void_p(ones.data_ptr()))
        if err:
            raise RuntimeError(f"tc_gemm failed: {err}")
        for name, ref in (("tensor_core_matmul", linalg.tensor_core_matmul(x, a)),
                          ("f32 matmul", x.float() @ a.float()),
                          ("exact, rounded once", (x.double() @ a.double()).float())):
            u = _ulps(w, ref).double()
            flips = (w.bfloat16() != ref.bfloat16()).double().mean().item()
            print(f"({b}, 128, {n}) GEMM vs {name}: bit-equal "
                  f"{(u == 0).double().mean().item():.5f}, "
                  f"mean ulps {u.mean().item():.4f}, bf16 roundings differing {flips:.3e} "
                  f"of {w.numel()}")
    for b, n, seeds in ((3, 200, range(4)), (3, 384, range(8)), (2, 2560, range(4)),
                        (22, 2560, range(1))):
        for seed in seeds:
            _bound_case(b, n, seed, dev)
    return 0


def _bound_case(b, n, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(1000 * seed + n)
    g = torch.randn((b, n, n), generator=gen, device=dev)
    term1 = (g @ g.mT / n + 0.5 * torch.eye(n, device=dev)).bfloat16()
    noise = torch.tensor([0.02, 1e-3], device=dev).repeat(b)[:b, None, None]
    q = (0.7 * torch.eye(n, device=dev) + noise * torch.randn(
        (b, n, n), generator=gen, device=dev)).bfloat16()
    seeds = torch.arange(2 * b, dtype=torch.int32, device=dev).reshape(b, 2) * 7919
    for mode, mat, tag in (("spd", term1, 0),
                           ("skh", (q.mT - q).contiguous(), kernels.SKH_TAG)):
        got = kernels.norm_bound(mat, seeds, mode, tag, k=128)
        plain = kernels.norm_bound_plain(mat, seeds, mode, tag, k=128)
        ordered = linalg.norm_bound_stored(mat, mode, seeds=kernels._tagged(seeds, tag),
                                           k=128, tensor_core_sums=True)
        rtol = kernels.norm_bound_rtol(mat, seeds, mode, tag, k=128)
        rel = ((got - plain).abs() / plain).max().item()
        print(f"norm_bound ({b}, {n}) seed {seed} {mode}: vs plain {rel:.3e}, vs plain "
              f"summed by the model {((got - ordered).abs() / ordered).max().item():.3e}, "
              f"norm_bound_rtol {rtol:.3e}{'' if rel <= rtol else '  EXCEEDED'}")


if __name__ == "__main__":
    sys.exit(main())
