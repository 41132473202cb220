"""Philox4x32-10 in plain PyTorch integer ops: the reference bits of the
CUDA kernels' in-kernel generator (``csrc/philox.cuh``).

Batch element b's stream is keyed by its two 32-bit seed words
``seeds[b]``; the 64-bit Philox counter is the element offset divided by
four, and element e takes word ``e % 4`` of its counter's output.  So a
stream is a pure function of its seed words, whatever the batch size.

uint32 arithmetic is emulated in int64 with masks; the 32x32 -> 64-bit
products are split into 16-bit halves so no intermediate leaves int64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
# 2*sqrt(3) rounded to float32: the kernels receive this exact value
UNIT_SCALE = float(np.float32(2.0 * 3.0 ** 0.5))


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit halves of a * m for a in [0, 2**32), m < 2**32."""
    p1 = a * (m & 0xFFFF)
    p2 = a * (m >> 16)
    s = p1 + ((p2 & 0xFFFF) << 16)
    return ((p2 >> 16) + (s >> 32)) & M32, s & M32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Ten Philox rounds on int64 tensors holding uint32 values."""
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & M32
            k1 = (k1 + _PHILOX_W1) & M32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, _PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def seed_words_u32(seeds: torch.Tensor) -> torch.Tensor:
    """(B, 2) seed words (int32 bit patterns or uint32 values) as int64."""
    return seeds.to(torch.int64) & M32


def philox_words(seeds: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) int64 tensor of uint32 words; row b is the first n words of
    seed b's stream."""
    s = seed_words_u32(seeds)
    k0, k1 = s[:, :1], s[:, 1:2]
    m = torch.arange(math.ceil(n / 4), dtype=torch.int64, device=seeds.device)
    c0, c1 = (m & M32)[None], (m >> 32)[None]
    z = torch.zeros_like(c0)
    w = philox4x32_10(c0, c1, z, z, k0, k1)
    return torch.stack(w, dim=-1).reshape(s.shape[0], -1)[:, :n]


def _float_in_1_2(bits: torch.Tensor) -> torch.Tensor:
    """Mantissa trick: 23 random mantissa bits under exponent 0 -> [1, 2)."""
    pattern = (bits & 0x7FFFFF) | 0x3F800000
    return pattern.to(torch.int32).view(torch.float32)


def uniform_pm1(seeds: torch.Tensor, shape) -> torch.Tensor:
    """(B,)+shape float32 uniform(-1, 1): the norm bounds' subspace start."""
    n = math.prod(shape)
    f = _float_in_1_2(philox_words(seeds, n))
    return ((f - 1.5) * 2.0).reshape((seeds.shape[0],) + tuple(shape))


def unit_uniform(seeds: torch.Tensor, shape) -> torch.Tensor:
    """(B,)+shape float32 uniform(-sqrt3, sqrt3): zero mean, unit variance."""
    n = math.prod(shape)
    f = _float_in_1_2(philox_words(seeds, n))
    # UNIT_SCALE is a float32 value, so the product rounds exactly as the
    # kernel's __fmul_rn does
    return ((f - 1.5) * UNIT_SCALE).reshape((seeds.shape[0],) + tuple(shape))
