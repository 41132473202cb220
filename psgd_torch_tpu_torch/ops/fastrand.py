"""Randomness for the PSGD hot path: host-side key derivation and noise.

Keys.  The JAX package threads threefry keys through its state
(``state.key -> (key, k_gate, k_fit)``, ``fold_in(k_fit, leaf)``,
``split(key, n_layer)``, ``split -> (kd, krest)``, ``fold_in(krest, i)``).
The port derives the same key tree on the host: ``split``, ``fold_in`` and
``uniform01`` below are threefry2x32 in numpy, bit-identical to
``jax.random`` with partitionable threefry (the JAX default).  A key is a
(..., 2) uint32 array, the raw key data.  Deriving keys uses no device RNG
state and causes no device sync, and every stream is a pure function of
(seed, step, leaf, layer, purpose).  Gates are decided on the host from the
same derivation.

Noise.  The device draws come from Philox4x32-10 keyed by a key's two words
(``ops.philox``; on CUDA the kernels of ``ops.kernels``).  Distribution:
uniform(-sqrt3, sqrt3), zero mean and unit variance -- the whitening math
only uses E[v v^H] = I, so any white unit-variance noise is sound (same
argument as psgd_torch_tpu/ops/fastrand.py).  A complex draw is two real
ones, from the two keys of split(key), each scaled by 2^-0.5.

The legacy families draw standard normals with ``torch.randn`` from a
``torch.Generator`` seeded by one key (``generator``), so their streams are
pure functions of the same key tree and launch no kernel of ``ops.kernels``.
"""

from __future__ import annotations

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on uint32 arrays (broadcasting);
    additions wrap modulo 2**32."""
    with np.errstate(over="ignore"):
        ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for g in range(5):
            for r in _ROT[g % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r)
                x1 = x0 ^ x1
            x0 = x0 + ks[(g + 1) % 3]
            x1 = x1 + ks[(g + 2) % 3] + np.uint32(g + 1)
    return x0, x1


def as_keys(keys) -> np.ndarray:
    keys = np.asarray(keys, dtype=np.uint32)
    if keys.shape[-1:] != (2,):
        raise ValueError(f"keys must have a trailing axis of 2, got {keys.shape}")
    return keys


def prng_key(seed: int) -> np.ndarray:
    """Key data of ``jax.random.PRNGKey(seed)`` for 0 <= seed < 2**64."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def split(keys, num: int = 2) -> np.ndarray:
    """(..., 2) -> (..., num, 2): ``jax.random.split`` on each key."""
    keys = as_keys(keys)
    k0, k1 = keys[..., 0:1], keys[..., 1:2]
    lo = np.arange(num, dtype=np.uint32)
    b0, b1 = _threefry2x32(k0, k1, np.zeros_like(lo), lo)
    return np.stack([b0, b1], axis=-1)


def fold_in(keys, data: int) -> np.ndarray:
    """(..., 2) -> (..., 2): ``jax.random.fold_in(key, data)``."""
    keys = as_keys(keys)
    k0, k1 = keys[..., 0], keys[..., 1]
    x1 = np.full(k0.shape, int(data) & 0xFFFFFFFF, np.uint32)
    b0, b1 = _threefry2x32(k0, k1, np.zeros_like(x1), x1)
    return np.stack([b0, b1], axis=-1)


def uniform01(keys) -> np.ndarray:
    """(..., 2) -> (...,): float32 ``jax.random.uniform(key)`` per key."""
    keys = as_keys(keys)
    k0, k1 = keys[..., 0], keys[..., 1]
    z = np.zeros_like(k0)
    b0, b1 = _threefry2x32(k0, k1, z, z)
    bits = ((b0 ^ b1) >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def generator(key, device) -> "torch.Generator":
    """A ``torch.Generator`` on ``device`` seeded by one key's two words
    (the high bit dropped: a seed is at most 2^63 - 1)."""
    import torch
    k = as_keys(key).reshape(2)
    gen = torch.Generator(device=device)
    gen.manual_seed(((int(k[0]) << 32) | int(k[1])) & (2 ** 63 - 1))
    return gen


def noise_keys(keys, dtype) -> np.ndarray:
    """The noise kernel's keys for a (B, 2) key array: the keys themselves
    for a real dtype, split(keys[i]) = (kr, ki) as a (B, 4) row for a
    complex one (its real part's key, then its imaginary part's), as the
    JAX package's complex ``unit_noise`` splits its key."""
    keys = as_keys(keys).reshape(-1, 2)
    if dtype.is_complex:
        return split(keys).reshape(keys.shape[0], 4)
    return keys


def unit_noise_stacked(keys, shape, dtype, device) -> torch.Tensor:
    """(B,)+shape white noise; batch element i's stream is a pure function
    of keys[i].  A complex dtype takes its real part from kr and its
    imaginary part from ki, (kr, ki) = split(keys[i]), each a real unit
    draw (f32 for complex64, f64 for complex128) times 2^-0.5: the JAX
    package's (u(kr) s + 1j u(ki) s).  On CUDA it is one launch of the
    Philox noise kernel."""
    from .kernels import key_seed_words, unit_noise
    return unit_noise(key_seed_words(noise_keys(keys, dtype), device),
                      tuple(shape), dtype)


def unit_noise(key, shape, dtype, device) -> torch.Tensor:
    """Zero-mean unit-variance white noise from one key."""
    return unit_noise_stacked(as_keys(key)[None], shape, dtype, device)[0]


def normal_like(key, x: torch.Tensor) -> torch.Tensor:
    """``unit_noise`` in x's shape, dtype and device (JAX ``normal_like``)."""
    return unit_noise(key, x.shape, x.dtype, x.device)
