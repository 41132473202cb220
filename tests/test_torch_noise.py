"""Randomness of the port: the host threefry key tree against jax.random,
and the Philox noise (plain version here; the CUDA kernel on the card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_torch_tpu_torch.ops import fastrand, kernels, philox

SQRT3 = 3.0 ** 0.5


def test_threefry_keys_match_jax():
    """split / fold_in / uniform01 equal jax.random bit for bit (float32
    uniform, the gate's type without x64)."""
    for seed in (0, 1, 123456789, 2 ** 40 + 5):
        k = fastrand.prng_key(seed)
        jk = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(k, np.asarray(jk))
        np.testing.assert_array_equal(fastrand.split(k, 3),
                                      np.asarray(jax.random.split(jk, 3)))
        for d in (0, 7, 101, 2 ** 31 + 3):
            np.testing.assert_array_equal(
                fastrand.fold_in(k, d), np.asarray(jax.random.fold_in(jk, d)))
    keys = fastrand.split(fastrand.prng_key(9), 12)
    np.testing.assert_array_equal(
        fastrand.split(keys), np.asarray(jax.vmap(jax.random.split)(keys)))
    u = fastrand.uniform01(keys)
    ref = jax.vmap(lambda k: jax.random.uniform(k, dtype=jnp.float32))(keys)
    np.testing.assert_array_equal(u, np.asarray(ref))


def test_philox_known_answers():
    """Philox4x32-10 known-answer vectors of the Random123 library."""
    m = philox.M32
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((m, m, m, m), (m, m),
              (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
              (0xA4093822, 0x299F31D0),
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in cases:
        t = [torch.tensor([c], dtype=torch.int64) for c in ctr + key]
        got = [int(x) for x in philox.philox4x32_10(*t)]
        assert got == list(want)


def _seeds(n, seed=0):
    keys = fastrand.split(fastrand.prng_key(seed), n)
    return kernels.key_seed_words(keys, "cpu")


def test_stream_depends_only_on_its_seed():
    """Element i is the same whether drawn in a batch of 1 or of 12."""
    seeds = _seeds(12)
    full = kernels.unit_noise(seeds, (5, 13), torch.float32)
    for i in (0, 5, 11):
        one = kernels.unit_noise(seeds[i:i + 1], (5, 13), torch.float32)
        assert torch.equal(full[i], one[0])
    assert not torch.equal(full[0], full[1])
    other = kernels.unit_noise(_seeds(12, seed=1), (5, 13), torch.float32)
    assert not torch.equal(full, other)


def test_unit_noise_distribution():
    """uniform(-sqrt3, sqrt3): |mean| < 0.01 and |var - 1| < 0.01 over 400k
    draws (about 5 standard errors each)."""
    u = kernels.unit_noise(_seeds(4, seed=3), (100_000,), torch.float32)
    assert u.min() > -SQRT3 - 1e-6 and u.max() < SQRT3 + 1e-6
    assert abs(u.mean().item()) < 0.01
    assert abs(u.var().item() - 1.0) < 0.01
    assert (u.abs() > 1.6).float().mean() > 0.05   # uniform, not normal tails


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_damping_equals_g_plus_d_unit(dtype):
    """Fused mode == g + (damping + eps|g|) * (unit mode), exactly, with the
    arithmetic in float32 and one rounding per operation."""
    seeds = _seeds(3, seed=4)
    g = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 7, 9))
                         ).to(dtype)
    v = kernels.unit_noise(seeds, (7, 9), dtype).float()
    d = torch.tensor(1e-3, dtype=torch.float32) + torch.finfo(dtype).eps * \
        g.float().abs()
    want = (g.float() + d * v).to(dtype)
    assert torch.equal(kernels.damped_noise(g, seeds, 1e-3), want)


def test_fastrand_noise_routes_to_the_plain_version_on_cpu():
    keys = fastrand.split(fastrand.prng_key(5), 2)
    out = fastrand.unit_noise_stacked(keys, (4, 8), torch.float32, "cpu")
    want = kernels.unit_noise_plain(kernels.key_seed_words(keys, "cpu"),
                                    (4, 8), torch.float32)
    assert torch.equal(out, want)
    one = fastrand.unit_noise(keys[1], (4, 8), torch.float32, "cpu")
    assert torch.equal(one, want[1])
    with pytest.raises(NotImplementedError):
        fastrand.unit_noise(keys[0], (4,), torch.complex64, "cpu")

