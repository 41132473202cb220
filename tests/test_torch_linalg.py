"""The port's L0 linear algebra (psgd_torch_tpu_torch.ops.linalg) against
psgd_torch_tpu.ops.linalg: norm bounds and the Procrustes step on replayed
subspace starts, float64, rtol 1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_torch_tpu.ops import linalg as jl
from psgd_torch_tpu_torch.ops import kernels, linalg as tl
from psgd_torch_tpu_torch.ops.kernels import key_seed_words


def _spd(rng, n, b=None):
    x = rng.standard_normal(((b,) if b else ()) + (n, 2 * n))
    return x @ np.swapaxes(x, -1, -2) / (2 * n)


def _skh(rng, n):
    x = rng.standard_normal((n, n))
    return x - x.T


def _start(key, k, n):
    """The start the JAX bound draws from ``key``."""
    return torch.from_numpy(np.array(jax.random.normal(key, (k, n), jnp.float64)))


@pytest.mark.parametrize("n,k", [(48, 8), (96, 32), (1100, 16)])
def test_norm_lower_bound_spd_matches_jax(n, k):
    a = _spd(np.random.default_rng(n), n)
    key = jax.random.PRNGKey(n)
    ref = jl.norm_lower_bound_spd(jnp.asarray(a), key, k=k)
    kk = tl.width_norm_k(k, n)          # 128 above width 1024
    out = tl.norm_lower_bound_spd(torch.from_numpy(a), k=k,
                                  v0=_start(key, kk, n))
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-10)


def test_norm_lower_bound_skh_matches_jax():
    a = _skh(np.random.default_rng(1), 64)
    key = jax.random.PRNGKey(2)
    ref = jl.norm_lower_bound_skh(jnp.asarray(a), key, k=16)
    out = tl.norm_lower_bound_skh(torch.from_numpy(a), k=16,
                                  v0=_start(key, 16, 64))
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-10)


def test_bounds_batched_match_per_matrix():
    """A stack of three matrices in one call equals JAX per matrix."""
    a = _spd(np.random.default_rng(3), 40, b=3)
    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    v0 = torch.stack([_start(k, 8, 40) for k in keys])
    out = tl.norm_lower_bound_spd(torch.from_numpy(a), k=8, v0=v0)
    for i in range(3):
        ref = jl.norm_lower_bound_spd(jnp.asarray(a[i]), keys[i], k=8)
        np.testing.assert_allclose(out[i].item(), float(ref), rtol=1e-10)


@pytest.mark.parametrize("n", [32, 80])
def test_procrustes_step2_matches_jax(n):
    rng = np.random.default_rng(n)
    q = np.eye(n) + 0.2 * rng.standard_normal((n, n))
    key = jax.random.PRNGKey(n + 1)
    ref = jl.procrustes_step2(jnp.asarray(q), key, norm_k=8)
    out = tl.procrustes_step2(torch.from_numpy(q), norm_k=8,
                              v0=_start(key, 8, n))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-12)


def test_philox_start_gives_a_lower_bound():
    """Without a replayed start the bound draws from Philox seed words; it
    stays a lower bound of the true norm and close to it."""
    a = torch.from_numpy(_spd(np.random.default_rng(5), 64, b=2))
    seeds = key_seed_words(np.array([[1, 2], [3, 4]], np.uint32), "cpu")
    out = tl.norm_lower_bound_spd(a, seeds, k=16)
    true = torch.linalg.eigvalsh(a)[:, -1]
    assert torch.all(out <= true * (1 + 1e-12))
    assert torch.all(out > 0.8 * true)
    with pytest.raises(ValueError):
        tl.norm_lower_bound_spd(a, k=16)


def test_norm_k_rules_match_jax():
    for k in (8, 32, 64, 128, 256):
        for n in (1, 512, 1024, 1025, 4096):
            assert tl.width_norm_k(k, n) == jl.width_norm_k(k, n)
    pairs = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
             (torch.float64, jnp.float64), (torch.float16, jnp.float16),
             (torch.complex64, jnp.complex64)]
    for td, jd in pairs:
        assert tl.resolve_norm_k(None, td) == jl.resolve_norm_k(None, jd)
        assert tl.resolve_norm_k(7, td) == 7
        assert str(tl.lifted_real_dtype(td)).split(".")[-1] == \
            str(jl.lifted_real_dtype(jd))
    x = torch.ones(3, dtype=torch.bfloat16)
    assert tl.lift2single(x).dtype == torch.float32
    assert tl.lift2single(x.double()).dtype == torch.float64



def test_tensor_core_matmul_model():
    """The model of the tensor cores' sums: exact where every partial sum
    is an integer f32 holds; the group's sum rounded toward zero where a
    round-to-nearest f32 GEMM rounds up (1 + 0.75 ulp); batched like @."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.integers(-8, 9, (2, 3, 40))).to(torch.bfloat16)
    a = torch.from_numpy(rng.integers(-8, 9, (2, 40, 5))).to(torch.bfloat16)
    got = tl.tensor_core_matmul(x, a)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 5)
    assert torch.equal(got, (x.double() @ a.double()).float())
    x = torch.tensor([[1.0, 3 * 2.0 ** -25]], dtype=torch.bfloat16)
    a = torch.ones((2, 1), dtype=torch.bfloat16)
    assert (x.float() @ a.float()).item() == 1 + 2.0 ** -23
    assert tl.tensor_core_matmul(x, a).item() == 1.0
    assert tl.tensor_core_matmul(-x, a).item() == -1.0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_norm_bound_rtol_reads_the_tensor_core_order(dtype):
    """``kernels.norm_bound_rtol``: BOUND_RTOL where the kernel sums in the
    plain version's order (f32 on the FFMA GEMM; f64 has no kernel), and
    in bf16 BOUND_RTOL plus how far the plain bound moves when summed in
    the tensor cores' order, which stays a bound of the stored matrix."""
    a = torch.from_numpy(_spd(np.random.default_rng(6), 96, b=3)).to(dtype)
    seeds = key_seed_words(np.array([[1, 2], [3, 4], [5, 6]], np.uint32), "cpu")
    rtol = kernels.norm_bound_rtol(a, seeds, "spd", 0, k=16)
    if dtype != torch.bfloat16:
        assert rtol == kernels.BOUND_RTOL
        return
    plain = tl.norm_bound_stored(a, "spd", seeds=seeds, k=16)
    ordered = tl.norm_bound_stored(a, "spd", seeds=seeds, k=16, tensor_core_sums=True)
    assert ordered.dtype == torch.float32
    spread = ((ordered - plain).abs() / plain).max().item()
    assert spread < 1e-3 and rtol == kernels.BOUND_RTOL + spread
    assert (ordered.double() <= 1.001 * torch.linalg.eigvalsh(a.double())[:, -1]).all()
