"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA card.
The file imports no JAX, so it also runs on the machine with the card:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from psgd_torch_tpu_torch.ops import kernels

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _seeds(b, dev):
    return torch.arange(2 * b, dtype=torch.int32, device=dev).reshape(b, 2) * 7919


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_noise_kernel_bit_exact(dev, dtype):
    """Both modes against the plain Philox version, bit for bit, including
    a length that is not a multiple of four."""
    seeds = _seeds(12, dev)
    g = torch.randn((12, 97, 33), device=dev).to(dtype)
    assert torch.equal(kernels.unit_noise(seeds, (97, 33), dtype),
                       kernels.unit_noise_plain(seeds, (97, 33), dtype))
    assert torch.equal(kernels.damped_noise(g, seeds, 1e-9),
                       kernels.damped_noise_plain(g, seeds, 1e-9))


def _ns_inputs(b, n, dev, dtype):
    gen = torch.Generator(device=dev).manual_seed(n)
    a = torch.randn((b, n, n), generator=gen, device=dev)
    term1 = (a @ a.transpose(1, 2) / n + 0.5 * torch.eye(n, device=dev))
    q = 0.7 * torch.eye(n, device=dev) + 0.02 * torch.randn(
        (b, n, n), generator=gen, device=dev)
    return (term1.to(dtype), q.to(dtype), torch.zeros(b, device=dev),
            torch.full((b,), 3.0, device=dev), _seeds(b, dev), 0.1, 0.9)


@pytest.mark.parametrize("n", [200, 256])
def test_ns_kernel_matches_plain_f32(dev, n):
    """f32: the same arithmetic in another order; q' within 1e-4
    (Frobenius-relative), L within 1e-4; n = 200 exercises ragged tiles."""
    args = _ns_inputs(3, n, dev, torch.float32)
    qk, lk = kernels.fused_ns_update(*args, k=32)
    qp, lp = kernels.fused_ns_update_plain(*args, k=32)
    assert ((qk - qp).norm() / qp.norm()).item() < 1e-4
    torch.testing.assert_close(lk, lp, rtol=1e-4, atol=0)


def test_ns_kernel_matches_plain_bf16(dev):
    """bf16: the kernel rounds product operands to bf16; q' within 1e-2,
    L within 2e-2, and the result is deterministic run to run."""
    args = _ns_inputs(4, 256, dev, torch.bfloat16)
    qk, lk = kernels.fused_ns_update(*args, k=128)
    qp, lp = kernels.fused_ns_update_plain(*args, k=128)
    assert ((qk.float() - qp.float()).norm() / qp.float().norm()).item() < 1e-2
    torch.testing.assert_close(lk, lp, rtol=2e-2, atol=0)
    qk2, lk2 = kernels.fused_ns_update(*args, k=128)
    assert torch.equal(qk, qk2) and torch.equal(lk, lk2)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    term1, q, lips, term2, seeds, lr, beta = _ns_inputs(1, 64, dev, torch.float32)
    with pytest.raises(ValueError):
        kernels.fused_ns_update(term1, q, lips, term2, seeds, lr, beta,
                                starts=(q[:, :8], q[:, :8]))
    with pytest.raises(TypeError):
        kernels.fused_ns_update(term1.double(), q.double(), lips, term2, seeds,
                                lr, beta)
    with pytest.raises(ValueError):
        kernels.fused_ns_update(term1, q.transpose(1, 2), lips, term2, seeds,
                                lr, beta)
    with pytest.raises(TypeError):
        kernels.damped_noise(q.double(), seeds, 1e-9)
    assert np.isfinite(kernels.fused_ns_update(
        term1, q, lips, term2, seeds, lr, beta)[1].cpu().numpy()).all()
