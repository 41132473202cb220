"""The transpose-subtract's plain versions (``kernels.tsub_plain``,
``kernels.transpose_sub_plain``): the identities the CUDA kernel relies on,
and the JAX package's ``_tiled_tsub_kernel`` on the same numpy inputs.

The kernel takes one unordered pair of tiles (I, J) per block and writes
R[I, J] and R[J, I] from the same two tiles; every element of R is its own
subtraction, rounded once to the output dtype (and once to bf16 for R16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_torch_tpu.ops import pallas_kernels
from psgd_torch_tpu_torch.ops import kernels

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _x(b, n, dtype, seed=0):
    """A (b, n, n) stack with a symmetric top-left block (zeros in R)."""
    x = np.random.default_rng(seed).standard_normal((b, n, n)).astype(np.float32)
    h = n // 2
    x[:, :h, :h] = (x[:, :h, :h] + x[:, :h, :h].transpose(0, 2, 1)) / 2
    return torch.from_numpy(x).to(dtype)


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("n", [5, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tsub_is_antisymmetric_up_to_the_sign_of_zero(dtype, n):
    """R[j][i] = -R[i][j] bit for bit wherever R is not zero (a rounding
    to nearest is symmetric under negation), and every zero of R is +0 on
    both sides (x - x), where -R^T would give -0: so the kernel subtracts
    for R[J, I] instead of negating R[I, J]^T."""
    r = kernels.tsub_plain(_x(3, n, dtype))
    neg = -r.mT
    nonzero = r != 0
    assert torch.equal(r, neg)
    assert torch.equal(_bits(r)[nonzero], _bits(neg.contiguous())[nonzero])
    assert (~nonzero).sum() > 3 * n and (_bits(r)[~nonzero] == 0).all()


@pytest.mark.parametrize("n", [7, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tsub_matches_the_jax_tiled_tsub_kernel(dtype, n):
    """The JAX route's kernel body on one whole-matrix block (its transposed
    spec reads block (0, 0) as the matrix itself) gives the bits of
    tsub_plain."""
    x = _x(2, n, dtype, seed=n)
    want = kernels.tsub_plain(x)
    for i in range(2):
        xi = jnp.asarray(x[i:i + 1].float().numpy()).astype(_JDT[dtype])
        out = np.empty((1, n, n), dtype=_JDT[dtype])
        pallas_kernels._tiled_tsub_kernel(xi, xi, out)
        got = torch.from_numpy(out.astype(np.float32)).to(dtype)
        assert torch.equal(_bits(got), _bits(want[i:i + 1]))


@pytest.mark.parametrize("in_dtype,out_dtype,copy16", [
    (torch.float32, torch.float32, False), (torch.float32, torch.float32, True),
    (torch.bfloat16, torch.float32, True), (torch.bfloat16, torch.bfloat16, False)])
def test_transpose_sub_plain_rounds_once(in_dtype, out_dtype, copy16):
    """Each instantiation the NS chains use: R is the f32 difference rounded
    once to the output dtype, R16 the same difference rounded once to bf16;
    in Q's dtype (tsub) R16 is R stored in bf16, and a bf16 input's f32 R
    rounds to tsub's bf16 R.  On the CPU the wrapper is the plain version."""
    x = _x(2, 9, in_dtype, seed=3)
    r, r16 = kernels.transpose_sub(x, out_dtype, copy16)
    diff = x.mT.float() - x.float()
    assert r.dtype == out_dtype and torch.equal(_bits(r), _bits(diff.to(out_dtype)))
    assert torch.equal(_bits(r.to(in_dtype)), _bits(kernels.tsub_plain(x)))
    if copy16:
        assert torch.equal(_bits(r16), _bits(r.to(torch.bfloat16)))
    else:
        assert r16 is None
