"""The corpus data (psgd_torch_tpu_torch.models.lm_data) against the JAX
package's psgd_torch_tpu.models.lm_data: ``load_tokens`` equal element for
element on the committed corpus at two vocab sizes (GPT-2's padded 50304
and 512), and ``corpus_batch`` given JAX's replayed ``randint`` starts
equal to JAX's windows.  Exact: both are integer arithmetic."""

import jax
import numpy as np
import pytest
import torch

from psgd_torch_tpu.models import lm_data as jlm
from psgd_torch_tpu_torch.models import lm_data


@pytest.mark.parametrize("vocab_size", [50304, 512])
def test_load_tokens_match_jax(vocab_size):
    ours = lm_data.load_tokens(vocab_size)
    ref = jlm.load_tokens(vocab_size)
    assert ours[2] == ref[2] <= vocab_size
    for a, b in zip(ours[:2], ref[:2]):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert ours[0].max() < vocab_size and ours[0].size > 4_000_000


@pytest.mark.parametrize("batch, seq_len", [(4, 64), (2, 1024)])
def test_corpus_batch_replays_jax_windows(batch, seq_len):
    train, _, _ = lm_data.load_tokens(512)
    key = jax.random.PRNGKey(7)
    jx, jy = jlm.corpus_batch(key, train, batch, seq_len)
    starts = np.array(jax.random.randint(key, (batch,), 0,
                                           train.size - seq_len - 1))
    x, y = lm_data.corpus_batch(None, train, batch, seq_len, device="cpu",
                                starts=starts)
    assert x.dtype == y.dtype == torch.int64 and x.shape == (batch, seq_len)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


def test_corpus_batch_draws_from_the_generator():
    """Windows from the generator: reproducible for a seed, next-token
    targets, inside the corpus."""
    train, _, _ = lm_data.load_tokens(512)
    draw = lambda seed: lm_data.corpus_batch(   # noqa: E731
        torch.Generator().manual_seed(seed), train, 3, 32, device="cpu")
    (x, y), (x2, y2), (x3, _) = draw(1), draw(1), draw(2)
    assert torch.equal(x, x2) and torch.equal(y, y2) and not torch.equal(x, x3)
    assert torch.equal(x[:, 1:], y[:, :-1])
    t = torch.from_numpy(train).to(torch.int64)
    for row, target in zip(x, y):
        hits = (t[:-32] == row[0]).nonzero().flatten()
        assert any(torch.equal(t[i:i + 32], row) and torch.equal(t[i + 1:i + 33], target)
                   for i in hits.tolist())
