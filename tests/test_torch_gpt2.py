"""The port's GPT-2 (psgd_torch_tpu_torch.models.gpt2) against the JAX
model: weights carried across with params_from_jax, then the same loss and
the same gradients (jax.grad against autograd) on the same tokens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_torch_tpu.models import gpt2 as jg
from psgd_torch_tpu_torch.models import gpt2 as tg

TINY = dict(n_layer=2, n_head=4, n_embd=128, block_size=64, vocab_size=512)


def carried_pair(dtype=torch.float32, jdtype=jnp.float32, seed=0):
    """(JAX params, JAX config, port model) holding the same weights."""
    cfgj = jg.tiny_config(compute_dtype=jdtype, param_dtype=jdtype, **TINY)
    cfgt = tg.tiny_config(compute_dtype=dtype, param_dtype=dtype, **TINY)
    params = jg.init_gpt2(jax.random.PRNGKey(seed), cfgj)
    model = tg.GPT2(cfgt, device="cpu")
    model.load_state_dict(tg.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return params, cfgj, model


def tokens(seed=0, batch=2):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, TINY["vocab_size"], (batch, TINY["block_size"])),
            rng.integers(0, TINY["vocab_size"], (batch, TINY["block_size"])))


def test_loss_and_gradients_match_jax():
    """f32 compute on both sides.  Loss within rtol 1e-5; each gradient
    leaf within rtol 1e-5 with atol 1e-5 x the leaf's largest entry (f32
    sums taken in another order)."""
    params, cfgj, model = carried_pair()
    x, y = tokens()
    lj, gj = jax.value_and_grad(jg.loss_gpt2)(params, jnp.asarray(x),
                                              jnp.asarray(y), cfgj)
    lt = tg.loss_gpt2(model, torch.from_numpy(x), torch.from_numpy(y))
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    grads = dict(model.named_parameters())
    flat = jax.tree_util.tree_flatten_with_path(gj)[0]
    assert len(flat) == len(grads)
    for path, g in flat:
        name = ".".join(k.key for k in path)
        ref = np.asarray(g)
        got = grads[name].grad.numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=name)


def test_layout_and_mask():
    params, _, model = carried_pair()
    names = [n for n, _ in model.named_parameters()]
    jnames = [".".join(k.key for k in p) for p, _ in
              jax.tree_util.tree_flatten_with_path(params)[0]]
    assert sorted(names) == sorted(jnames)
    assert model.blocks["attn_qkv_w"].shape == (2, 128, 384)
    mask = tg.scanned_layers_mask(model)
    assert all(mask[n] == n.startswith("blocks.") for n in names)
    assert sum(p.numel() for p in model.parameters()) == jg.count_params(params)


def test_gpt2_124m_config_matches_jax():
    a, b = tg.gpt2_124m(), jg.gpt2_124m()
    for f in ("vocab_size", "block_size", "n_layer", "n_head", "n_embd"):
        assert getattr(a, f) == getattr(b, f)


def test_synthetic_lm_batch():
    """Shapes, targets shifted by one, and the mixing rule: about 80% of the
    next tokens follow x -> (31 x + 7) mod vocab."""
    gen = torch.Generator().manual_seed(0)
    x, y = tg.synthetic_lm_batch(gen, 4, 256, 1000, device="cpu")
    assert x.shape == y.shape == (4, 256)
    assert torch.equal(x[:, 1:], y[:, :-1])
    follows = (y == (x * 31 + 7) % 1000).float().mean().item()
    assert 0.75 < follows < 0.85
    x2, _ = tg.synthetic_lm_batch(torch.Generator().manual_seed(0), 4, 256,
                                  1000, device="cpu")
    assert torch.equal(x, x2)
