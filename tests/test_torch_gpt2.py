"""The port's GPT-2 (psgd_torch_tpu_torch.models.gpt2) against the JAX
model: weights carried across with params_from_jax, then the same loss and
the same gradients (jax.grad against autograd) on the same tokens."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_torch_tpu.models import gpt2 as jg
from psgd_torch_tpu.precond import kron as jkron
from psgd_torch_tpu_torch.models import gpt2 as tg
from psgd_torch_tpu_torch.ops import kernels
from psgd_torch_tpu_torch.precond import kron as tkron

TINY = dict(n_layer=2, n_head=4, n_embd=128, block_size=64, vocab_size=512)


def carried_pair(dtype=torch.float32, jdtype=jnp.float32, seed=0, **kw):
    """(JAX params, JAX config, port model) holding the same weights, at
    the tiny config (kw overrides it, on both sides)."""
    cfgj = jg.tiny_config(compute_dtype=jdtype, param_dtype=jdtype, **TINY, **kw)
    cfgt = tg.tiny_config(compute_dtype=dtype, param_dtype=dtype, **TINY, **kw)
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


@pytest.mark.parametrize("name", ["gpt2_350m", "gpt2_774m"])
def test_large_config_matches_jax(name):
    """Every field but the dtypes; remat off by default and passed through."""
    a, b = getattr(tg, name)(), getattr(jg, name)()
    for f in ("vocab_size", "block_size", "n_layer", "n_head", "n_embd", "remat"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.remat is False and a.head_dim == b.head_dim
    assert getattr(tg, name)(remat=True).remat is True


@pytest.mark.parametrize("name,count", [("gpt2_350m", 354_871_296),
                                        ("gpt2_774m", 774_090_240)])
def test_large_shapes_plans_and_routes_match_jax(name, count):
    """Without building either model: the parameter names and shapes
    (``param_shapes``) equal ``jax.eval_shape(init_gpt2)``'s leaves, their
    count JAX's; each leaf's Kron plan at max_skew 2 (per layer for the
    stacks) is JAX ``make_kron_plan``'s, and every dense factor takes the
    single NS route in bf16 (1024 and 1280 wide)."""
    cfgj = getattr(jg, name)()
    shapes = tg.param_shapes(getattr(tg, name)())
    tree = jax.eval_shape(lambda: jg.init_gpt2(jax.random.PRNGKey(0), cfgj))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert shapes == {".".join(k.key for k in path): tuple(leaf.shape)
                      for path, leaf in flat}
    assert sum(math.prod(s) for s in shapes.values()) == count
    dense = set()
    for n, shape in shapes.items():
        per = shape[1:] if n.startswith("blocks.") else shape
        tp = tkron.make_kron_plan(per, max_skew=2.0)
        jp = jkron.make_kron_plan(per, max_skew=2.0)
        assert tp.is_diag == jp.is_diag, n
        dense |= {d for d, diag in zip(per, tp.is_diag) if not diag}
    d = cfgj.n_embd
    assert dense == {d, cfgj.block_size}
    assert all(kernels.ns_route(w, torch.bfloat16) == "single" for w in dense)


def test_param_shapes_are_the_models():
    _, _, model = carried_pair()
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == \
        tg.param_shapes(model.cfg)


def test_remat_is_bit_for_bit_and_matches_jax():
    """The tiny model with remat: the loss and every gradient bit for bit
    the same model's without remat (f32); in f64 against JAX
    ``remat=True`` at the tolerance of the test above (JAX takes its
    attention's softmax in float32)."""
    out = []
    for remat in (False, True):
        _, _, model = carried_pair(remat=remat)
        assert model.cfg.remat is remat
        x, y = (torch.from_numpy(t) for t in tokens())
        loss = tg.loss_gpt2(model, x, y)
        loss.backward()
        out.append((loss, [p.grad for p in model.parameters()]))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    params, cfgj, model = carried_pair(torch.float64, jnp.float64, remat=True)
    assert cfgj.remat
    x, y = tokens(3)
    lj, gj = jax.value_and_grad(jg.loss_gpt2)(params, jnp.asarray(x),
                                              jnp.asarray(y), cfgj)
    lt = tg.loss_gpt2(model, torch.from_numpy(x), torch.from_numpy(y))
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    grads = dict(model.named_parameters())
    for path, g in jax.tree_util.tree_flatten_with_path(gj)[0]:
        name, ref = ".".join(k.key for k in path), np.asarray(g)
        np.testing.assert_allclose(grads[name].grad.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=name)


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
