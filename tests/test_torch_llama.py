"""The port's LLaMA (psgd_torch_tpu_torch.models.llama) against the JAX
model: weights carried across with params_from_jax, then the same loss and
the same gradients (jax.grad against autograd) on the same tokens; GQA,
remat and the 1.1B leaf plan."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_torch_tpu.models import llama as jl
from psgd_torch_tpu.precond import kron as jkron
from psgd_torch_tpu_torch.models import llama as tl
from psgd_torch_tpu_torch.ops import kernels
from psgd_torch_tpu_torch.precond import kron as tkron


def carried_pair(dtype=torch.float32, jdtype=jnp.float32, seed=0, **kw):
    """(JAX params, JAX config, port model) holding the same weights, at
    the tiny config (kw overrides it)."""
    cfgj = jl.tiny_llama_config(compute_dtype=jdtype, param_dtype=jdtype, **kw)
    cfgt = tl.tiny_llama_config(compute_dtype=dtype, param_dtype=dtype, **kw)
    params = jl.init_llama(jax.random.PRNGKey(seed), cfgj)
    model = tl.Llama(cfgt, device="cpu")
    model.load_state_dict(tl.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return params, cfgj, model


def tokens(seed=0, batch=2, cfg=None):
    cfg = cfg or tl.tiny_llama_config()
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (batch, cfg.block_size)),
            rng.integers(0, cfg.vocab_size, (batch, cfg.block_size)))


@pytest.mark.parametrize("tied", [True, False])
def test_loss_and_gradients_match_jax(tied):
    """f64 parameters and compute on both sides.  The JAX model computes
    RMSNorm, RoPE and the logits in float32 whatever the compute dtype (and
    the port does the same), so they agree to f32 rounding: loss within
    rtol 1e-6; each gradient leaf within rtol 1e-5 with atol 1e-5 x the
    leaf's largest entry."""
    params, cfgj, model = carried_pair(torch.float64, jnp.float64,
                                       tie_embeddings=tied)
    x, y = tokens()
    lj, gj = jax.value_and_grad(jl.loss_llama)(params, jnp.asarray(x),
                                               jnp.asarray(y), cfgj)
    lt = tl.loss_llama(model, torch.from_numpy(x), torch.from_numpy(y))
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-6)
    grads = dict(model.named_parameters())
    flat = jax.tree_util.tree_flatten_with_path(gj)[0]
    assert len(flat) == len(grads)
    for path, g in flat:
        name = ".".join(k.key for k in path)
        ref = np.asarray(g)
        got = grads[name].grad.numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=name)


def test_layout_mask_and_count():
    for tied in (True, False):
        params, _, model = carried_pair(tie_embeddings=tied)
        names = [n for n, _ in model.named_parameters()]
        jnames = [".".join(k.key for k in p) for p, _ in
                  jax.tree_util.tree_flatten_with_path(params)[0]]
        assert sorted(names) == sorted(jnames)
        assert ("lm_head" in names) == (not tied)
        cfg = model.cfg
        assert model.blocks["wqkv"].shape == (2, 64, cfg.qkv_dim) == (2, 64, 96)
        assert model.blocks["w_gu"].shape == (2, 64, 2 * 176)
        mask = tl.scanned_layers_mask(model)
        assert all(mask[n] == n.startswith("blocks.") for n in names)
        assert tl.count_params(model) == jl.count_params(params)


def test_gqa_matches_repeated_kv_mha():
    """Query head j reads kv head j // (h / kv): GQA equals MHA on the kv
    heads repeated over their query groups (repeat_interleave), and equals
    the JAX model's attention on the same inputs (f64, atol 1e-12)."""
    rng = np.random.default_rng(3)
    b, t, h, kv, hd = 2, 8, 4, 1, 16
    q, k, v = (rng.standard_normal((b, t, n, hd)) for n in (h, kv, kv))
    tq, tk, tv = (torch.from_numpy(z) for z in (q, k, v))
    gqa = tl.attention(tq, tk, tv)
    mha = tl.attention(tq, tk.repeat_interleave(h, dim=2),
                       tv.repeat_interleave(h, dim=2))
    torch.testing.assert_close(gqa, mha, rtol=0, atol=1e-12)
    ref = jax.nn.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), is_causal=True)
    np.testing.assert_allclose(gqa.numpy(), np.asarray(ref), atol=1e-6)
    # two kv heads: the first two query heads read kv head 0
    k2, v2 = (torch.from_numpy(rng.standard_normal((b, t, 2, hd)))
              for _ in range(2))
    out = tl.attention(tq, k2, v2)
    head0 = tl.attention(tq[:, :, :2], k2[:, :, :1], v2[:, :, :1])
    torch.testing.assert_close(out[:, :, :2], head0, rtol=0, atol=1e-12)


def test_rope_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 16, 2, 32)).astype(np.float32)
    got = tl._rope(torch.from_numpy(x), 10000.0)
    ref = jl._rope(jnp.asarray(x), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_remat_value_parity():
    """Rematerialized blocks give the same loss and gradients, bit for
    bit: the recomputed forward is the same arithmetic."""
    _, _, model = carried_pair()
    _, _, remat = carried_pair(remat=True)
    x, y = (torch.from_numpy(t) for t in tokens(1))
    losses = []
    for m in (model, remat):
        loss = tl.loss_llama(m, x, y)
        loss.backward()
        losses.append(loss)
    assert torch.equal(losses[0], losses[1])
    for (n, a), (_, b) in zip(model.named_parameters(),
                              remat.named_parameters()):
        assert torch.equal(a.grad, b.grad), n


def test_configs_match_jax():
    for tcfg, jcfg in ((tl.llama_1b(), jl.llama_1b()),
                       (tl.llama_7b(), jl.llama_7b()),
                       (tl.tiny_llama_config(), jl.tiny_llama_config())):
        for f in ("vocab_size", "block_size", "n_layer", "n_head",
                  "n_kv_head", "n_embd", "hidden_dim", "rope_theta",
                  "remat", "tie_embeddings"):
            assert getattr(tcfg, f) == getattr(jcfg, f), f
        assert tcfg.head_dim == jcfg.head_dim
        assert tcfg.qkv_dim == jcfg.qkv_dim


def _1b_leaves():
    """The 1.1B model's leaves, per layer for the stacked ones."""
    cfg = tl.llama_1b()
    d, h = cfg.n_embd, cfg.hidden_dim
    return {"wte": (cfg.vocab_size, d), "lm_head": (d, cfg.vocab_size),
            "rmsf_scale": (d,), "rms1_scale": (d,), "rms2_scale": (d,),
            "wqkv": (d, cfg.qkv_dim), "wo": (cfg.n_head * cfg.head_dim, d),
            "w_gu": (d, 2 * h), "w_down": (h, d)}


def test_1b_leaf_plan_and_routes():
    """The 1.1B leaves at the bench's max_skew 2: the same dense/diagonal
    plan as the JAX package, and with bf16 Q one fit step runs 7 split NS
    updates (width 2048) and 1 tiled one (wqkv's 2560), none on the
    single route."""
    routes = []
    for name, shape in _1b_leaves().items():
        tp = tkron.make_kron_plan(shape, max_skew=2.0)
        jp = jkron.make_kron_plan(shape, max_skew=2.0)
        assert tp.is_diag == jp.is_diag, name
        routes += [kernels.ns_route(n, torch.bfloat16)
                   for n, diag in zip(shape, tp.is_diag) if not diag]
    assert sorted(routes) == ["split"] * 7 + ["tiled"]
