"""The port's Hessian-vector products (psgd_torch_tpu_torch.optim.hvp)
against the JAX package's (psgd_torch_tpu.optim.hvp) on the tiny GPT-2 and
the tiny LLaMA with the same weights, tokens and probes: the port's double
backward against JAX's forward-over-reverse jvp, with and without
rematerialized blocks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import psgd_torch_tpu.optim as jopt
import test_torch_llama
from psgd_torch_tpu.models import gpt2 as jg
from psgd_torch_tpu.models import llama as jl
from psgd_torch_tpu_torch.models import gpt2 as tg
from psgd_torch_tpu_torch.models import llama as tl
from psgd_torch_tpu_torch.ops import fastrand
from psgd_torch_tpu_torch.optim import hvp
from test_torch_gpt2 import carried_pair, tokens
from test_torch_kron import jax_draw


def _problem(model_name, remat=False):
    """(JAX loss of params, JAX params, port closure, port params in JAX
    leaf order, f64 probes in that order) on one batch."""
    if model_name == "gpt2":
        params, cfgj, model = carried_pair(torch.float64, jnp.float64, remat=remat)
        assert model.cfg.remat == remat and cfgj.remat == remat
        x, y = tokens(1)
        jloss = lambda p: jg.loss_gpt2(p, jnp.asarray(x), jnp.asarray(y), cfgj)
        tloss = lambda: tg.loss_gpt2(model, torch.from_numpy(x), torch.from_numpy(y))
    else:
        params, cfgj, model = test_torch_llama.carried_pair(
            torch.float64, jnp.float64, remat=remat, tie_embeddings=False)
        assert model.cfg.remat == remat and cfgj.remat == remat
        x, y = test_torch_llama.tokens(1)
        jloss = lambda p: jl.loss_llama(p, jnp.asarray(x), jnp.asarray(y), cfgj)
        tloss = lambda: tl.loss_llama(model, torch.from_numpy(x), torch.from_numpy(y))
    named = dict(model.named_parameters())
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    tparams = [named[".".join(k.key for k in path)] for path, _ in flat]
    rng = np.random.default_rng(5)
    vs = [rng.standard_normal(np.shape(leaf)) for _, leaf in flat]
    jvs = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(v) for v in vs])
    return jloss, params, jvs, tloss, tparams, [torch.from_numpy(v) for v in vs]


def _close(got, ref, rtol):
    """Each leaf within rtol, with atol rtol x the leaf's largest entry."""
    for g, r in zip(got, jax.tree_util.tree_leaves(ref)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.detach().numpy(), r, rtol=rtol,
                                   atol=rtol * np.abs(r).max())


CASES = [("gpt2", False), ("gpt2", True), ("llama", False), ("llama", True)]


@pytest.mark.parametrize("model_name,remat", CASES)
def test_hvp_exact_matches_jax(model_name, remat):
    """f64 parameters; the models compute their logits (and LLaMA its
    RMSNorm and RoPE) in float32 on both sides, so the gradients agree to
    ~1e-7 relative and the Hvps to the same: each leaf within rtol 1e-5,
    atol 1e-5 x its largest entry.  Remat: the double backward goes
    through checkpoint(..., use_reentrant=False).  The parameters' .grad
    stay untouched."""
    jloss, params, jvs, tloss, tparams, vs = _problem(model_name, remat)
    jg_, jh = jopt.hvp_exact(jloss, params, jvs)
    grads, hvs = hvp.hvp_exact(tloss, tparams, vs)
    _close(grads, jg_, 1e-5)
    _close(hvs, jh, 1e-5)
    assert all(p.grad is None for p in tparams)
    assert all(h.dtype == torch.float64 and not h.requires_grad for h in hvs)


@pytest.mark.parametrize("model_name,remat", CASES)
def test_hvp_finite_diff_matches_jax(model_name, remat):
    """Finite differences with the same delta on both sides (1e-4: the
    default eps^(1/2) = 1.5e-8 would divide the float32 logits' rounding by
    1.5e-8 and compare noise): within rtol 5e-4 per leaf (atol 5e-4 x its
    largest entry), the float32 rounding over delta; and within 2e-2 of the
    exact Hvp (the truncation error of one difference).  The parameters
    get their bits back."""
    jloss, params, jvs, tloss, tparams, vs = _problem(model_name, remat)
    before = [p.detach().clone() for p in tparams]
    _, jh = jopt.hvp_finite_diff(jloss, params, jvs, delta=1e-4)
    _, hvs = hvp.hvp_finite_diff(tloss, tparams, vs, delta=1e-4)
    _close(hvs, jh, 5e-4)
    assert all(torch.equal(p.detach(), b) for p, b in zip(tparams, before))
    _, exact = hvp.hvp_exact(tloss, tparams, vs)
    num = sum(((a - b) ** 2).sum() for a, b in zip(hvs, exact)) ** 0.5
    den = sum((b ** 2).sum() for b in exact) ** 0.5
    assert (num / den).item() < 2e-2


def test_finite_diff_default_delta_matches_jax():
    """On a loss that is float64 throughout (a quartic in two leaves) the
    default delta = eps^(1/2) is the JAX package's: the two finite-difference
    Hvps agree within 1e-6 relative (round-off over delta), and both lie
    within 1e-5 of the exact one."""
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((5, 4)), rng.standard_normal(6)
    va, vb = rng.standard_normal((5, 4)), rng.standard_normal(6)
    jloss = lambda p: jnp.sum(p["a"] ** 4) + jnp.sum(p["a"]) * jnp.sum(p["b"] ** 2)
    ta, tb = (torch.from_numpy(x.copy()).requires_grad_() for x in (a, b))
    tloss = lambda: torch.sum(ta ** 4) + torch.sum(ta) * torch.sum(tb ** 2)
    params = {"a": jnp.asarray(a), "b": jnp.asarray(b)}
    jvs = {"a": jnp.asarray(va), "b": jnp.asarray(vb)}
    _, jh = jopt.hvp_finite_diff(jloss, params, jvs)
    _, th = hvp.hvp_finite_diff(tloss, [ta, tb], [torch.from_numpy(va),
                                                  torch.from_numpy(vb)])
    _, exact = hvp.hvp_exact(tloss, [ta, tb], [torch.from_numpy(va),
                                               torch.from_numpy(vb)])
    for got, ref, ex in zip(th, (jh["a"], jh["b"]), exact):
        ref, ex = np.asarray(ref), ex.numpy()
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())
        np.testing.assert_allclose(got.numpy(), ex, rtol=0, atol=1e-5 * np.abs(ex).max())


def test_rand_like_replays_the_jax_probe_keys():
    """One probe per leaf, keyed by split(key, n_leaves) in the JAX pytree
    order (rand_like_tree): with the JAX draws replayed the probes are the
    JAX package's bit for bit; without, each is the port's own unit noise
    (zero mean, unit variance) in the leaf's dtype."""
    from psgd_torch_tpu.optim.hvp import rand_like_tree
    tree = {"a": jnp.zeros((3, 4)), "b": jnp.zeros((5,)), "c": jnp.zeros((2, 2, 2))}
    ref = jax.tree_util.tree_leaves(rand_like_tree(jax.random.PRNGKey(9), tree))
    tensors = [torch.zeros(np.shape(x), dtype=torch.float64) for x in ref]
    got = hvp.rand_like(fastrand.prng_key(9), tensors, draw=jax_draw)
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))
    own = hvp.rand_like(fastrand.prng_key(9), [torch.zeros(256, 256)])[0]
    assert own.dtype == torch.float32
    assert abs(own.mean().item()) < 0.02 and abs(own.var().item() - 1.0) < 0.02


def test_hvp_pass_names_its_attention_backend():
    """The exact pass runs scaled_dot_product_attention under the math
    backend (the fused kernels' backward has no derivative); outside it
    the default backends are back."""
    from torch.nn.attention import SDPBackend
    seen = []
    orig = torch.nn.functional.scaled_dot_product_attention

    def spy(*a, **kw):
        seen.append(torch.backends.cuda.flash_sdp_enabled())
        return orig(*a, **kw)

    assert hvp.HVP_ATTENTION == SDPBackend.MATH
    jloss, params, jvs, tloss, tparams, vs = _problem("gpt2")
    torch.nn.functional.scaled_dot_product_attention = spy
    try:
        hvp.hvp_exact(tloss, tparams, vs)
        inside = list(seen)
        seen.clear()
        tloss()
    finally:
        torch.nn.functional.scaled_dot_product_attention = orig
    assert inside and not any(inside), inside
    assert seen and all(seen), seen
