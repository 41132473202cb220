"""The slices as a whole: the tiny GPT-2 and the tiny LLaMA trained by the
port's KronWhiten against the same models trained by
psgd_torch_tpu.optim.kron_whiten."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import psgd_torch_tpu.optim as jopt
import test_torch_llama
from psgd_torch_tpu.models import gpt2 as jg
from psgd_torch_tpu.models import llama as jl
from psgd_torch_tpu_torch.models import gpt2 as tg
from psgd_torch_tpu_torch.models import llama as tl
from psgd_torch_tpu_torch.optim import KronWhiten
from test_torch_gpt2 import carried_pair, tokens
from test_torch_kron import jax_draw

# the bench configuration (bench.py:170-177) with float in place of bf16
BENCH = dict(momentum=0.9, whiten_grad=False, preconditioner_max_skew=2.0,
             preconditioner_init_scale=1.0, norm_k=128, weight_decay=0.01)
LR = 1e-3 / 4

CONFIGS = {
    "bench_fit_first": dict(BENCH),
    "bench_apply_first": dict(BENCH, update_preconditioner_first=False),
    "grad_whitening_classic_wd": dict(
        momentum=0.0, whiten_grad=True, preconditioner_init_scale=None,
        preconditioner_max_skew=2.0, norm_k=128, weight_decay=0.01,
        weight_decay_mode="classic"),
    # the tiny LLaMA (GQA, RoPE, SwiGLU, tied head) in the bench configuration
    "llama_bench_fit_first": dict(BENCH, model="llama"),
}

# (carried pair, tokens, JAX loss, JAX mask, port loss, port mask) per model
MODELS = {
    "gpt2": (carried_pair, tokens, jg.loss_gpt2, jg.scanned_layers_mask,
             tg.loss_gpt2, tg.scanned_layers_mask),
    "llama": (test_torch_llama.carried_pair, test_torch_llama.tokens,
              jl.loss_llama, jl.scanned_layers_mask, tl.loss_llama,
              tl.scanned_layers_mask),
}


def _port_step(model, opt, x, y, loss_fn=tg.loss_gpt2):
    opt.zero_grad()
    loss = loss_fn(model, x, y)
    loss.backward()
    opt.step()
    return loss.item()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_three_steps_match_jax(name):
    """f64 parameters and Q on both sides, p = 1.0, the JAX draws replayed.
    Both sides of each model compute float32 logits, so their gradients agree to ~1e-7
    relative: parameters within 1e-5 of each leaf's largest entry, Q and L
    within rtol 1e-6."""
    kw = dict(CONFIGS[name])
    pair, toks, jloss, jmask, tloss, tmask = MODELS[kw.pop("model", "gpt2")]
    params, cfgj, model = pair(torch.float64, jnp.float64)
    x, y = toks(1)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jo = jopt.kron_whiten(learning_rate=LR, scanned_layers=jmask(params), **kw)
    state = jo.init(params)
    grad = jax.jit(jax.grad(lambda p: jloss(p, jx, jy, cfgj)))
    update = jax.jit(jo.update)
    to = KronWhiten(model.named_parameters(), lr=LR, device="cpu",
                    scanned_layers=tmask(model), draw=jax_draw, **kw)
    for _ in range(3):
        upd, state = update(grad(params), state, params)
        params = optax.apply_updates(params, upd)
        _port_step(model, to, tx, ty, tloss)
    assert to.fit_steps == 3
    got = dict(model.named_parameters())
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    precond = [s for s in state if hasattr(s, "precond")][0].precond
    for (path, ref), st in zip(flat, precond):
        name = ".".join(k.key for k in path)
        p = got[name]
        ref = np.asarray(ref)
        np.testing.assert_allclose(p.detach().numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=name)
        for a, b in zip(to.state[p]["q"], st.q):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                       atol=1e-6 * np.abs(b).max(), err_msg=name)
        for a, b in zip(to.state[p]["lips"], st.lips):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       err_msg=name)


def test_gate_fits_at_the_drawn_steps():
    """p = 0.1: the port fits exactly on the steps where the JAX key chain's
    float32 gate uniform is below 0.1, and Q is untouched otherwise."""
    _, _, model = carried_pair()
    x, y = (torch.from_numpy(t) for t in tokens(2))
    opt = KronWhiten(model.named_parameters(), lr=LR, device="cpu", seed=3,
                     preconditioner_update_probability=0.1,
                     scanned_layers=tg.scanned_layers_mask(model), **BENCH)
    key = jax.random.PRNGKey(3)
    expected, fits = [], []
    first = next(iter(model.parameters()))
    for _ in range(40):
        key, k_gate, _ = jax.random.split(key, 3)
        expected.append(bool(jax.random.uniform(k_gate, dtype=jnp.float32) < 0.1))
        q_before = opt.state[first]["q"][0].clone()
        n0 = opt.fit_steps
        _port_step(model, opt, x, y)
        fits.append(opt.fit_steps > n0)
        assert torch.equal(q_before, opt.state[first]["q"][0]) != fits[-1]
    assert fits == expected
    assert 0 < sum(fits) < 40


def test_bf16_state_tracks_f32_loosely():
    """bf16 Q and momentum against f32 Q and momentum, same seeds and own
    draws, 3 steps: the total parameter change agrees within 5%
    (Frobenius-relative over all leaves; bf16 keeps ~3 digits)."""
    changes = []
    for qdt in (torch.float32, torch.bfloat16):
        _, _, model = carried_pair()
        p0 = [p.detach().clone() for p in model.parameters()]
        opt = KronWhiten(model.named_parameters(), lr=LR, device="cpu",
                         preconditioner_dtype=qdt, momentum_dtype=qdt,
                         scanned_layers=tg.scanned_layers_mask(model), **BENCH)
        x, y = (torch.from_numpy(t) for t in tokens(3))
        for _ in range(3):
            _port_step(model, opt, x, y)
        assert opt.state[next(iter(model.parameters()))]["q"][0].dtype == qdt
        changes.append(torch.cat([(p.detach() - q).flatten() for p, q in
                                  zip(model.parameters(), p0)]))
    rel = ((changes[1] - changes[0]).norm() / changes[0].norm()).item()
    assert rel < 0.05, rel


def test_decoupled_weight_decay_on_every_leaf():
    """With zero gradients the momentum and the whitened update stay zero,
    so every leaf, biases and LayerNorm included, moves by -lr * wd * p."""
    _, _, model = carried_pair()
    opt = KronWhiten(model.named_parameters(), lr=0.5, device="cpu",
                     scanned_layers=tg.scanned_layers_mask(model),
                     **dict(BENCH, weight_decay=0.1))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()
    for n, p in model.named_parameters():
        want = before[n] + (0.1 * before[n]) * -0.5
        assert torch.equal(p.detach(), want), n
    assert model.lnf_scale.detach().max() < 1.0


def test_unported_options_raise():
    _, _, model = carried_pair()
    # stack_sharding and factor_sharding are ported
    # (tests/test_torch_parallel.py, tests/test_torch_factor_sharding.py); a
    # factor_sharding map that names no parameter is refused
    with pytest.raises(ValueError, match="placements do not match params"):
        KronWhiten(model.named_parameters(), device="cpu",
              factor_sharding=("mesh", {}))
    # a geometry other than Q0.5EQ1.5 constructs and steps
    x, y = (torch.from_numpy(t) for t in tokens(1))
    quad = KronWhiten(model.named_parameters(), device="cpu", dq="QUAD",
                      preconditioner_init_scale=1.0)
    _port_step(model, quad, x, y)
    assert quad.plans[0].dq == "QUAD" and quad.fit_steps == 1
    assert all(torch.isfinite(p).all() for p in model.parameters())
    with pytest.raises(ValueError):
        KronWhiten(model.named_parameters(), device="cpu", whiten_grad=False)
