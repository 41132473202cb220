"""KronWhiten(dq=...) and KronNewton(dq=...) for the six geometries besides
Q0.5EQ1.5: three steps of the tiny GPT-2 against the JAX package's
kron_whiten and kron_newton in float64 on replayed draws, every dQ
constructing and stepping, and the dQ checks and advisories of the JAX
transforms."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import psgd_torch_tpu.optim as jopt
from psgd_torch_tpu_torch.optim import KronNewton, KronWhiten, kron_newton
from psgd_torch_tpu_torch.precond import kron as tkron
from test_torch_kron import jax_draw
from test_torch_kron_newton import ARM as NEWTON_ARM
from test_torch_kron_newton import LR as NEWTON_LR
from test_torch_kron_whiten import BENCH, LR, MODELS


@pytest.mark.parametrize("dq", ["EQ", "PRO4P"])
def test_kron_whiten_dq_three_steps_match_jax(dq):
    """KronWhiten(dq=...) on the tiny GPT-2 in the bench configuration
    (f64 parameters and Q, p = 1, the JAX draws replayed) against
    kron_whiten(dq=...): parameters within 1e-5 of each leaf's largest
    entry, Q and L within rtol 1e-6 (the tolerances of
    test_torch_kron_whiten.test_three_steps_match_jax)."""
    pair, toks, jloss, jmask, tloss, tmask = MODELS["gpt2"]
    params, cfgj, model = pair(torch.float64, jnp.float64)
    x, y = toks(1)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jo = jopt.kron_whiten(learning_rate=LR, scanned_layers=jmask(params),
                              dq=dq, **BENCH)
        to = KronWhiten(model.named_parameters(), lr=LR, device="cpu",
                        scanned_layers=tmask(model), draw=jax_draw, dq=dq,
                        **BENCH)
    state = jo.init(params)
    grad = jax.jit(jax.grad(lambda p: jloss(p, jx, jy, cfgj)))
    update = jax.jit(jo.update)
    for _ in range(3):
        upd, state = update(grad(params), state, params)
        params = optax.apply_updates(params, upd)
        to.zero_grad()
        tloss(model, tx, ty).backward()
        to.step()
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


@pytest.mark.parametrize("dq", ["QEP", "QUAD"])
def test_kron_newton_dq_three_steps_match_jax(dq):
    """KronNewton(dq=...) on the tiny GPT-2 in the Newton arm (f64
    parameters and Q, p = 1, the JAX draws replayed, the JAX side fed an
    exact hvp_fn) against kron_newton(dq=...): parameters within 1e-5 of
    each leaf's largest entry, Q and L within rtol 1e-6 (the tolerances of
    test_torch_kron_newton.test_three_newton_steps_match_jax)."""
    pair, toks, jloss, jmask, tloss, tmask = MODELS["gpt2"]
    params, cfgj, model = pair(torch.float64, jnp.float64)
    x, y = toks(1)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jo = jopt.kron_newton(learning_rate=NEWTON_LR, scanned_layers=jmask(params),
                          dq=dq, **NEWTON_ARM)
    state = jo.init(params)
    loss_of = lambda p: jloss(p, jx, jy, cfgj)

    @jax.jit
    def jstep(p, s):
        upd, s = jo.update(jax.grad(loss_of)(p), s, p,
                           hvp_fn=jopt.make_hvp_fn(loss_of))
        return optax.apply_updates(p, upd), s

    with warnings.catch_warnings():
        warnings.simplefilter("error")       # an explicit scale: no advisory
        to = kron_newton(model.named_parameters(), learning_rate=NEWTON_LR,
                         device="cpu", scanned_layers=tmask(model),
                         draw=jax_draw, dq=dq, **NEWTON_ARM)
    for _ in range(3):
        params, state = jstep(params, state)
        to.step(lambda: tloss(model, tx, ty))
    assert to.fit_steps == 3
    got = dict(model.named_parameters())
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    precond = [s for s in state if hasattr(s, "precond")][0].precond
    for (path, ref), st in zip(flat, precond):
        leaf = ".".join(k.key for k in path)
        p = got[leaf]
        ref = np.asarray(ref)
        np.testing.assert_allclose(p.detach().numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=leaf)
        for a, b in zip(to.state[p]["q"], st.q):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                       atol=1e-6 * np.abs(b).max(), err_msg=leaf)
        for a, b in zip(to.state[p]["lips"], st.lips):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       err_msg=leaf)


# ---------------------------------------------------------------------------
# the dQ checks
# ---------------------------------------------------------------------------


def _tiny_params():
    return MODELS["gpt2"][0]()[2].named_parameters()


@pytest.mark.parametrize("dq", tkron.ALL_DQ + ("Q0p5EQ1p5",))
def test_every_dq_constructs_and_steps(dq):
    """KronWhiten and KronNewton accept every dQ that canonical_dq accepts
    (the alias included) and take a fit step on the tiny GPT-2 (f32, own
    draws) that moves the parameters and keeps them finite."""
    _, _, model = MODELS["gpt2"][0]()
    x, y = (torch.from_numpy(t) for t in MODELS["gpt2"][1](1))
    mask = MODELS["gpt2"][5](model)
    for cls in (KronWhiten, KronNewton):
        p0 = [p.detach().clone() for p in model.parameters()]
        opt = cls(model.named_parameters(), device="cpu", dq=dq,
                  preconditioner_init_scale=1.0, scanned_layers=mask)
        assert all(plan.dq == tkron.canonical_dq(dq) for plan in opt.plans)
        loss_fn = lambda: MODELS["gpt2"][4](model, x, y)
        if cls is KronNewton:
            opt.step(loss_fn)
        else:
            opt.zero_grad()
            loss_fn().backward()
            opt.step()
        assert opt.fit_steps == 1
        moved = [not torch.equal(p, q) for p, q in zip(model.parameters(), p0)]
        assert any(moved)
        assert all(torch.isfinite(p).all() for p in model.parameters())


def test_dq_checks_match_jax():
    """share_fit_apply with EQ and cache_p with QUAD4P or PRO4P raise
    ValueError on both packages; an unknown dQ raises ValueError."""
    share = dict(share_fit_apply=True, update_preconditioner_first=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for make in (lambda **kw: KronWhiten(_tiny_params(), device="cpu", **kw),
                     lambda **kw: jopt.scale_by_kron_whiten(**kw)):
            with pytest.raises(ValueError, match="EQ"):
                make(dq="EQ", **share)
            for dq in ("QUAD4P", "PRO4P"):
                with pytest.raises(ValueError, match="cache_p"):
                    make(dq=dq, cache_p=True)
            with pytest.raises(ValueError, match="dQ"):
                make(dq="XYZ")
        for dq in ("QUAD4P", "PRO4P"):
            with pytest.raises(ValueError, match="cache_p"):
                KronNewton(_tiny_params(), device="cpu", dq=dq, cache_p=True)
        KronWhiten(_tiny_params(), device="cpu", dq="QEP", **share)


def _warned(make) -> list:
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        make()
    return sorted(str(w.message).split()[0] for w in got)


@pytest.mark.parametrize("case", ["defaults", "momentum_whitening",
                                  "fit_p_bf16", "fit_p_f32", "quiet"])
def test_advisories_match_jax(case):
    """The construction warnings of JAX's _advisories, case by case: the
    on-the-fly init scale, momentum whitening, QUAD4P or PRO4P in half
    precision; none with an explicit scale, gradient whitening and f32 Q.
    KronNewton warns as scale_by_kron_newton does (gradient whitening, no
    momentum, by construction)."""
    kw = {"defaults": dict(),
          "momentum_whitening": dict(preconditioner_init_scale=1.0,
                                     momentum=0.9, whiten_grad=False),
          "fit_p_bf16": dict(preconditioner_init_scale=1.0, dq="PRO4P"),
          "fit_p_f32": dict(preconditioner_init_scale=1.0, dq="QUAD4P"),
          "quiet": dict(preconditioner_init_scale=1.0, dq="QEQ")}[case]
    qdt = {"fit_p_bf16": (torch.bfloat16, jnp.bfloat16),
           "fit_p_f32": (torch.float32, jnp.float32)}.get(case)
    tkw, jkw = dict(kw), dict(kw)
    if qdt is not None:
        tkw["preconditioner_dtype"], jkw["preconditioner_dtype"] = qdt
    port = _warned(lambda: KronWhiten(_tiny_params(), device="cpu", **tkw))
    ref = _warned(lambda: jopt.scale_by_kron_whiten(**jkw))
    assert port == ref
    assert len(port) == {"defaults": 1, "momentum_whitening": 1,
                         "fit_p_bf16": 1, "fit_p_f32": 0, "quiet": 0}[case]
    nkw = {k: v for k, v in tkw.items() if k not in ("momentum", "whiten_grad")}
    njkw = {k: v for k, v in jkw.items() if k not in ("momentum", "whiten_grad")}
    assert (_warned(lambda: KronNewton(_tiny_params(), device="cpu", **nkw))
            == _warned(lambda: jopt.scale_by_kron_newton(**njkw)))
