"""The options of the port's KronWhiten (share_fit_apply, cache_p,
pipelined_fit, shared_layers) and KronNewton (cache_p, shared_layers),
and the Kron functions they run (apply_all_factors, compute_p_factors,
precond_grad_cached, the fit's return_pg), against the JAX package on
replayed draws, in float64; with the JAX transforms' validation."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import psgd_torch_tpu.optim as jopt
from psgd_torch_tpu.precond import kron as jkron
from psgd_torch_tpu_torch.ops import fastrand
from psgd_torch_tpu_torch.optim import KronWhiten, kron_newton, kron_whiten
from psgd_torch_tpu_torch.precond import kron as tkron
from test_torch_kron import jax_draw, to_np
from test_torch_kron_newton import ARM
from test_torch_kron_whiten import BENCH, LR, MODELS

# a constant schedule: the transforms then draw the fit gate every step
HALF = lambda count: 0.5  # noqa: E731
APPLY_FIRST = dict(BENCH, update_preconditioner_first=False)

# (options, seed, fit steps of the three); with HALF the seeds' replayed
# gate uniforms are 0.959, 0.353, 0.797 (seed 8) and 0.081, 0.671, 0.352
# (seed 0)
WHITEN = {
    "share_fit_apply_momentum": (dict(APPLY_FIRST, share_fit_apply=True), 0, 3),
    "share_fit_apply_grad": (dict(
        momentum=0.0, whiten_grad=True, update_preconditioner_first=False,
        share_fit_apply=True, preconditioner_init_scale=None,
        preconditioner_max_skew=2.0, norm_k=128, weight_decay=0.01,
        weight_decay_mode="classic"), 0, 3),
    # step 0 applies through the cache refreshed after the on-the-fly scale
    "cache_p_gated_init_none": (dict(
        BENCH, cache_p=True, preconditioner_init_scale=None,
        preconditioner_update_probability=HALF), 8, 1),
    "cache_p_share_fit_apply_gated": (dict(
        APPLY_FIRST, cache_p=True, share_fit_apply=True,
        preconditioner_update_probability=HALF), 8, 1),
    # step 0's buffer is zeros: fits at steps 1 and 2
    "pipelined_literal_p1": (dict(BENCH, pipelined_fit=True), 0, 2),
    # the count > 0 gate and a no-fit step 1, then a fit at step 2 whose
    # apply reads the factors (cached) from before it
    "pipelined_gated_apply_first_cached": (dict(
        APPLY_FIRST, pipelined_fit=True, cache_p=True,
        preconditioner_update_probability=HALF), 0, 1),
    "shared_layers_gpt2": (dict(BENCH, shared_layers=True), 0, 3),
    "shared_layers_llama": (dict(BENCH, shared_layers=True, model="llama"), 0, 3),
}
NEWTON = {
    # count 0 fits, then the gate: fit, no fit (applied through the cache)
    "newton_cache_p_gated_init_none": (dict(
        ARM, cache_p=True, preconditioner_init_scale=None,
        preconditioner_update_probability=HALF), 8, 2),
    "newton_shared_layers": (dict(ARM, shared_layers=True), 0, 3),
}


def _jax_state(state):
    return [s for s in state if hasattr(s, "precond")][0]


def _compare(model, to, params, state):
    """Parameters within 1e-5 of each leaf's largest entry; Q, L and the
    cache within rtol 1e-6 (the tolerances of test_three_steps_match_jax)."""
    got = dict(model.named_parameters())
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    js = _jax_state(state)
    caches = js.pcache if to.cache_p else [()] * len(flat)
    for (path, ref), st, pc in zip(flat, js.precond, caches):
        name = ".".join(k.key for k in path)
        p = got[name]
        ref = np.asarray(ref)
        np.testing.assert_allclose(p.detach().numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=name)
        ts = to.state[p]
        pairs = list(zip(ts["q"], st.q)) + list(zip(ts.get("pcache", ()), pc))
        assert len(ts["q"]) == len(st.q) and len(ts.get("pcache", ())) == len(pc)
        for a, b in pairs:
            b = np.asarray(b)
            assert a.shape == b.shape, name
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                       atol=1e-6 * np.abs(b).max(), err_msg=name)
        for a, b in zip(ts["lips"], st.lips):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       err_msg=name)


def _setup(kw):
    pair, toks, jloss, jmask, tloss, tmask = MODELS[kw.pop("model", "gpt2")]
    params, cfgj, model = pair(torch.float64, jnp.float64)
    x, y = toks(1)
    jl = lambda p: jloss(p, jnp.asarray(x), jnp.asarray(y), cfgj)  # noqa: E731
    tl = lambda: tloss(model, torch.from_numpy(x), torch.from_numpy(y))  # noqa: E731
    return params, jl, jmask, model, tl, tmask


@pytest.mark.parametrize("name", sorted(WHITEN))
def test_whiten_options_match_jax(name):
    """Three steps of the tiny GPT-2 (or LLaMA) in f64, the JAX draws and
    gates replayed, against psgd_torch_tpu.optim.kron_whiten with the same
    options; the port fits on the same steps."""
    kw, seed, fits = WHITEN[name]
    params, jl, jmask, model, tl, tmask = _setup(dict(kw))
    kw = {k: v for k, v in kw.items() if k != "model"}
    jo = jopt.kron_whiten(learning_rate=LR, seed=seed,
                          scanned_layers=jmask(params), **kw)
    state = jo.init(params)
    grad, update = jax.jit(jax.grad(jl)), jax.jit(jo.update)
    to = kron_whiten(model.named_parameters(), learning_rate=LR, seed=seed,
                     device="cpu", scanned_layers=tmask(model), draw=jax_draw,
                     **kw)
    for _ in range(3):
        upd, state = update(grad(params), state, params)
        params = optax.apply_updates(params, upd)
        to.zero_grad()
        tl().backward()
        to.step()
    assert to.fit_steps == fits
    _compare(model, to, params, state)


@pytest.mark.parametrize("name", sorted(NEWTON))
def test_newton_options_match_jax(name):
    """As the whitening cases, against psgd_torch_tpu.optim.kron_newton fed
    an exact hvp_fn."""
    kw, seed, fits = NEWTON[name]
    params, jl, jmask, model, tl, tmask = _setup(dict(kw))
    jo = jopt.kron_newton(learning_rate=1e-3, seed=seed,
                          scanned_layers=jmask(params), **kw)
    state = jo.init(params)

    @jax.jit
    def jstep(p, s):
        upd, s = jo.update(jax.grad(jl)(p), s, p, hvp_fn=jopt.make_hvp_fn(jl))
        return optax.apply_updates(p, upd), s

    to = kron_newton(model.named_parameters(), learning_rate=1e-3, seed=seed,
                     device="cpu", scanned_layers=tmask(model), draw=jax_draw,
                     **kw)
    for _ in range(3):
        params, state = jstep(params, state)
        to.step(tl)
    assert to.fit_steps == fits
    _compare(model, to, params, state)


def test_shared_plans_pool_the_stack():
    """A shared stack is one plan over the whole tensor, its layer axis a
    forced diagonal, and takes its state and keys as one tensor: the tiny
    GPT-2's (2, 128, 384) qkv stack gets (2,), (128, 128) and (384, 384)
    factors where each layer had (128, 128) and a (384,) diagonal."""
    _, _, model = MODELS["gpt2"][0]()
    mask = MODELS["gpt2"][5](model)
    per = KronWhiten(model.named_parameters(), device="cpu", scanned_layers=mask,
                     **BENCH)
    shared = KronWhiten(model.named_parameters(), device="cpu",
                        scanned_layers=mask, shared_layers=True, **BENCH)
    w = model.blocks["attn_qkv_w"]
    assert [tuple(q.shape) for q in per.state[w]["q"]] == [(2, 128, 128), (2, 384)]
    assert [tuple(q.shape) for q in shared.state[w]["q"]] == [(2,), (128, 128),
                                                              (384, 384)]
    i = [p is w for p in shared.param_groups[0]["params"]].index(True)
    assert shared.plans[i].is_diag == (True, False, False)
    assert shared.shared[i] and not shared.scanned[i] and per.scanned[i]
    # the same through a dict and a sequence in the given order
    names = [n for n, _ in model.named_parameters()]
    for flags in ({n: mask[n] for n in names}, [mask[n] for n in names]):
        again = KronWhiten(model.named_parameters(), device="cpu",
                           scanned_layers=mask, shared_layers=flags, **BENCH)
        assert again.shared == shared.shared and again.plans == shared.plans


# ---------------------------------------------------------------------------
# the Kron functions, orders 0-4
# ---------------------------------------------------------------------------

# (shape, max_skew): a scalar, a diagonal, dense x dense, dense x diagonal,
# all dense, and order 4 with dense dims and a diagonal 30 (30^2 > 720)
SHAPES = [((), 1.0), ((6,), 1.0), ((12, 20), 2.0), ((16, 40), 1.0),
          ((3, 4, 5), float("inf")), ((2, 3, 4, 30), 1.0)]


def _state(shape, skew, seed, batch=None):
    """Random factors (not identity), numpy, per tensor or stacked."""
    rng = np.random.default_rng(seed)
    plan = tkron.make_kron_plan(shape, max_skew=skew)
    lead = () if batch is None else (batch,)
    qs = []
    for n, diag in zip(plan.shape or (1,), plan.is_diag):
        if not plan.shape:
            qs.append(np.asarray(1.0 + 0.1 * rng.standard_normal(lead)))
        elif diag:
            qs.append(1.0 + 0.1 * rng.standard_normal(lead + (n,)))
        else:
            qs.append(np.eye(n) + 0.1 * rng.standard_normal(lead + (n, n)))
    lips = [np.abs(rng.standard_normal(lead)) + 0.5 for _ in qs]
    g = rng.standard_normal(lead + shape)
    ts = tkron.KronState(q=tuple(torch.from_numpy(np.asarray(q)) for q in qs),
                         lips=tuple(torch.from_numpy(np.asarray(x)) for x in lips))
    js = jkron.KronState(q=tuple(jnp.asarray(q) for q in qs),
                         lips=tuple(jnp.asarray(x) for x in lips))
    return plan, jkron.make_kron_plan(shape, max_skew=skew), ts, js, g


def _close(a, b, rtol=1e-12):
    b = np.asarray(b)
    np.testing.assert_allclose(to_np(a), b, rtol=rtol,
                               atol=rtol * max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("stacked", [False, True], ids=["tensor", "stack"])
@pytest.mark.parametrize("shape,skew", SHAPES)
def test_cached_apply_functions_match_jax(shape, skew, stacked):
    """apply_all_factors, compute_p_factors and precond_grad_cached against
    JAX's (vmapped over a stack of 3, as the JAX transform takes them), f64
    within rtol 1e-12; and the cached apply equals precond_grad."""
    plan, jplan, ts, js, g = _state(shape, skew, len(shape),
                                    3 if stacked else None)
    tg = torch.from_numpy(g)
    vm = jax.vmap if stacked else (lambda f: f)
    if stacked:
        fns = (tkron.apply_all_factors_stacked, tkron.precond_grad_cached_stacked,
               tkron.precond_grad_stacked)
    else:
        fns = (tkron.apply_all_factors, tkron.precond_grad_cached,
               tkron.precond_grad)
    _close(fns[0](ts, plan, tg),
           vm(lambda s, x: jkron.apply_all_factors(s, jplan, x))(js, g))
    pc = tkron.compute_p_factors(ts, plan)
    jpc = vm(lambda s: jkron.compute_p_factors(s, jplan))(js)
    assert len(pc) == len(jpc)
    for a, b in zip(pc, jpc):
        assert a.shape == b.shape
        _close(a, b)
    cached = fns[1](pc, plan, tg)
    _close(cached, vm(lambda p, x: jkron.precond_grad_cached(p, jplan, x))(jpc, g))
    _close(cached, to_np(fns[2](ts, plan, tg)), rtol=1e-10)


# a scalar and order 4 per tensor, dense x diagonal and a diagonal stacked
# (the fit itself is held at orders 0-3 in test_torch_kron.py)
@pytest.mark.parametrize("shape,skew,stacked", [
    ((), 1.0, False), ((2, 3, 4, 30), 1.0, False), ((16, 40), 1.0, True),
    ((6,), 1.0, True)])
def test_return_pg_matches_jax(shape, skew, stacked):
    """The whitening fit's P damped(g) (pre-update Q) beside its new state,
    against JAX's return_pg on replayed draws, f64: pg within rtol 1e-12,
    Q and L within rtol 1e-9 (the fit's own tolerance)."""
    plan, jplan, ts, js, g = _state(shape, skew, 40 + len(shape),
                                    3 if stacked else None)
    if stacked:
        keys = fastrand.split(fastrand.prng_key(41), 3)
        st, pg = tkron.update_kron_whiten_stacked(
            ts, plan, torch.from_numpy(g), keys, norm_k=8, draw=jax_draw,
            return_pg=True)
        jst, jpg = jkron.update_kron_whiten_stacked(
            js, jplan, jnp.asarray(g), jnp.asarray(keys), norm_k=8,
            return_pg=True)
    else:
        key = fastrand.fold_in(fastrand.prng_key(42), 5)
        st, pg = tkron.update_kron_whiten(ts, plan, torch.from_numpy(g), key,
                                          norm_k=8, draw=jax_draw,
                                          return_pg=True)
        jst, jpg = jkron.update_kron_whiten(js, jplan, jnp.asarray(g),
                                            jnp.asarray(key), norm_k=8,
                                            return_pg=True)
    assert pg.shape == g.shape
    _close(pg, jpg)
    for a, b in zip(st.q, jst.q):
        _close(a, b, 1e-9)
    for a, b in zip(st.lips, jst.lips):
        _close(a, b, 1e-9)


# ---------------------------------------------------------------------------
# validation: the JAX transforms' ValueErrors under the same conditions
# ---------------------------------------------------------------------------

MOM = dict(momentum=0.9, whiten_grad=False)
ERRORS = {
    "pipelined_grad_whitening": (
        dict(pipelined_fit=True, preconditioner_init_scale=1.0), "momentum whitening"),
    "pipelined_init_scale": (dict(MOM, pipelined_fit=True), "init_scale"),
    "share_fit_first": (dict(share_fit_apply=True), "update_preconditioner_first"),
    "share_pipelined": (
        dict(MOM, share_fit_apply=True, update_preconditioner_first=False,
             pipelined_fit=True, preconditioner_init_scale=1.0), "pipelined_fit"),
    "share_sources_differ": (
        dict(share_fit_apply=True, update_preconditioner_first=False,
             momentum=0.9, whiten_grad=True), "coincide"),
    "share_eq": (dict(share_fit_apply=True, update_preconditioner_first=False,
                      dq="EQ"), "EQ"),
    "cache_fit_p": (dict(cache_p=True, dq="QUAD4P"), "fit-P"),
    "newton_cache_fit_p": (dict(cache_p=True, dq="PRO4P", newton=True), "fit-P"),
    "shared_without_scanned": (dict(shared_layers=True, unscanned=True),
                               "no leaf is marked"),
    "shared_not_scanned": (dict(shared_layers="wte"), "not in scanned_layers"),
    "shared_count": (dict(shared_layers="short"), "shared_layers has"),
    "newton_shared_not_scanned": (dict(shared_layers="wte", newton=True),
                                  "not in scanned_layers"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_validation_matches_jax(case):
    """Each ValueError of the JAX transforms (transforms.py:740-780 and
    _shared_flags) is raised by the port under the same options: the
    shared_layers flags as a JAX pytree of bools and as the port's dict (or
    sequence, for the count)."""
    kw, match = ERRORS[case]
    kw = dict(kw)
    newton, unscanned = kw.pop("newton", False), kw.pop("unscanned", False)
    params, _, model = MODELS["gpt2"][0]()
    jmask = None if unscanned else MODELS["gpt2"][3](params)
    tmask = None if unscanned else MODELS["gpt2"][5](model)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("shared_layers") == "wte":
        jkw["shared_layers"] = jax.tree_util.tree_map_with_path(
            lambda path, _: path[0].key == "wte", params)
        tkw["shared_layers"] = {"wte": True}
    elif kw.get("shared_layers") == "short":
        jkw["shared_layers"] = {"wte": True}
        tkw["shared_layers"] = [True]
    jmake, tmake = ((jopt.kron_newton, kron_newton) if newton
                    else (jopt.kron_whiten, kron_whiten))
    with pytest.raises(ValueError, match=match):
        jmake(scanned_layers=jmask, **jkw).init(params)
    with pytest.raises(ValueError, match=match):
        tmake(model.named_parameters(), device="cpu", scanned_layers=tmask,
              **tkw)


def test_newton_fit_takes_no_return_pg():
    """The Newton fit's source is a (v, h) pair, never the apply source:
    its functions take no return_pg, as in the JAX package."""
    plan, _, ts, _, g = _state((4, 5), 1.0, 1)
    g = torch.from_numpy(g)
    with pytest.raises(TypeError):
        tkron.update_kron_newton(ts, plan, g, g, fastrand.prng_key(0),
                                 return_pg=True)
    with pytest.raises(ValueError, match="single pass"):
        fit_p = tkron.make_kron_plan((4, 4), dq="QUAD4P")
        tkron.compute_p_factors(tkron.init_kron_from_plan(fit_p, device="cpu"),
                                fit_p)


# ---------------------------------------------------------------------------
# pipelined_fit reads only the optimizer state
# ---------------------------------------------------------------------------


def test_pipelined_fit_ignores_this_steps_gradient():
    """Change step 3's gradient and no Q or L after step 3 moves under
    pipelined_fit (its fit reads the momentum from before that step's EMA;
    the port's form of test_pipelined_fit.py's jvp probe); without it Q
    moves.  The parameters and momentum move in both."""
    shapes = [(8, 4), (6,)]

    def run(pipelined, last):
        params = [torch.nn.Parameter(torch.zeros(s, dtype=torch.float64))
                  for s in shapes]
        opt = KronWhiten(params, lr=0.1, device="cpu", momentum=0.9,
                         whiten_grad=False, preconditioner_init_scale=1.0,
                         pipelined_fit=pipelined, seed=4)
        for t in range(4):
            for p in params:
                p.grad = torch.ones_like(p) * (t + 1.0) * (last if t == 3 else 1.0)
            opt.step()
        return opt, params

    for pipelined in (True, False):
        (a, pa), (b, pb) = run(pipelined, 1.0), run(pipelined, 1.37)
        same = all(torch.equal(x, y) for p, q in zip(pa, pb)
                   for x, y in zip(a.state[p]["q"] + a.state[p]["lips"],
                                   b.state[q]["q"] + b.state[q]["lips"]))
        assert same == pipelined
        assert not torch.equal(a.state[pa[0]]["mu"], b.state[pb[0]]["mu"])
    assert a.fit_steps == 4 and run(True, 1.0)[0].fit_steps == 3
