"""Optimizer-health metrics and state memory
(psgd_torch_tpu_torch.utils.metrics) against the JAX package's
``psgd_metrics`` and ``state_memory_report``.

``psgd_metrics``: the states after three steps of the small tensor-rank
problem of tests/test_torch_lra_dense_optim.py (n = 24, float64, replayed
draws, a gated schedule), KronWhiten with cache_p and DenseNewton, with
``per_leaf`` and the last step's updates: the same keys, ``step`` equal,
every value within rtol 1e-6.  The states agree to 1e-9 (that file's
tolerance), but both functions reduce in float32 by design: a maximum
then agrees to an f32 rounding, a root mean square to f32 sums taken in
another order.  LRA: JAX's walk of the state never reaches an LRAState (a
NamedTuple is a tuple, so it iterates the bare arrays and yields none),
so its metrics carry no preconditioner entry; the port gives
``q_abs_max`` over every field, as the JAX module's docstring describes,
held here against those fields directly.

``state_memory_report``: ``q``, ``lips``, ``momentum`` and ``pcache``
equal JAX's bytes for Kron with cache_p (a layer stack and a vector), LRA
and dense; ``other`` is 0 in the port, which keeps count and key on the
host, and 12 in JAX (an int32 count and a uint32[2] key)."""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import psgd_torch_tpu.optim as jopt
from psgd_torch_tpu.utils import psgd_metrics as jax_metrics
from psgd_torch_tpu.utils import state_memory_report as jax_report
from psgd_torch_tpu_torch.optim import (DenseNewton, KronWhiten, LRAWhiten,
                                        classes)
from psgd_torch_tpu_torch.utils import psgd_metrics, state_memory_report
from test_torch_kron import jax_draw, to_np
from test_torch_lra_dense_optim import jax_loss, mixed_seed, problem, torch_loss

RTOL = 1e-6
STEPS = 3
LR = 0.05
GATED = lambda c: 0.5   # noqa: E731
# the first seeds whose replayed gates give fit and no-fit steps
SEED = mixed_seed(3, False)[0]
NEWTON_SEED = mixed_seed(4, True)[0]
OPTIMIZERS = {
    # (JAX factory, port class, Newton, kwargs)
    "kron_whiten": ("kron_whiten", KronWhiten, False, dict(
        momentum=0.9, whiten_grad=False, cache_p=True, seed=SEED,
        preconditioner_init_scale=1.0,
        preconditioner_update_probability=GATED)),
    "dense_newton": ("dense_newton", DenseNewton, True, dict(
        momentum=0.9, seed=NEWTON_SEED, preconditioner_init_scale=1.0,
        preconditioner_update_probability=GATED)),
    "lra_whiten": ("lra_whiten", LRAWhiten, False, dict(
        momentum=0.9, rank_of_approximation=2, seed=SEED,
        preconditioner_init_scale=1.0,
        preconditioner_update_probability=GATED)),
}


@functools.lru_cache(maxsize=None)
def jax_run(name):
    """Three jitted JAX steps: (the chain's state, the last updates)."""
    factory, _, newton, kw = OPTIMIZERS[name]
    target, init = problem()
    loss = jax_loss(jnp.asarray(target))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        opt = getattr(jopt, factory)(learning_rate=LR, **kw)

    @jax.jit
    def step(p, s):
        extra = {"hvp_fn": jopt.make_hvp_fn(loss)} if newton else {}
        upd, s = opt.update(jax.grad(loss)(p), s, p, **extra)
        return optax.apply_updates(p, upd), s, upd

    params, state = [jnp.asarray(x) for x in init], None
    state = opt.init(params)
    for _ in range(STEPS):
        params, state, upd = step(params, state)
    return state, upd


def torch_run(name):
    """Three port steps: (optimizer, the last step's updates)."""
    _, cls, newton, kw = OPTIMIZERS[name]
    target, init = problem()
    target = torch.from_numpy(target)
    params = [torch.from_numpy(x).requires_grad_() for x in init]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        opt = cls(params, lr=LR, device="cpu", draw=jax_draw, **kw)
    for _ in range(STEPS):
        before = [p.detach().clone() for p in params]
        if newton:
            opt.step(lambda: torch_loss(target, params))
        else:
            opt.zero_grad()
            torch_loss(target, params).backward()
            opt.step()
    return opt, [p.detach() - b for p, b in zip(params, before)]


@pytest.mark.parametrize("name", ["kron_whiten", "dense_newton"])
def test_psgd_metrics_match_jax(name):
    jstate, jupd = jax_run(name)
    opt, upd = torch_run(name)
    ref = jax_metrics(jstate, jupd, per_leaf=True)
    ours = psgd_metrics(opt, upd, per_leaf=True)
    assert sorted(ours) == sorted(ref)
    assert {"L_max", "q_abs_max", "q_rowmax_min", "momentum_rms", "update_rms",
            "update_abs_max"} <= set(ours)
    assert int(ours["step"]) == int(ref["step"]) == STEPS
    for k, v in ours.items():
        assert v.ndim == 0 and v.device == opt.device, k
        np.testing.assert_allclose(float(v), float(ref[k]), rtol=RTOL, err_msg=k)
    assert 0 < opt.fit_steps < STEPS


def test_psgd_metrics_lra():
    """JAX's metrics carry no LRA preconditioner entry (its walk does not
    reach the LRAState); the port's q_abs_max is the largest |entry| of
    every field of the state, and the shared keys agree."""
    jstate, jupd = jax_run("lra_whiten")
    opt, upd = torch_run("lra_whiten")
    ref = jax_metrics(jstate, jupd, per_leaf=True)
    ours = psgd_metrics(opt, upd, per_leaf=True)
    assert set(ref) == {"step", "momentum_rms", "update_rms", "update_abs_max"}
    assert set(ours) == set(ref) | {"q_abs_max", "q_abs_max/leaf"}
    for k in ref:
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=RTOL, err_msg=k)
    ps = [s for s in jstate if hasattr(s, "precond")][0].precond
    direct = max(np.abs(np.asarray(f, np.float32)).max() for f in ps)
    np.testing.assert_allclose(float(ours["q_abs_max"]), direct, rtol=RTOL)


def test_psgd_metrics_of_a_class_and_without_updates():
    """A closure class reports its optimizer's metrics; without updates
    there are no update keys."""
    params = [torch.ones(4, 3, dtype=torch.float64, requires_grad=True)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        opt = classes.KronWhiten(params, preconditioner_init_scale=1.0,
                                 device="cpu")
    opt.step(lambda: torch.sum(params[0] ** 4))
    out = psgd_metrics(opt)
    assert "update_rms" not in out and "momentum_rms" not in out
    assert int(out["step"]) == 1 and torch.isfinite(out["L_max"])


# (JAX transform, port class, params); tiny shapes, float64
REPORTS = {
    "kron_cache_p": ("scale_by_kron_whiten", KronWhiten, dict(
        momentum=0.9, cache_p=True, preconditioner_init_scale=1.0,
        scanned_layers={"blocks": True, "w": False})),
    "kron": ("scale_by_kron_whiten", KronWhiten, dict(
        momentum=0.9, preconditioner_init_scale=1.0)),
    "lra": ("scale_by_lra_whiten", LRAWhiten, dict(
        momentum=0.9, rank_of_approximation=4, preconditioner_init_scale=1.0)),
    "dense": ("scale_by_dense_newton", DenseNewton, dict(
        momentum=0.9, preconditioner_init_scale=1.0)),
}


@pytest.mark.parametrize("name", sorted(REPORTS))
def test_state_memory_report_matches_jax(name):
    factory, cls, kw = REPORTS[name]
    shapes = {"blocks": (3, 8, 6), "w": (32, 16)} if name.startswith("kron") \
        else {"w": (12,), "b": (5,)}
    jparams = {k: jnp.zeros(s, jnp.float64) for k, s in shapes.items()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jax_report(getattr(jopt, factory)(**kw).init(jparams))
        port_kw = dict(kw)
        if "scanned_layers" in port_kw:
            port_kw["scanned_layers"] = {k: v for k, v in kw["scanned_layers"].items()}
        params = [(k, torch.zeros(s, dtype=torch.float64, requires_grad=True))
                  for k, s in shapes.items()]
        ours = state_memory_report(cls(params, device="cpu", **port_kw),
                                   per_device=True)
    for group in ("q", "lips", "momentum", "pcache"):
        assert ours[group] == ref[group], group
    assert ours["other"] == 0 and ref["other"] == 4 + 8
    assert ours["total"] == sum(v for k, v in ours.items() if k != "total")
    assert ours["q"] > 0 and ours["lips"] > 0
    assert (ours["pcache"] > 0) == (name == "kron_cache_p")
