"""LRAWhiten, LRANewton and DenseNewton (psgd_torch_tpu_torch.optim)
against the JAX package's lra_whiten, lra_newton and dense_newton: three
steps of the small tensor-rank (CP) decomposition of
examples/tensor_rank_decomposition.py at R, I, J, K = 2, 3, 4, 5 (n =
24), in float64 on replayed draws (``jax_draw``), with momentum, gated
schedules that fit on some steps and not on others, and the on-the-fly
init scale.  Also the transforms' rules: the JAX ValueErrors, the dense
advisories, ``vector_sharding``'s argument checks (ROADMAP A8b; the
sharded runs are tests/test_torch_vector_sharding.py) and complex
parameters (A3b: taken, held against JAX in
tests/test_torch_complex_lra_dense.py; under ``vector_sharding`` since
A3c, held in tests/test_torch_complex_vector_sharding.py).

Tolerance: rtol 1e-9 (atol 1e-9 of the largest entry) in float64.  Both
sides take the on-the-fly init scale in float32 (the JAX transforms cast
to float32 before the mean), and the two sum those 24 values alike here:
the arms without an explicit scale hold at the same tolerance.  Where
LRAWhiten's amplitude clip acts, both sides take its RMS in float32 too
(``_amp_clip``), summed in another order: its scale then differs by an
f32 rounding (2^-24 relative), and those arms hold at CLIP_RTOL = 1e-6
(the test checks that the clip did act there)."""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import psgd_torch_tpu.optim as jopt
from psgd_torch_tpu_torch.ops import fastrand
from psgd_torch_tpu_torch.optim import (DenseNewton, LRANewton, LRAWhiten,
                                        dense_newton, lra_newton, lra_whiten,
                                        transforms)
from psgd_torch_tpu_torch.precond import kron as tkron
from test_torch_kron import jax_draw, to_np

RTOL = 1e-9
CLIP_RTOL = 1e-6
STEPS = 3
R, SIZES = 2, (3, 4, 5)
LR = 0.05
GATED = lambda c: 0.5   # noqa: E731  (a schedule: the gate draws every step)


def problem():
    """(target, initial factors) of the CP problem, from numpy seed 0."""
    rng = np.random.default_rng(0)
    truth = [rng.standard_normal((R, s)) for s in SIZES]
    target = np.einsum("ri,rj,rk->ijk", *truth)
    return target, [rng.standard_normal((R, s)) for s in SIZES]


def jax_loss(target):
    def loss(xyz):
        err = target - jnp.einsum("ri,rj,rk->ijk", *xyz)
        return jnp.sum(err * err)
    return loss


def torch_loss(target, xyz):
    err = target - torch.einsum("ri,rj,rk->ijk", *xyz)
    return torch.sum(err * err)


def gate_pattern(seed, splits, prob=0.5):
    """The JAX gate of each of STEPS steps (key chain split(key, splits),
    k_gate the second) under the replayed uniform."""
    key, out = fastrand.prng_key(seed), []
    for _ in range(STEPS):
        keys = fastrand.split(key, splits)
        key = keys[0]
        out.append(float(jax_draw("uniform", keys[1][None], (), torch.float64)[0])
                   < prob)
    return out


def mixed_seed(splits, newton):
    """The first seed whose gates give fit and no-fit steps (Newton: the
    first step always fits)."""
    for seed in range(100):
        fits = gate_pattern(seed, splits)
        if newton:
            fits[0] = True
        if any(fits) and not all(fits):
            return seed, fits
    raise AssertionError("no seed gives a mixed gate")


@functools.lru_cache(maxsize=None)
def jax_steps(name, newton, items):
    """STEPS jitted JAX steps of optimizer ``name`` with kwargs ``items``
    from the problem's start: (final params, the transform's state)."""
    kw = dict(items)
    target, init = problem()
    loss = jax_loss(jnp.asarray(target))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        opt = getattr(jopt, name)(learning_rate=LR, **kw)

    @jax.jit
    def step(p, s):
        extra = {"hvp_fn": jopt.make_hvp_fn(loss)} if newton else {}
        upd, s = opt.update(jax.grad(loss)(p), s, p, **extra)
        return optax.apply_updates(p, upd), s

    params = [jnp.asarray(x) for x in init]
    state = opt.init(params)
    for _ in range(STEPS):
        params, state = step(params, state)
    return params, [s for s in state if hasattr(s, "precond")][0].precond


def torch_steps(cls, newton, kw):
    target, init = problem()
    target = torch.from_numpy(target)
    params = [torch.from_numpy(x).requires_grad_() for x in init]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        opt = cls(params, lr=LR, device="cpu", draw=jax_draw, **kw)
    for _ in range(STEPS):
        if newton:
            opt.step(lambda: torch_loss(target, params))
        else:
            opt.zero_grad()
            torch_loss(target, params).backward()
            opt.step()
    return params, opt


def close(got, ref, what, rtol=RTOL):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(to_np(got), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(initial=0.0), 1e-300),
                               err_msg=what)


def hold(name, cls, newton, kw, fits, rtol=RTOL):
    jparams, jst = jax_steps(name, newton, tuple(sorted(kw.items())))
    params, opt = torch_steps(cls, newton, kw)
    for i, (p, j) in enumerate(zip(params, jparams)):
        close(p, j, f"param {i}", rtol)
    for f in opt.precond._fields:
        close(getattr(opt.precond, f), getattr(jst, f), f, rtol)
    assert opt.fit_steps == sum(fits), (opt.fit_steps, fits)


# arm -> (kwargs, whether the amplitude clip acts on some step)
LRA_WHITEN_ARMS = {
    # momentum whitened gradient, gated, init scale on the fly
    "gated_grad": (dict(momentum=0.9, rank_of_approximation=3,
                        preconditioner_update_probability=GATED), False),
    # momentum whitening, apply first, explicit scale, p = 1
    "momentum_apply_first": (dict(momentum=0.9, whiten_grad=False,
                                  update_preconditioner_first=False,
                                  preconditioner_init_scale=1.0,
                                  rank_of_approximation=4, damping=1e-3), True),
    # rank 0: the diagonal preconditioner, tight amplitudes
    "rank0": (dict(rank_of_approximation=0, preconditioner_init_scale=0.5,
                   grad_clip_max_amps=(0.5, 1.0)), True),
}


@pytest.mark.parametrize("arm", sorted(LRA_WHITEN_ARMS))
def test_lra_whiten_three_steps_match_jax(arm, monkeypatch):
    kw, clips = LRA_WHITEN_ARMS[arm]
    kw = dict(kw)
    fits = [True] * STEPS
    if "preconditioner_update_probability" in kw:
        kw["seed"], fits = mixed_seed(3, newton=False)
    acted = []
    amp_clip = transforms._amp_clip

    def recorded(g, *args, **kwargs):
        out = amp_clip(g, *args, **kwargs)
        acted.append(not torch.equal(out, g))
        return out

    monkeypatch.setattr(transforms, "_amp_clip", recorded)
    hold("lra_whiten", LRAWhiten, False, kw, fits,
         CLIP_RTOL if clips else RTOL)
    assert any(acted) == clips, acted


NEWTON_ARMS = {
    "lra_gated": ("lra_newton", LRANewton, dict(
        momentum=0.9, rank_of_approximation=3, grad_clip_max_norm=10.0,
        preconditioner_update_probability=GATED)),
    "lra_plain": ("lra_newton", LRANewton, dict(
        rank_of_approximation=5, preconditioner_init_scale=1.0,
        weight_decay=0.01, weight_decay_mode="classic")),
    "dense_gated": ("dense_newton", DenseNewton, dict(
        momentum=0.9, grad_clip_max_norm=10.0, lr_preconditioner=0.5,
        preconditioner_update_probability=GATED)),
    "dense_pro4p": ("dense_newton", DenseNewton, dict(
        dq="PRO4P", preconditioner_init_scale=2.0, norm_k=4,
        weight_decay=0.01)),
    "dense_eq_scale_on_the_fly": ("dense_newton", DenseNewton, dict(
        dq="EQ", momentum=0.5)),
}


@pytest.mark.parametrize("arm", sorted(NEWTON_ARMS))
def test_newton_three_steps_match_jax(arm):
    name, cls, kw = NEWTON_ARMS[arm]
    kw = dict(kw)
    fits = [True] * STEPS
    if "preconditioner_update_probability" in kw:
        kw["seed"], fits = mixed_seed(4, newton=True)
    hold(name, cls, True, kw, fits)


def test_factories_and_rules():
    """The factories take the JAX names; the JAX ValueErrors, a malformed
    ``vector_sharding`` and dense's non-QEQ one, complex parameters taken
    (A3b) and under ``vector_sharding`` (A3c: built with complex rows on
    rank 0 of a 2-rank fake process group), and the dense advisories."""
    p = [torch.zeros(16, requires_grad=True)]
    assert isinstance(lra_whiten(p, learning_rate=0.1, device="cpu"), LRAWhiten)
    assert lra_newton(p, device="cpu").param_groups[0]["lr"] == 0.01
    assert dense_newton(p, 0.2, device="cpu", dq="Q0p5EQ1p5",
                        preconditioner_init_scale=1.0).dq == "Q0.5EQ1.5"
    with pytest.raises(ValueError, match="momentum == 0"):
        LRAWhiten(p, whiten_grad=False, device="cpu")
    with pytest.raises(ValueError, match="momentum == 0"):
        LRAWhiten(p, whiten_grad=False, momentum=1.0, device="cpu")
    with pytest.raises(ValueError, match="rank"):
        LRANewton(p, rank_of_approximation=16, device="cpu")
    with pytest.raises(ValueError, match="dQ"):
        DenseNewton(p, dq="XYZ", device="cpu")
    with pytest.raises(ValueError, match="weight_decay_mode"):
        LRAWhiten(p, weight_decay_mode="other", device="cpu")
    for cls in (LRAWhiten, LRANewton, DenseNewton):
        kw = dict(device="cpu", preconditioner_init_scale=1.0)
        with pytest.raises((TypeError, ValueError), match="vector_sharding"):
            cls(p, vector_sharding=("mesh", "fsdp"), **kw)
        cx = cls([torch.zeros(16, dtype=torch.complex64)], **kw)
        assert cx.precond[0].dtype == torch.complex64
        assert cls(p, preconditioner_dtype=torch.complex64,
                   **kw).precond[0].dtype == torch.complex64
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
        try:      # rank 0 of 2: n = 15 padded to 16, its 8 rows complex
            sharded = dict(kw, vector_sharding=dist.group.WORLD,
                           **({"dq": "QEQ"} if cls is DenseNewton else {}))
            for opt in (cls([torch.zeros(15, dtype=torch.complex64)], **sharded),
                        cls([torch.zeros(15)], preconditioner_dtype=torch.complex64,
                            **sharded)):
                assert opt.precond[0].dtype == torch.complex64
                assert opt.precond[0].shape[0] == opt.n_loc == 8
                assert opt.pad_mask is None and opt.n_pad == 16
        finally:
            dist.destroy_process_group()
    with pytest.raises(ValueError, match="QEQ"):
        DenseNewton(p, dq="Q0.5EQ1.5", vector_sharding=("mesh", "fsdp"),
                    device="cpu", preconditioner_init_scale=1.0)
    with pytest.raises(ValueError, match="closure"):
        LRANewton(p, device="cpu").step()
    with pytest.warns(UserWarning, match="on the fly"):
        DenseNewton(p, device="cpu")
    with pytest.warns(UserWarning, match="half precision"):
        DenseNewton(p, dq="PRO4P", preconditioner_init_scale=1.0,
                    preconditioner_dtype=torch.bfloat16, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # an explicit scale: no advisory
        DenseNewton(p, preconditioner_init_scale=1.0, device="cpu")
        LRAWhiten(p, device="cpu")          # JAX's LRA transforms advise nothing


def test_parameter_order_and_own_draws():
    """Named parameters are concatenated in their sorted dotted-path order
    (JAX ravel_pytree of a dict); a step with the port's own draws (no
    replay) is finite and descends on the tensor-rank problem, for every
    dense geometry and both LRA optimizers."""
    target, init = problem()
    target = torch.from_numpy(target).float()
    named = [(n, torch.from_numpy(x).float().requires_grad_())
             for n, x in zip(("z", "b", "a.c"), init)]
    opt = LRAWhiten(named, device="cpu", preconditioner_init_scale=1.0)
    assert [p.shape for p in opt.param_groups[0]["params"]] == \
        [named[2][1].shape, named[1][1].shape, named[0][1].shape]
    for make in [lambda ps: LRANewton(ps, device="cpu", lr=0.02,
                                      rank_of_approximation=4,
                                      preconditioner_init_scale=1.0)] + [
            functools.partial(DenseNewton, device="cpu", lr=0.02, dq=dq,
                              preconditioner_init_scale=1.0)
            for dq in tkron.ALL_DQ]:
        params = [torch.from_numpy(x).float().requires_grad_() for x in init]
        opt = make(params)
        losses = [opt.step(lambda: torch_loss(target, params)).item()
                  for _ in range(4)]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
