"""The port's optimizers resume bitwise from ``state_dict()``.

C2's probe (ROADMAP §C): a (8, 6) and a (5,) parameter, lr 1e-2, momentum
0.9, a gated schedule (a callable p = 0.5, so the key chain and the gate
draws matter), 4 steps, ``state_dict()`` through ``torch.save`` and
``torch.load(weights_only=True)`` on a BytesIO, loaded into a fresh
optimizer on copies of the parameters, then 4 more steps on both.  The
resumed run equals the unbroken one bit for bit: parameters, every state
tensor (with its dtype), count, key and fit_steps.  For all five
optimizers and the five closure classes, in float64 on the CPU; KronWhiten
in all seven geometries and with each option; the on-the-fly init scale
(``preconditioner_init_scale=None``) saved at count 0 and at count 4.
Also: bf16 Q and momentum over f32 parameters come back bf16 (torch's own
``load_state_dict`` casts them to f32), and a state whose plans differ
raises a ValueError that names the difference."""

import io
import warnings

import pytest
import torch

from psgd_torch_tpu_torch.optim import (DenseNewton, KronNewton, KronWhiten,
                                        LRANewton, LRAWhiten, classes)
from psgd_torch_tpu_torch.precond import kron as tkron

GATED = lambda c: 0.5   # noqa: E731  (a schedule: the gate draws every step)
# seed 3's gate at p = 0.5 fits at counts 0, 1, 3, 5 and 6: fit and no-fit
# steps on both sides of the save at count 4 (seed 0's fits all eight)
SEED = 3
NEWTON = (KronNewton, LRANewton, DenseNewton, classes.KronNewton,
          classes.LRANewton, classes.DenseNewton)


def make_params(dtype=torch.float64):
    gen = torch.Generator().manual_seed(0)
    return [torch.randn((8, 6), generator=gen, dtype=torch.float64).to(dtype)
            .requires_grad_(),
            torch.randn((5,), generator=gen, dtype=torch.float64).to(dtype)
            .requires_grad_()]


def loss_fn(params):
    """A smooth non-quadratic loss (its Hessian moves with the step)."""
    return sum(torch.sum((p - 0.5) ** 4 + 0.1 * p * p) for p in params)


def run(opt, params, steps):
    for _ in range(steps):
        if isinstance(opt, classes._ClosureOptimizer) or isinstance(opt, NEWTON):
            opt.step(lambda: loss_fn(params))
        else:
            opt.zero_grad()
            loss_fn(params).backward()
            opt.step()


def round_trip(state_dict):
    buf = io.BytesIO()
    torch.save(state_dict, buf)
    buf.seek(0)
    return torch.load(buf, weights_only=True)


def assert_same(a, b, where="state_dict"):
    """Equal bit for bit, dtypes included, through nested containers."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, where
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif not callable(a):
        assert a == b, where


def resume(cls, kw, save_at=4, total=8, dtype=torch.float64):
    """(unbroken optimizer, its parameters, resumed optimizer, its
    parameters) after ``total`` steps, the resumed one restored at
    ``save_at``."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a = make_params(dtype)
        opt_a = cls(a, device="cpu", **kw)
        run(opt_a, a, save_at)
        saved = round_trip(opt_a.state_dict())
        b = [p.detach().clone().requires_grad_() for p in a]
        opt_b = cls(b, device="cpu", **kw)
        opt_b.load_state_dict(saved)
        run(opt_a, a, total - save_at)
        run(opt_b, b, total - save_at)
    return opt_a, a, opt_b, b


def assert_resumed(cls, kw, save_at=4):
    opt_a, a, opt_b, b = resume(cls, kw, save_at)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert_same(opt_a.state_dict(), opt_b.state_dict())
    core_a = getattr(opt_a, "optimizer", opt_a)
    core_b = getattr(opt_b, "optimizer", opt_b)
    assert core_a.count == core_b.count == 8
    assert (core_a.key == core_b.key).all() and core_a.key.dtype == core_b.key.dtype
    assert core_a.fit_steps == core_b.fit_steps
    return core_a


WHITEN = dict(lr=1e-2, momentum=0.9, preconditioner_update_probability=GATED,
              preconditioner_init_scale=1.0, seed=SEED)
NEWTON_KW = WHITEN
SCANNED = dict(scanned_layers=[True, False])
CASES = {
    **{f"KronWhiten-{dq}": (KronWhiten, dict(WHITEN, dq=dq))
       for dq in tkron.ALL_DQ},
    "KronWhiten-momentum-whitening": (KronWhiten, dict(WHITEN, whiten_grad=False)),
    "KronWhiten-scanned": (KronWhiten, dict(WHITEN, **SCANNED)),
    "KronWhiten-shared_layers": (KronWhiten, dict(WHITEN, shared_layers=True,
                                                  **SCANNED)),
    "KronWhiten-cache_p": (KronWhiten, dict(WHITEN, cache_p=True, **SCANNED)),
    "KronWhiten-pipelined_fit": (KronWhiten, dict(WHITEN, whiten_grad=False,
                                                  pipelined_fit=True)),
    "KronWhiten-share_fit_apply": (KronWhiten, dict(
        WHITEN, whiten_grad=False, share_fit_apply=True,
        update_preconditioner_first=False, cache_p=True)),
    "KronNewton": (KronNewton, NEWTON_KW),
    "KronNewton-QEQ": (KronNewton, dict(NEWTON_KW, dq="QEQ")),
    "KronNewton-cache_p": (KronNewton, dict(NEWTON_KW, cache_p=True)),
    "KronNewton-shared_layers": (KronNewton, dict(NEWTON_KW, shared_layers=True,
                                                  **SCANNED)),
    "LRAWhiten": (LRAWhiten, dict(WHITEN, rank_of_approximation=3)),
    "LRAWhiten-apply-first": (LRAWhiten, dict(
        WHITEN, rank_of_approximation=3, whiten_grad=False,
        update_preconditioner_first=False)),
    "LRANewton": (LRANewton, dict(NEWTON_KW, rank_of_approximation=3)),
    "DenseNewton": (DenseNewton, NEWTON_KW),
    "DenseNewton-PRO4P": (DenseNewton, dict(NEWTON_KW, dq="PRO4P")),
    "class-KronWhiten": (classes.KronWhiten, dict(
        lr_params=1e-2, momentum=0.9, preconditioner_update_probability=GATED,
        preconditioner_init_scale=1.0, seed=SEED)),
    "class-KronNewton": (classes.KronNewton, dict(
        lr_params=1e-2, momentum=0.9, preconditioner_update_probability=GATED,
        preconditioner_init_scale=1.0, seed=SEED)),
    "class-LRAWhiten": (classes.LRAWhiten, dict(
        lr_params=1e-2, momentum=0.9, rank_of_approximation=3,
        preconditioner_update_probability=GATED, preconditioner_init_scale=1.0, seed=SEED)),
    "class-LRANewton": (classes.LRANewton, dict(
        lr_params=1e-2, momentum=0.9, rank_of_approximation=3,
        preconditioner_update_probability=GATED, preconditioner_init_scale=1.0, seed=SEED)),
    "class-DenseNewton": (classes.DenseNewton, dict(
        lr_params=1e-2, momentum=0.9, preconditioner_update_probability=GATED,
        preconditioner_init_scale=1.0, dQ="QEP", seed=SEED)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_resume_is_bitwise(case):
    cls, kw = CASES[case]
    core = assert_resumed(cls, kw)
    assert 0 < core.fit_steps < 8, "the gate took no mixed steps"


# the on-the-fly init scale: a state saved at count 0 still takes it, once;
# one saved at count 4 does not take it again
ON_THE_FLY = {
    "KronWhiten": (KronWhiten, dict(WHITEN, preconditioner_init_scale=None)),
    "KronNewton": (KronNewton, dict(NEWTON_KW, preconditioner_init_scale=None)),
    "LRAWhiten": (LRAWhiten, dict(WHITEN, preconditioner_init_scale=None,
                                  rank_of_approximation=3)),
    "LRANewton": (LRANewton, dict(NEWTON_KW, preconditioner_init_scale=None,
                                  rank_of_approximation=3)),
    "DenseNewton": (DenseNewton, dict(NEWTON_KW, preconditioner_init_scale=None)),
}


@pytest.mark.parametrize("save_at", [0, 4])
@pytest.mark.parametrize("name", sorted(ON_THE_FLY))
def test_on_the_fly_init_scale_resumes(name, save_at):
    cls, kw = ON_THE_FLY[name]
    assert_resumed(cls, kw, save_at)


def test_state_dict_holds_the_whole_state():
    """count, key (int64), fit_steps and the plans' layout beside the
    per-parameter state; schedules stay out of param_groups."""
    opt, *_ = resume(KronWhiten, dict(WHITEN, cache_p=True), 4, 4)
    sd = opt.state_dict()
    psgd = sd["psgd"]
    assert psgd["count"] == 4 and psgd["key"].dtype == torch.int64
    assert (psgd["key"].numpy() == opt.key).all()
    assert set(sd["state"][0]) == {"q", "lips", "mu", "pcache"}
    group = sd["param_groups"][0]
    assert "preconditioner_update_probability" not in group
    assert group["lr"] == 1e-2 and group["params"] == [0, 1]
    assert psgd["layout"]["cache_p"] is True
    flat, *_ = resume(LRAWhiten, dict(WHITEN, rank_of_approximation=3), 4, 4)
    extra = flat.state_dict()["psgd"]
    assert set(extra["precond"]) == {"u", "v", "d", "lu", "lv", "ld"}
    assert extra["mu"].shape == (53,)


def test_load_keeps_the_receivers_schedules():
    """A schedule is the optimizer's: load_state_dict keeps the receiving
    optimizer's callables and takes the saved plain hyperparameters."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        src = KronWhiten(make_params(), lr=0.5, preconditioner_update_probability=0.25,
                         preconditioner_init_scale=1.0, device="cpu")
        sched = lambda c: 0.75   # noqa: E731
        dst = KronWhiten(make_params(), lr=1e-3, preconditioner_update_probability=sched,
                         preconditioner_init_scale=1.0, device="cpu")
    dst.load_state_dict(round_trip(src.state_dict()))
    group = dst.param_groups[0]
    assert group["lr"] == 0.5 and group["preconditioner_update_probability"] is sched


@pytest.mark.parametrize("cls, kw", [
    (KronWhiten, dict(WHITEN, whiten_grad=False)),
    (LRAWhiten, dict(WHITEN, rank_of_approximation=3, whiten_grad=False)),
], ids=["KronWhiten", "LRAWhiten"])
def test_low_precision_state_keeps_its_dtype(cls, kw):
    """f32 parameters, bf16 Q and momentum: every restored tensor has the
    dtype it was saved with (bf16 Q and momentum, f32 Lipschitz
    estimates), where torch's own load_state_dict casts the floating
    state to the parameters' f32; and the resumed run is bitwise."""
    kw = dict(kw, preconditioner_dtype=torch.bfloat16,
              momentum_dtype=torch.bfloat16)
    opt_a, a, opt_b, b = resume(cls, kw, 2, 4, dtype=torch.float32)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert_same(opt_a.state_dict(), opt_b.state_dict())
    if cls is KronWhiten:
        for p in opt_b.param_groups[0]["params"]:
            st = opt_b.state[p]
            assert {q.dtype for q in st["q"]} == {torch.bfloat16}
            assert {x.dtype for x in st["lips"]} == {torch.float32}
            assert st["mu"].dtype == torch.bfloat16
    else:
        st = opt_b.precond
        assert {st.u.dtype, st.v.dtype, st.d.dtype} == {torch.bfloat16}
        assert {st.lu.dtype, st.lv.dtype, st.ld.dtype} == {torch.float32}
        assert opt_b.mu.dtype == torch.bfloat16
    if cls is KronWhiten:
        # torch's own load casts the state to the parameters' dtype: the
        # fault the port's load_state_dict avoids
        c = make_params(torch.float32)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            opt_c = cls(c, device="cpu", **kw)
        torch.optim.Optimizer.load_state_dict(opt_c, opt_a.state_dict())
        assert opt_c.state[c[0]]["mu"].dtype == torch.float32


MISMATCHES = {
    "shape": (KronWhiten, WHITEN, dict(WHITEN), "shape",
              lambda: [torch.zeros((6, 8), dtype=torch.float64, requires_grad=True),
                       torch.zeros((5,), dtype=torch.float64, requires_grad=True)]),
    "scanned": (KronWhiten, WHITEN, dict(WHITEN, **SCANNED), "scanned", None),
    "shared": (KronWhiten, dict(WHITEN, **SCANNED),
               dict(WHITEN, shared_layers=True, **SCANNED), "shared", None),
    "geometry": (KronWhiten, WHITEN, dict(WHITEN, dq="QEQ"), "dq", None),
    "cache_p": (KronWhiten, WHITEN, dict(WHITEN, cache_p=True), "cache_p", None),
    "momentum": (KronWhiten, WHITEN, dict(WHITEN, momentum=0.0), "mu", None),
    "optimizer": (KronWhiten, WHITEN, None, "optimizer", None),
    "lra-rank": (LRAWhiten, dict(WHITEN, rank_of_approximation=3),
                 dict(WHITEN, rank_of_approximation=2), "'u'", None),
    "dense-geometry": (DenseNewton, NEWTON_KW, dict(NEWTON_KW, dq="QEQ"), "dq", None),
}


@pytest.mark.parametrize("case", sorted(MISMATCHES))
def test_mismatched_plan_raises(case):
    """A state saved by an optimizer of another layout (parameter shapes,
    scanned or shared stacks, geometry, cache_p, momentum, rank, family)
    raises a ValueError that names the first difference."""
    cls, saved_kw, here_kw, names, here_params = MISMATCHES[case]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        src = cls(make_params(), device="cpu", **saved_kw)
        run(src, src.param_groups[0]["params"], 2)
        if here_kw is None:   # KronWhiten's state into KronNewton
            dst = KronNewton(make_params(), device="cpu", **NEWTON_KW)
        else:
            dst = cls(here_params() if here_params else make_params(),
                      device="cpu", **here_kw)
    before = dst.state_dict()
    with pytest.raises(ValueError, match=names):
        dst.load_state_dict(round_trip(src.state_dict()))
    assert_same(before, dst.state_dict())   # nothing was loaded
