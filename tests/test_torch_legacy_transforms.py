"""The port's legacy optimizers (psgd_torch_tpu_torch.optim.XMat, SPLU,
NewtonInv, UVd, Affine) against the JAX package's legacy transforms
(psgd_torch_tpu.optim.xmat, splu, newton_inv, uvd, affine): three steps of
a quadratic over a pytree of several leaves, in float64 on replayed draws
(``test_torch_kron.jax_draw``'s draws: the gate, the probes, the damping, UVd's init, balance and
coin, Affine's balance and drop-v fallback), whitening and Newton, both
step normalizers, the on-the-fly init scale and an explicit one, momentum,
the update-probability gate (fitting on some steps and not on others),
the norm clip and both weight decay modes; Newton through the closure,
``hvp_fn`` and explicit ``vs``/``hvs``.  Affine runs over a dict with a
3-D and a 1-D leaf.  Also each optimizer's ``state_dict()`` round trip
and the rules (the JAX ValueErrors, complex dtypes taken, the refusal of a
missing card).

Tolerance: rtol 1e-9 (atol 1e-9 of the largest entry) in float64.  The
on-the-fly init scale is a float32 mean on both sides; those arms hold at
the same tolerance because both sum these few values alike.
"""

import functools
import io
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import psgd_torch_tpu.optim as jopt
from psgd_torch_tpu_torch.optim import (SPLU, Affine, NewtonInv, UVd, XMat,
                                        affine, newton_inv, splu, uvd, xmat)
from test_torch_kron import to_np
from test_torch_legacy import FAST_COMPILE, fast_draw as jax_draw
from test_torch_lra_dense_optim import gate_pattern

RTOL = 1e-9
STEPS = 3
LR = 0.05
GATED = lambda c: 0.5   # noqa: E731  (a schedule: the gate draws every step)

# leaf shapes: the vector families' list (n = 17, or 18 with EVEN), and
# Affine's dict (sorted keys: the JAX pytree order)
LEAVES = ((3, 4), (5,))
EVEN = ((3, 4), (6,))
TREE = {"a": (2, 3, 4), "b": (5,), "c": (4, 3)}


def problem(shapes, seed=0):
    """(H, c, initial leaves) of f(x) = x^T H x / 2 - c^T x over the
    leaves concatenated, H SPD, from numpy seed ``seed``."""
    rng = np.random.default_rng(seed)
    n = sum(int(np.prod(s)) for s in shapes)
    a = rng.standard_normal((n, n)) / n ** 0.5
    h = a @ a.T + 0.5 * np.eye(n)
    return h, rng.standard_normal(n), [rng.standard_normal(s) for s in shapes]


def jax_loss(h, c):
    def loss(tree):
        x = jnp.concatenate([p.reshape(-1) for p in jax.tree_util.tree_leaves(tree)])
        return 0.5 * x @ (h @ x) - c @ x
    return loss


def torch_loss(h, c, leaves):
    x = torch.cat([p.reshape(-1) for p in leaves])
    return 0.5 * x @ (h @ x) - c @ x


def fits_of(seed):
    """The gate of each step under p = 0.5 (the first step always fits)."""
    fits = gate_pattern(seed, 4)
    fits[0] = True
    return fits


def mixed_seed():
    for seed in range(100):
        fits = fits_of(seed)
        if not all(fits):
            return seed, fits
    raise AssertionError("no seed gives a mixed gate")


def as_tree(kind, leaves):
    return dict(zip(sorted(TREE), leaves)) if kind == "tree" else list(leaves)


@functools.lru_cache(maxsize=None)
def jax_steps(name, mode, kind, items):
    """STEPS jitted JAX steps of ``name`` with kwargs ``items``: (final
    leaves, the transform's precond state).  ``mode``: "whitening",
    "hvp_fn" or "vs" (explicit (v, H v) pairs, v the replayed probes)."""
    kw = dict(items)
    shapes = tuple(TREE[k] for k in sorted(TREE)) if kind == "tree" else kind
    h, c, init = problem(shapes)
    loss = jax_loss(jnp.asarray(h), jnp.asarray(c))
    opt = getattr(jopt, name)(learning_rate=LR, **kw)

    @functools.partial(jax.jit, compiler_options=FAST_COMPILE)
    def step(p, s, i):
        g = jax.grad(loss)(p)
        extra = {}
        if mode == "hvp_fn":
            extra = {"hvp_fn": jopt.make_hvp_fn(loss)}
        elif mode == "vs":
            vs = jax.tree_util.tree_map(lambda x: jax.random.normal(
                jax.random.key(100 + i), x.shape, x.dtype), p)
            extra = {"vs": vs, "hvs": jax.jvp(jax.grad(loss), (p,), (vs,))[1]}
        upd, s = opt.update(g, s, p, **extra)
        return optax.apply_updates(p, upd), s

    params = as_tree(kind, [jnp.asarray(x) for x in init])
    state = jax.jit(opt.init, compiler_options=FAST_COMPILE)(params)
    for i in range(STEPS):
        params, state = step(params, state, i)
    return (jax.tree_util.tree_leaves(params),
            [s for s in state if hasattr(s, "precond")][0].precond)


def torch_params(kind):
    shapes = tuple(TREE[k] for k in sorted(TREE)) if kind == "tree" else kind
    h, c, init = problem(shapes)
    leaves = [torch.from_numpy(x).requires_grad_() for x in init]
    return torch.from_numpy(h), torch.from_numpy(c), leaves


def make(cls, kind, leaves, **kw):
    params = list(zip(sorted(TREE), leaves)) if kind == "tree" else leaves
    return cls(params, lr=LR, device="cpu", draw=jax_draw, **kw)


def torch_steps(cls, mode, kind, kw):
    h, c, leaves = torch_params(kind)
    opt = make(cls, kind, leaves, **kw)
    loss = lambda: torch_loss(h, c, leaves)   # noqa: E731
    for i in range(STEPS):
        if mode in ("whitening", "hvp_fn", "vs"):
            opt.zero_grad()
            with torch.enable_grad():
                loss().backward()
        if mode == "whitening":
            opt.step()
        elif mode == "closure":
            opt.step(loss)
        else:
            vs = [jax_draw("normal", np.asarray(jax.random.key_data(
                jax.random.key(100 + i)))[None], p.shape, p.dtype)[0] for p in leaves]
            hvs = [hv.reshape(p.shape) for hv, p in zip(
                (h @ torch.cat([v.reshape(-1) for v in vs])).split(
                    [p.numel() for p in leaves]), leaves)]
            if mode == "hvp_fn":
                opt.step(hvp_fn=lambda probes: [hv.reshape(p.shape) for hv, p in zip(
                    (h @ torch.cat([v.reshape(-1) for v in probes])).split(
                        [p.numel() for p in leaves]), leaves)])
            else:
                opt.step(vs=vs, hvs=hvs)
    return leaves, opt


def close(got, ref, what):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(to_np(got), ref, rtol=RTOL,
                               atol=RTOL * max(np.abs(ref).max(initial=0.0), 1e-300),
                               err_msg=what)


def hold(name, cls, mode, kind, kw, fits):
    jmode = "hvp_fn" if mode == "closure" else mode
    jleaves, jst = jax_steps(name, jmode, kind, tuple(sorted(kw.items())))
    leaves, opt = torch_steps(cls, mode, kind, kw)
    for i, (p, j) in enumerate(zip(leaves, jleaves)):
        close(p, j, f"param {i}")
    if cls is Affine:
        for i, p in enumerate(leaves):
            close(opt.state[p]["ql"], jst[i].ql, f"ql {i}")
            close(opt.state[p]["qr"], jst[i].qr, f"qr {i}")
    else:
        for f in opt.precond._fields:
            close(getattr(opt.precond, f), getattr(jst, f), f)
    assert opt.fit_steps == sum(fits), (opt.fit_steps, fits)
    return opt


# arm -> (JAX factory, class, mode, leaves, kwargs)
ARMS = {
    "xmat_whiten_odd": ("xmat", XMat, "whitening", LEAVES, dict(momentum=0.9)),
    "xmat_newton_even_1st": ("xmat", XMat, "closure", EVEN, dict(
        step_normalizer="1st", preconditioner_init_scale=0.5,
        preconditioner_update_probability=GATED, grad_clip_max_norm=2.0)),
    "xmat_whiten_1st_gated": ("xmat", XMat, "whitening", EVEN, dict(
        step_normalizer="1st", preconditioner_update_probability=GATED,
        weight_decay=0.01)),
    "splu_whiten": ("splu", SPLU, "whitening", LEAVES, dict(
        rank=4, weight_decay=0.01, weight_decay_mode="classic")),
    "splu_newton": ("splu", SPLU, "closure", LEAVES, dict(rank=3, momentum=0.5)),
    "newton_inv_newton": ("newton_inv", NewtonInv, "closure", LEAVES, dict(
        momentum=0.9, grad_clip_max_norm=1.0)),
    "newton_inv_whiten": ("newton_inv", NewtonInv, "whitening", EVEN, dict(
        momentum=0.5, preconditioner_init_scale=1.5)),
    "newton_inv_1st_vs": ("newton_inv", NewtonInv, "vs", LEAVES, dict(
        step_normalizer="1st", preconditioner_type="Newton")),
    "uvd_whiten": ("uvd", UVd, "whitening", LEAVES, dict(rank=3, momentum=0.9)),
    "uvd_newton_1st": ("uvd", UVd, "closure", EVEN, dict(
        rank=2, step_normalizer="1st", preconditioner_update_probability=GATED,
        preconditioner_init_scale=2.0)),
    "affine_whiten": ("affine", Affine, "whitening", "tree", dict(
        momentum=0.9, preconditioner_max_skew=1.5)),
    "affine_whiten_1st": ("affine", Affine, "whitening", "tree", dict(
        step_normalizer="1st", preconditioner_max_size=4,
        preconditioner_update_probability=GATED)),
    "affine_newton": ("affine", Affine, "closure", "tree", dict(
        momentum=0.9, grad_clip_max_norm=3.0)),
    "affine_newton_hvp_fn": ("affine", Affine, "hvp_fn", "tree", dict(
        preconditioner_init_scale=0.5, preconditioner_update_probability=GATED,
        step_normalizer="1st", preconditioner_max_skew=1.0)),
    "affine_newton_vs": ("affine", Affine, "vs", "tree", dict(
        preconditioner_type="Newton", weight_decay=0.1)),
}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_three_steps_match_jax(arm):
    name, cls, mode, kind, kw = ARMS[arm]
    kw = dict(kw)
    if mode in ("closure", "hvp_fn"):
        kw["preconditioner_type"] = "Newton"
    fits = [True] * STEPS
    if "preconditioner_update_probability" in kw:
        kw["seed"], fits = mixed_seed()
    if mode == "vs":
        fits = [True] * STEPS
    hold(name, cls, mode, kind, kw, fits)


@pytest.mark.parametrize("cls", [XMat, SPLU, NewtonInv, UVd, Affine])
def test_state_dict_round_trip(cls):
    """Two steps, the state saved and loaded into a fresh optimizer
    (``torch.load(weights_only=True)``), two more steps on each: bit for
    bit the same parameters and state."""
    kind = "tree" if cls is Affine else LEAVES
    runs = []
    for resume in (False, True):
        h, c, leaves = torch_params(kind)
        kw = dict(momentum=0.9, preconditioner_update_probability=GATED, seed=3)
        if cls in (SPLU, UVd):
            kw["rank"] = 3
        opt = make(cls, kind, leaves, **kw)
        for i in range(4):
            if resume and i == 2:
                buf = io.BytesIO()
                torch.save(opt.state_dict(), buf)
                buf.seek(0)
                saved = torch.load(buf, weights_only=True)
                opt = make(cls, kind, leaves, **kw)
                opt.load_state_dict(saved)
            opt.zero_grad()
            torch_loss(h, c, leaves).backward()
            opt.step()
        runs.append((leaves, opt))
    (a, oa), (b, ob) = runs
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    sa, sb = oa.state_dict(), ob.state_dict()
    assert sa["psgd"]["count"] == sb["psgd"]["count"] == 4
    assert torch.equal(sa["psgd"]["key"], sb["psgd"]["key"])
    flat = lambda s: [x for d in (s["state"], s["psgd"].get("precond", {}))  # noqa: E731
                      for v in d.values()
                      for x in (v.values() if isinstance(v, dict) else [v])]
    assert all(torch.equal(x, y) for x, y in zip(flat(sa), flat(sb)))
    if cls is not Affine:
        bad = make(cls, EVEN, torch_params(EVEN)[2])
        with pytest.raises(ValueError, match="does not match"):
            bad.load_state_dict(sa)


def test_factories_and_rules():
    p = [torch.zeros(4, 3, requires_grad=True)]
    assert isinstance(xmat(p, 0.1, device="cpu"), XMat)
    assert splu(p, device="cpu", rank=20).precond.l12.shape == (12, 11)
    assert newton_inv(p, device="cpu").param_groups[0]["lr"] == 0.01
    assert uvd(p, device="cpu", rank=2).precond.u.shape == (12, 2)
    assert affine(p, device="cpu").state[p[0]]["ql"].shape == (4, 4)
    # the conditional lr_preconditioner default
    assert XMat(p, device="cpu").param_groups[0]["lr_preconditioner"] == 0.1
    assert XMat(p, device="cpu", step_normalizer="1st").param_groups[0][
        "lr_preconditioner"] == 0.01
    for cls in (XMat, SPLU, NewtonInv, UVd, Affine):
        with pytest.raises(ValueError, match="preconditioner_type"):
            cls(p, device="cpu", preconditioner_type="other")
        with pytest.raises(ValueError, match="step_normalizer"):
            cls(p, device="cpu", step_normalizer="3rd")
        with pytest.raises(ValueError, match="weight_decay_mode"):
            cls(p, device="cpu", weight_decay_mode="other")
        # complex (A3b): complex parameters, or a complex preconditioner
        # over real ones
        cx = cls([torch.zeros(3, dtype=torch.complex64)], device="cpu")
        assert all(x.dtype == torch.complex64 for x in (
            cx.precond if cls is not Affine else
            cx.state[cx.param_groups[0]["params"][0]].values()))
        cq = cls(p, device="cpu", preconditioner_dtype=torch.complex128)
        assert all(x.dtype == torch.complex128 for x in (
            cq.precond if cls is not Affine else
            (cq.state[p[0]]["ql"], cq.state[p[0]]["qr"])))
        with pytest.raises(ValueError, match="closure"):
            cls(p, device="cpu", preconditioner_type="Newton").step()
        with pytest.raises(ValueError, match="whitening"):
            cls(p, device="cpu").step(vs=[p[0]], hvs=[p[0]])
        with pytest.raises(ValueError, match="together"):
            cls(p, device="cpu", preconditioner_type="Newton").step(vs=[p[0]])
        if not torch.cuda.is_available():
            # no fallback: the card unless the CPU is asked for
            with pytest.raises(RuntimeError, match="device='cpu'"):
                cls(p)


def test_own_draws_descend():
    """Without the replay hook (torch.Generator normals, threefry
    uniforms) every optimizer takes the quadratic down in 30 steps."""
    for cls, kw in ((XMat, {}), (SPLU, dict(rank=3)), (UVd, dict(rank=3)),
                    (NewtonInv, dict(preconditioner_type="Newton")),
                    (Affine, {}), (Affine, dict(preconditioner_type="Newton"))):
        h, c, leaves = torch_params(LEAVES)
        opt = cls(leaves, lr=0.1, device="cpu", momentum=0.9, **kw)
        loss = lambda: torch_loss(h, c, leaves)   # noqa: E731
        first = float(loss().detach())
        for _ in range(30):
            if opt.newton:
                opt.step(loss)
            else:
                opt.zero_grad()
                loss().backward()
                opt.step()
        last = float(loss().detach())
        assert last < first - 1.0, (cls.__name__, kw, first, last)


def test_order_is_the_pytree_order():
    """Named parameters are taken in their sorted dotted path (JAX
    ravel_pytree of a dict): XMat pairs the concatenation's entry i with
    n-1-i, so the order is the preconditioner's."""
    leaves = [torch.arange(3.0, dtype=torch.float64).requires_grad_(),
              torch.arange(2.0, dtype=torch.float64).requires_grad_()]
    opt = XMat([("z", leaves[0]), ("a", leaves[1])], device="cpu")
    assert opt.param_groups[0]["params"][0] is leaves[1]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert opt._flat([p.detach() for p in opt.param_groups[0]["params"]]).tolist() \
            == [0.0, 1.0, 0.0, 1.0, 2.0]
