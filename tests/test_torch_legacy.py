"""The port's legacy preconditioner functions (psgd_torch_tpu_torch
.precond.legacy, .splu, .xmat, .affine and the legacy helpers of
.ops.linalg) against the JAX package's, in float64 on the same numpy
inputs and the JAX package's own draws: every function, every dispatch
branch of the Kron pair, both step normalizers, both of UVd's coin
branches and the balances taken and not, the odd and even XMat, every
side combination of Affine with and without v, and the matrixizer's plans
for GPT-2 124M's and LeNet5's shapes.  Each update runs three times in a
row from the identity-like start, each result held.

Tolerance: rtol 1e-9 (atol 1e-9 of the largest entry) in float64.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_torch_tpu.ops import linalg as jlinalg
from psgd_torch_tpu.precond import affine as jaffine
from psgd_torch_tpu.precond import legacy as jlegacy
from psgd_torch_tpu.precond import splu as jsplu
from psgd_torch_tpu.precond import xmat as jxmat
from psgd_torch_tpu_torch.ops import linalg as tlinalg
from psgd_torch_tpu_torch.precond import affine as taffine
from psgd_torch_tpu_torch.precond import legacy as tlegacy
from psgd_torch_tpu_torch.precond import splu as tsplu
from psgd_torch_tpu_torch.precond import xmat as txmat
from test_torch_kron import _JDT, to_np

RTOL = 1e-9
UPDATES = 3
CPU = "cpu"
F64 = torch.float64


def close(got, ref, what=""):
    ref = to_np(ref)
    np.testing.assert_allclose(to_np(got), ref, rtol=RTOL,
                               atol=RTOL * max(np.abs(ref).max(initial=0.0), 1e-300),
                               err_msg=what)


def close_state(got, ref, what=""):
    for i, (a, b) in enumerate(zip(got, ref)):
        close(a, b, f"{what}[{i}]")


def t(x):
    return torch.from_numpy(np.array(x, np.float64))


def j(x):
    return jnp.asarray(to_np(x))


def pairs(seed, shape, n=UPDATES):
    """n (dx, dg) pairs of standard normals, numpy seeded."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape), rng.standard_normal(shape))
            for _ in range(n)]


# the references' programs are small: XLA's backend optimizations would
# take most of the file's time to compile them
FAST_COMPILE = {"xla_backend_optimization_level": 0}


@functools.lru_cache(maxsize=None)
def _drawer(kind, shape, dtype):
    """``test_torch_kron``'s batched draw, compiled with FAST_COMPILE."""
    if kind == "normal":
        fn = lambda k: jax.random.normal(k, shape, _JDT[dtype])   # noqa: E731
    else:
        fn = lambda k: jax.random.uniform(k, shape)   # noqa: E731
    return jax.jit(jax.vmap(fn), compiler_options=FAST_COMPILE)


def fast_draw(kind, keys, shape, dtype):
    """The replay hook ``test_torch_kron.jax_draw`` (the same draws, complex
    for a complex dtype), its programs compiled with FAST_COMPILE."""
    out = _drawer(kind, tuple(shape), dtype)(jnp.asarray(np.asarray(keys, np.uint32)))
    wide = jnp.complex128 if dtype.is_complex else jnp.float64
    return torch.from_numpy(np.array(out.astype(wide))).to(dtype)


@functools.lru_cache(maxsize=None)
def J(fn, *static):
    """``fn`` jitted once (its ``static`` arguments by name): each JAX
    reference compiles once per configuration."""
    return jax.jit(fn, static_argnames=static, compiler_options=FAST_COMPILE)


@functools.partial(jax.jit, compiler_options=FAST_COMPILE)
def _key_uniforms(start):
    """key(start + i) and (uniform(kb), uniform(kc)), (kb, kc) =
    split(key), for i < 2000."""
    keys = jax.vmap(jax.random.key)(start + jnp.arange(2000))
    sub = jax.vmap(jax.random.split)(keys)
    return keys, jax.vmap(jax.vmap(jax.random.uniform))(sub)


def find_key(pred, start=0):
    """The first key(i), i >= start, whose (uniform(kb), uniform(kc))
    satisfy ``pred``."""
    keys, us = _key_uniforms(start)
    for i, (ub, uc) in enumerate(np.asarray(us)):
        if pred(ub, uc):
            return keys[i], float(ub), float(uc)
    raise AssertionError("no key found")


# ---------------------------------------------------------------------------
# ops.linalg helpers
# ---------------------------------------------------------------------------


def test_linalg_helpers_match_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((7, 7))
    close(tlinalg.triu01(t(a)), J(jlinalg.triu01)(jnp.asarray(a)), "triu01")

    g = rng.standard_normal((5, 3))
    key = jax.random.key(3)
    jv, jh = J(jlinalg.damped_pair_vg)(jnp.asarray(g), key, 0.01)
    tv, th = tlinalg.damped_pair_vg(t(g), 0.01, v=t(jv))
    close(tv, jv, "v")
    close(th, jh, "damped g")
    v, _ = tlinalg.damped_pair_vg(t(g), generator=torch.Generator().manual_seed(0))
    assert v.shape == (5, 3) and v.dtype == F64

    base = np.eye(6) + 0.1 * rng.standard_normal((6, 6))
    inv = np.linalg.inv(base)
    u, w = rng.standard_normal((6, 2)), 0.1 * rng.standard_normal((2, 6))
    got = tlinalg.woodbury_identity(t(inv), t(u), t(w))
    close(got, J(jlinalg.woodbury_identity)(*map(jnp.asarray, (inv, u, w))), "woodbury")
    close(got, np.linalg.inv(base + u @ w), "woodbury is the inverse")
    # bf16 lifts its small solve to f32 and returns bf16
    lo = tlinalg.woodbury_identity(*(t(x).to(torch.bfloat16) for x in (inv, u, w)))
    assert lo.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# legacy dense P and the shape-dispatching Kron pair
# ---------------------------------------------------------------------------


def test_dense_p_matches_jax():
    n = 12
    q = torch.eye(n, dtype=F64)
    jq = jnp.eye(n)
    for dx, dg in pairs(1, (3, 4)):
        q = tlegacy.update_precond_dense(q, t(dx), t(dg), lr=0.1)
        jq = J(jlegacy.update_precond_dense)(jq, jnp.asarray(dx), jnp.asarray(dg), lr=0.1)
        close(q, jq, "dense Q")
    g = np.random.default_rng(2).standard_normal((3, 4))
    close(tlegacy.precond_grad_dense(q, t(g)),
          J(jlegacy.precond_grad_dense)(jq, jnp.asarray(g)), "dense P g")


KRON_KINDS = [("dense", "dense"), ("dense", "norm"), ("dense", "scale"),
              ("norm", "dense"), ("norm", "scale"), ("scale", "dense"),
              ("scale", "norm")]


@pytest.mark.parametrize("kinds", KRON_KINDS, ids="-".join)
def test_kron_dispatch_matches_jax(kinds):
    """Every branch of the dispatcher, the transposed returns included."""
    shape = (6, 5)
    ql, qr = tlegacy.init_kron_legacy(shape, *kinds, scale=0.7, dtype=F64,
                                      device=CPU)
    jql, jqr = J(jlegacy.init_kron_legacy, "shape", "kind_l", "kind_r", "dtype")(
        shape, *kinds, scale=0.7, dtype=jnp.float64)
    close_state((ql, qr), (jql, jqr), "init")
    for i, (dx, dg) in enumerate(pairs(KRON_KINDS.index(kinds), shape)):
        ql, qr = tlegacy.update_precond_kron(ql, qr, t(dx), t(dg), lr=0.2)
        jql, jqr = J(jlegacy.update_precond_kron)(jql, jqr, jnp.asarray(dx),
                                               jnp.asarray(dg), lr=0.2)
        close_state((ql, qr), (jql, jqr), f"update {i}")
    g = np.random.default_rng(5).standard_normal(shape)
    close(tlegacy.precond_grad_kron(ql, qr, t(g)),
          J(jlegacy.precond_grad_kron)(jql, jqr, jnp.asarray(g)), "P g")


def test_kron_rules():
    with pytest.raises(ValueError, match="kind"):
        tlegacy.init_kron_legacy((3, 4), "other", device=CPU)
    ql, qr = tlegacy.init_kron_legacy((3, 4), "norm", "norm", dtype=F64, device=CPU)
    with pytest.raises(ValueError, match="shapes"):
        tlegacy.update_precond_kron(ql, qr, torch.ones(3, 4, dtype=F64),
                                    torch.ones(3, 4, dtype=F64))
    with pytest.raises(ValueError, match="shapes"):
        tlegacy.precond_grad_kron(ql, qr, torch.ones(3, 4, dtype=F64))
    # complex (A3b): complex64 factors
    ql, qr = tlegacy.init_kron_legacy((3, 4), "dense", "norm",
                                      dtype=torch.complex64, device=CPU)
    assert ql.dtype == qr.dtype == torch.complex64


# ---------------------------------------------------------------------------
# Newton with a kept inverse, the triangular Newton, UVd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("normalizer", ["1st", "2nd"])
def test_newton_inv_and_tri_match_jax(normalizer):
    n = 10
    st = tlegacy.init_newton_inv(n, 2.0, F64, CPU)
    jst = J(jlegacy.init_newton_inv, "n", "dtype")(n, 2.0, jnp.float64)
    q, jq = torch.eye(n, dtype=F64), jnp.eye(n)
    for i, (v, h) in enumerate(pairs(7, (n,))):
        st = tlegacy.update_newton_inv(st, t(v), t(h), lr=0.3,
                                       step_normalizer=normalizer)
        jst = J(jlegacy.update_newton_inv, "step_normalizer")(jst, jnp.asarray(v), jnp.asarray(h),
                                        lr=0.3, step_normalizer=normalizer)
        close_state(st, jst, f"newton_inv {i}")
        q = tlegacy.update_newton_tri(q, t(v), t(h), lr=0.3,
                                      step_normalizer=normalizer)
        jq = J(jlegacy.update_newton_tri, "step_normalizer")(jq, jnp.asarray(v), jnp.asarray(h),
                                       lr=0.3, step_normalizer=normalizer)
        close(q, jq, f"newton_tri {i}")
    close(st.inv_q, np.linalg.inv(to_np(st.q)), "the kept inverse")
    g = np.random.default_rng(8).standard_normal((2, 5))
    close(tlegacy.precond_grad_newton_inv(st, t(g)),
          J(jlegacy.precond_grad_newton_inv)(jst, jnp.asarray(g)), "P g")


def jax_uvd_init(n, rank, key, scale):
    ku, kv = jax.random.split(key)
    draws = [jax.random.normal(k, (n, rank), jnp.float64) for k in (ku, kv)]
    st = tlegacy.init_uvd(n, rank, scale, F64, CPU, u=t(draws[0]), v=t(draws[1]))
    return st, J(jlegacy.init_uvd, "n", "rank", "dtype")(n, rank, key, scale,
                                                       jnp.float64)


# (normalizer, which coin branch, balance taken)
UVD_CASES = [("2nd", "u", False), ("2nd", "v", True), ("1st", "u", True),
             ("1st", "v", False)]


@pytest.mark.parametrize("normalizer,branch,balance", UVD_CASES)
def test_uvd_matches_jax(normalizer, branch, balance):
    n, rank = 20, 3
    st, jst = jax_uvd_init(n, rank, jax.random.key(11), 1.5)
    close_state(st, jst, "init")
    start = 0
    for i, (v, h) in enumerate(pairs(13, (4, 5))):
        key, ub, uc = find_key(lambda b, c: (c < 0.5) == (branch == "u")
                               and (b < 0.01) == (balance and i == 1), start)
        start += 2000
        st = tlegacy.update_uvd(st, t(v), t(h), u_balance=ub, u_coin=uc,
                                lr=0.2, step_normalizer=normalizer)
        jst = J(jlegacy.update_uvd, "step_normalizer")(jst, jnp.asarray(v), jnp.asarray(h), key,
                                 lr=0.2, step_normalizer=normalizer)
        close_state(st, jst, f"update {i}")
    g = np.random.default_rng(14).standard_normal((4, 5))
    close(tlegacy.precond_grad_uvd(st, t(g)),
          J(jlegacy.precond_grad_uvd)(jst, jnp.asarray(g)), "P g")


def test_uvd_own_draws_and_rank0():
    gen = torch.Generator().manual_seed(0)
    st = tlegacy.init_uvd(30, 4, 1.0, F64, CPU, generator=gen)
    assert abs(float(torch.linalg.vector_norm(st.u)) - 0.1 ** 0.5) < 1e-12
    st0, jst0 = jax_uvd_init(8, 0, jax.random.key(1), 1.0)
    close_state(st0, jst0, "rank 0")


# ---------------------------------------------------------------------------
# SPLU and XMat
# ---------------------------------------------------------------------------


def test_splu_matches_jax():
    n, r = 14, 4
    st = tsplu.init_splu(n, r, 0.5, F64, CPU)
    jst = J(jsplu.init_splu, "n", "r", "dtype")(n, r, 0.5, jnp.float64)
    close_state(st, jst, "init")
    for i, (v, h) in enumerate(pairs(21, (n,))):
        st = tsplu.update_splu(st, t(v), t(h), lr=0.2)
        jst = J(jsplu.update_splu)(jst, jnp.asarray(v), jnp.asarray(h), lr=0.2)
        close_state(st, jst, f"update {i}")
    g = np.random.default_rng(22).standard_normal((n,))
    close(tsplu.precond_grad_splu(st, t(g)), J(jsplu.precond_grad_splu)(jst, jnp.asarray(g)))
    with pytest.raises(ValueError, match="rank"):
        tsplu.init_splu(4, 4, device=CPU)


@pytest.mark.parametrize("n", [9, 10])
@pytest.mark.parametrize("normalizer", ["1st", "2nd"])
def test_xmat_matches_jax(n, normalizer):
    st = txmat.init_xmat(n, 1.3, F64, CPU)
    jst = J(jxmat.init_xmat, "n", "dtype")(n, 1.3, jnp.float64)
    for i, (v, h) in enumerate(pairs(31 + n, (n,))):
        st = txmat.update_xmat(st, t(v), t(h), lr=0.2, step_normalizer=normalizer)
        jst = J(jxmat.update_xmat, "step_normalizer")(jst, jnp.asarray(v), jnp.asarray(h), lr=0.2,
                                step_normalizer=normalizer)
        close_state(st, jst, f"update {i}")
    if n % 2:    # the centre's anti-diagonal coupling stays 0
        assert float(st.b[n // 2]) == 0.0
    g = np.random.default_rng(32).standard_normal((n,))
    key = jax.random.key(33)
    jw = J(jxmat.update_xmat_whiten, "step_normalizer")(jst, jnp.asarray(g), key, lr=0.2,
                                  step_normalizer=normalizer)
    w = txmat.update_xmat_whiten(st, t(g), lr=0.2, step_normalizer=normalizer,
                                 v=t(jax.random.normal(key, (n,), jnp.float64)))
    close_state(w, jw, "whiten")
    close(txmat.precond_grad_xmat(w, t(g)), J(jxmat.precond_grad_xmat)(jw, jnp.asarray(g)))


# ---------------------------------------------------------------------------
# Affine
# ---------------------------------------------------------------------------

# GPT-2 124M's leaves (stacked as the models hold them) and LeNet5's
# [W; b] matrices, and a few others: 1-D, 4-D, ties
PLAN_SHAPES = [(50304, 768), (1024, 768), (12, 768), (12, 768, 2304),
               (12, 2304), (12, 768, 768), (12, 768, 3072), (12, 3072),
               (12, 3072, 768), (768,), (26, 6), (151, 16), (401, 120),
               (121, 84), (85, 10), (), (5,), (3, 4, 5, 6), (6, 5, 4),
               (2, 2, 2)]


def test_matrixizer_plans_match_jax():
    for shape in PLAN_SHAPES:
        assert tuple(taffine.matrixizer(shape)) == tuple(jaffine.matrixizer(shape)), shape
    # the tie of GPT-2's stacks goes to the first plan of least size
    assert taffine.matrixizer((12, 768, 2304)).matrix_shape == (9216, 2304)
    rng = np.random.default_rng(41)
    for shape in [(3, 4, 5, 6), (6, 5, 4), (7,), (4, 3)]:
        x = rng.standard_normal(shape)
        plan = taffine.matrixizer(shape)
        m = taffine.to_matrix(plan, t(x))
        close(m, jaffine.to_matrix(jaffine.matrixizer(shape), x))
        back = taffine.from_matrix(plan, m)
        assert torch.equal(back.reshape(shape), t(x))
        close(back, jaffine.from_matrix(jaffine.matrixizer(shape), to_np(m)))


def test_init_affine_side_rules():
    for args in [((6, 5), {}), ((1, 9), {}), ((50, 4), dict(max_skew=2.0)),
                 ((4, 50), dict(max_skew=2.0)), ((30, 40), dict(max_size=35)),
                 ((92, 23), dict(max_skew=2.0))]:
        shape, kw = args
        st = taffine.init_affine(shape, 0.5, dtype=F64, device=CPU, **kw)
        jst = J(jaffine.init_affine, "matrix_shape", "max_size", "max_skew",
                "dtype")(shape, 0.5, dtype=jnp.float64, **kw)
        assert [x.ndim for x in st] == [x.ndim for x in jst], args
        close_state(st, jst, str(args))


SIDES = {"dense-dense": ((6, 5), {}), "dense-diag": ((5, 6), dict(max_size=5)),
         "diag-dense": ((6, 5), dict(max_size=6, max_skew=0.9)),
         "diag-diag": ((6, 5), dict(max_size=4))}


def affine_start(sides):
    shape, kw = SIDES[sides]
    st = taffine.init_affine(shape, 0.8, dtype=F64, device=CPU, **kw)
    jst = jaffine.AffineState(*(j(x) for x in st))    # init: held above
    return shape, st, jst


@pytest.mark.parametrize("normalizer", ["1st", "2nd"])
@pytest.mark.parametrize("sides", sorted(SIDES))
def test_update_affine_matches_jax(sides, normalizer):
    shape, st, jst = affine_start(sides)
    assert [x.ndim for x in st] == [2 if s.startswith("dense") else 1
                                    for s in sides.split("-")]
    start = 0
    for i, (dx, dg) in enumerate(pairs(51, shape)):
        # the balance taken on the second update only
        key, ub, _ = find_key(lambda b, c: (b < 0.01) == (i == 1), start)
        start += 2000
        kb = jax.random.split(key)[0]       # uniform(kb) == ub
        st = taffine.update_affine(st, t(dx), t(dg), u_balance=ub,
                                   lr=0.2, step_normalizer=normalizer)
        jst = J(jaffine.update_affine, "step_normalizer")(jst, jnp.asarray(dx), jnp.asarray(dg), kb,
                                    lr=0.2, step_normalizer=normalizer)
        close_state(st, jst, f"update {i}")
    g = np.random.default_rng(52).standard_normal(shape)
    close(taffine.precond_grad_affine(st, t(g)),
          J(jaffine.precond_grad_affine)(jst, jnp.asarray(g)), "P g")


# drop-v: the three v-free branches and two with-v fallbacks
DROPV = {"diag-diag": ((6, 5), dict(max_size=4), True),
         "diag-dense-tall": ((7, 5), dict(max_size=6), True),
         "dense-diag-short": ((5, 7), dict(max_size=6), True),
         "dense-dense": ((5, 4), {}, False),
         "diag-dense-wide": ((1, 8), {}, False),
         "dense-diag-tall": ((8, 1), {}, False)}


@pytest.mark.parametrize("normalizer", ["1st", "2nd"])
@pytest.mark.parametrize("case", sorted(DROPV))
def test_update_affine_dropv_matches_jax(case, normalizer):
    shape, kw, v_free = DROPV[case]
    st = taffine.init_affine(shape, 1.1, dtype=F64, device=CPU, **kw)
    jst = jaffine.AffineState(*(j(x) for x in st))
    assert taffine.dropv_branch(st) == v_free
    start = 0
    for i, (_, dg) in enumerate(pairs(61, shape)):
        # key -> (kb, kv): kb the balance (taken on the second update), kv v
        key, ub, _ = find_key(lambda b, c: (b < 0.01) == (i == 1), start)
        start += 2000
        kv = jax.random.split(key)[1]
        v = None if v_free else t(jax.random.normal(kv, shape, jnp.float64))
        st = taffine.update_affine_dropv(st, t(dg), u_balance=ub, v=v, lr=0.2,
                                         step_normalizer=normalizer)
        jst = J(jaffine.update_affine_dropv, "step_normalizer")(jst, jnp.asarray(dg), key, lr=0.2,
                                          step_normalizer=normalizer)
        close_state(st, jst, f"update {i}")
    own = taffine.update_affine_dropv(st, t(dg), u_balance=0.5,
                                      generator=torch.Generator().manual_seed(0))
    assert all(torch.isfinite(x).all() for x in own)
