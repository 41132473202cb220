"""The NS update's split and tiled routes (psgd_torch_tpu_torch.ops.kernels)
against the JAX package: the width rule, the XLA tail on replayed draws,
and the Pallas routes themselves run in interpret mode on the CPU.

On the CPU every wrapper runs its plain version; the CUDA kernels are held
against those plain versions on the card (tests/test_torch_kernels_gpu.py
and chip_smoke.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from psgd_torch_tpu.ops import pallas_kernels as pk
from psgd_torch_tpu.precond.kron import _ns_tail_stacked_xla
from psgd_torch_tpu_torch.ops import fastrand, kernels

_TDT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
WIDTHS = [128, 768, 1280, 1408, 1536, 1664, 2048, 2176, 2560, 3072, 3200,
          4096, 4224]


def _jax_route(n, jdt):
    """The route pallas_kernels.fused_ns_update takes (:164-176), or
    "single" where precond.kron runs the XLA tail instead."""
    if not pk.ns_update_supported(n, jdt):
        return "single"
    bf16 = jnp.dtype(jdt) == jnp.dtype(jnp.bfloat16)
    if n <= (pk._NS_SINGLE_MAX if bf16 else pk._NS_SINGLE_MAX_F32):
        return "single"
    return "split" if n <= (pk._NS_SPLIT_MAX if bf16 else pk._NS_SPLIT_MAX_F32) \
        else "tiled"


@pytest.mark.parametrize("jdt", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("n", WIDTHS)
def test_route_rule_matches_jax(n, jdt):
    assert kernels.ns_route(n, _TDT[jdt]) == _jax_route(n, jdt)
    # the dtypes the JAX package sends to its XLA tail take the "xla" route
    assert kernels.ns_route(n, torch.float64) == "xla"
    assert not pk.ns_update_supported(n, jnp.float64)


def test_route_rule_off_the_128_grid():
    for n in (200, 1600, 2100, 2600):
        assert kernels.ns_route(n, torch.bfloat16) == "single"
        assert not pk.ns_update_supported(n, jnp.bfloat16)


def _inputs(b, n, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((b, n, n)) / n ** 0.5
    term1 = a @ np.swapaxes(a, 1, 2) + 0.5 * np.eye(n)
    q = 0.7 * np.eye(n) + 0.02 * rng.standard_normal((b, n, n))
    return term1.astype(dtype), q.astype(dtype)


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("route", ["split", "tiled"])
def test_plain_route_matches_xla_tail_on_replayed_draws(route, n):
    """f64 with the JAX draws replayed: every storage rounding is the
    identity, so each route is the XLA tail's arithmetic reordered (the
    tiled bound divides each product by the normalizer, its combine sums
    left to right).  rtol 1e-10."""
    b, k = 3, 32
    term1, q = _inputs(b, n, n)
    lips = np.array([0.0, 2.0, 40.0])
    term2 = np.full(b, 3.0)
    root = jax.random.split(jax.random.PRNGKey(n + 1), 2 * b)
    kb, kp = root[:b], root[b:]
    ref_q, ref_l = _ns_tail_stacked_xla(
        jnp.asarray(q), jnp.asarray(term1), jnp.asarray(lips),
        jnp.asarray(term2), kb, kp, 0.1, 0.9, k)
    starts = tuple(torch.from_numpy(np.array(jax.vmap(
        lambda kk: jax.random.normal(kk, (k, n), jnp.float64))(keys)))
        for keys in (kb, kp))
    seeds = kernels.key_seed_words(np.asarray(kb), "cpu")
    out_q, out_l = kernels.fused_ns_update(
        torch.from_numpy(term1), torch.from_numpy(q), torch.from_numpy(lips),
        torch.from_numpy(term2), seeds, 0.1, 0.9, k=k, starts=starts,
        route=route)
    np.testing.assert_allclose(out_q.numpy(), np.asarray(ref_q), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(out_l.numpy(), np.asarray(ref_l), rtol=1e-10)


def _step_matrix(term1, seed):
    """A step matrix S that differs from term1, as the Newton fit's
    S = (A + B) - 2 B next to its bound's matrix A + B: term1 minus twice
    a Wishart matrix."""
    b, n, _ = term1.shape
    rng = np.random.default_rng(seed + 1000)
    w = rng.standard_normal((b, n, n)) / n ** 0.5
    return (term1 - 2.0 * (w @ np.swapaxes(w, 1, 2))).astype(term1.dtype)


@pytest.mark.parametrize("route", ["single", "split", "tiled"])
def test_plain_route_with_step_mat_matches_xla_tail(route):
    """The Newton call: the bound and L' from term1, the step through a
    separate S (``step_mat``), against ``_ns_tail_stacked_xla(...,
    step_mat=S)``; f64 with the JAX draws replayed, term2 0 on two layers
    and 3 on the third, rtol 1e-10.  S moves q' away from the call without
    it."""
    b, k, n = 3, 32, 128
    term1, q = _inputs(b, n, 7 * n)
    step = _step_matrix(term1, n)
    lips = np.array([0.0, 2.0, 40.0])
    term2 = np.array([0.0, 0.0, 3.0])
    root = jax.random.split(jax.random.PRNGKey(n + 5), 2 * b)
    kb, kp = root[:b], root[b:]
    ref_q, ref_l = _ns_tail_stacked_xla(
        jnp.asarray(q), jnp.asarray(term1), jnp.asarray(lips),
        jnp.asarray(term2), kb, kp, 0.1, 0.9, k, step_mat=jnp.asarray(step))
    starts = tuple(torch.from_numpy(np.array(jax.vmap(
        lambda kk: jax.random.normal(kk, (k, n), jnp.float64))(keys)))
        for keys in (kb, kp))
    args = (torch.from_numpy(term1), torch.from_numpy(q), torch.from_numpy(lips),
            torch.from_numpy(term2), kernels.key_seed_words(np.asarray(kb), "cpu"),
            0.1, 0.9)
    out_q, out_l = kernels.fused_ns_update(*args, k=k, starts=starts, route=route,
                                           step_mat=torch.from_numpy(step))
    np.testing.assert_allclose(out_q.numpy(), np.asarray(ref_q), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(out_l.numpy(), np.asarray(ref_l), rtol=1e-10)
    without = kernels.fused_ns_update(*args, k=k, starts=starts, route=route)[0]
    assert (without - out_q).abs().max() > 1e-3


def _torch_args(term1, q, seed):
    b = q.shape[0]
    seeds = kernels.key_seed_words(fastrand.split(fastrand.prng_key(seed), b),
                                   "cpu")
    return (torch.from_numpy(np.asarray(term1, np.float32)).to(q.dtype), q,
            torch.zeros(b), torch.full((b,), 3.0), seeds, 0.1, 0.9)


def test_routes_differ_only_in_storage():
    """In f64 storing is the identity, so the three routes agree to
    rounding; in bf16 the split and tiled routes store q1 (and R, RQ, RRQ)
    in bf16, so they differ from the single route by that rounding
    (~2^-8 relative to the step, well under 1e-2 of q')."""
    term1, q = _inputs(2, 256, 3)
    for dt, same in ((torch.float64, True), (torch.bfloat16, False)):
        args = _torch_args(term1, torch.from_numpy(q).to(dt), 4)
        args = (args[0].to(dt),) + args[1:]
        outs = {r: kernels.fused_ns_update(*args, k=128, route=r)
                for r in kernels.NS_ROUTES}
        ref = outs["single"][0].double()
        for r in ("split", "tiled"):
            rel = ((outs[r][0].double() - ref).norm() / ref.norm()).item()
            assert (rel < 1e-12) if same else (0 < rel < 1e-2), (dt, r, rel)
            torch.testing.assert_close(outs[r][1].double(),
                                       outs["single"][1].double(),
                                       rtol=1e-12 if same else 2e-2, atol=0)
    with pytest.raises(ValueError, match="route"):
        kernels.fused_ns_update(*args, route="monolith")


def test_default_route_is_the_width_rule():
    """fused_ns_update without ``route`` takes ns_route's choice: a bf16
    factor of width 256 takes the single route, and asking for it gives the
    same bits."""
    term1, q = _inputs(1, 256, 5)
    args = _torch_args(term1, torch.from_numpy(q).to(torch.bfloat16), 6)
    a = kernels.fused_ns_update(*args, k=128)
    b = kernels.fused_ns_update(*args, k=128, route="single")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ---------------------------------------------------------------------------
# the Pallas routes, run in interpret mode on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture
def interpret(monkeypatch):
    """Run every pallas_call of the JAX package in Pallas interpret mode."""
    orig = pk.pl.pallas_call
    monkeypatch.setattr(pk.pl, "pallas_call", functools.partial(
        orig, interpret=pltpu.InterpretParams()))


def _spiked(b, n, seed):
    """(spd, skew) stacks with a dominant eigenvalue (16 against ~4.5) and
    a dominant singular pair: a 2-step subspace bound is then within ~1% of
    the norm from any start.  The interpret mode's PRNG draws one start
    for every seed (its bound sits at 0.80 x the norm on a gapless Wishart
    spectrum, where the port's and the XLA tail's sit at ~0.91 x), so a
    gap keeps these comparisons on the routes' arithmetic, not the draws."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((b, n, n)) / n ** 0.5
    u, w = (rng.standard_normal((b, n, 1)) for _ in range(2))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    w -= u * np.sum(u * w, axis=1, keepdims=True)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    t = lambda x: np.swapaxes(x, 1, 2)
    spd = a @ t(a) + 0.5 * np.eye(n) + 16.0 * u @ t(u)
    skh = t(a) - a + 16.0 * (u @ t(w) - w @ t(u))
    return spd.astype(np.float32), skh.astype(np.float32)


def _jax_inputs(b, n, jdt, seed):
    _, q = _inputs(b, n, seed, np.float32)
    term1, _ = _spiked(b, n, seed)
    seed_words = jnp.stack([jnp.arange(b, dtype=jnp.int32) + seed,
                            jnp.arange(b, dtype=jnp.int32) + 11], -1)
    return jnp.asarray(term1, jdt), jnp.asarray(q, jdt), seed_words


def _hold_against_pallas(route, n, jdt, with_step_mat):
    """The port's route (own Philox draws) against the Pallas route (its own
    PRNG) on ``_spiked`` term1, with or without a separate step matrix."""
    b = 2
    term1, q, seed_words = _jax_inputs(b, n, jdt, n)
    step = None
    if with_step_mat:
        step = jnp.asarray(_step_matrix(np.asarray(term1.astype(jnp.float32)), n),
                           jdt)
    lips, term2 = jnp.zeros(b, jnp.float32), jnp.full(b, 3.0, jnp.float32)
    if route == "single":
        assert _jax_route(n, jdt) == "single"
        ref_q, ref_l = pk.fused_ns_update(term1, q, lips, term2, seed_words,
                                          0.1, 0.9, k=128, step_mat=step)
    else:
        fn = pk._split_ns_update if route == "split" else pk._tiled_ns_update
        ref_q, ref_l = fn(term1, q, lips, term2, seed_words, 0.1, 0.9, 1 / 8,
                          128, step)
    tq = torch.from_numpy(np.array(q.astype(jnp.float32))).to(_TDT[jdt])
    args = _torch_args(np.asarray(term1.astype(jnp.float32)), tq, n)
    ts = None if step is None else _t(step, _TDT[jdt])
    out_q, out_l = kernels.fused_ns_update(*args, k=128, route=route,
                                           step_mat=ts)
    assert out_q.dtype == _TDT[jdt] and out_l.dtype == torch.float32
    ref = np.asarray(ref_q.astype(jnp.float32))
    got = out_q.float().numpy()
    if jdt == jnp.float32:
        rel = np.abs(got - ref).max() / np.abs(ref).max()
        assert rel < 5e-3, rel
    else:
        rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        assert rel < 1e-2, rel
    np.testing.assert_allclose(out_l.numpy(), np.asarray(ref_l), rtol=0.06)


@pytest.mark.parametrize("jdt", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("n", [256, 384])
@pytest.mark.parametrize("route", ["split", "tiled"])
def test_route_matches_pallas_interpret(interpret, route, n, jdt):
    """Own Philox draws against the Pallas route's own PRNG (term1 from
    ``_spiked``), held as the Pallas tests hold the kernels against XLA
    (tests/test_pallas_kernels.py):
    q' within 5e-3 max-abs-relative in f32 and 1e-2 Frobenius-relative in
    bf16; L within rtol 0.06 (the stochastic bound's spread)."""
    _hold_against_pallas(route, n, jdt, with_step_mat=False)


@pytest.mark.parametrize("jdt", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("route", ["single", "split", "tiled"])
def test_route_with_step_mat_matches_pallas_interpret(interpret, route, jdt):
    """The has_step_mat variant of each Pallas route (the single route's
    monolith ``_ns_kernel``, ``_ns_step_kernel``, the tiled ``step_in``)
    against the port's route given the same S (``_step_matrix``, not term1)
    at n = 256, at the tolerances of ``test_route_matches_pallas_interpret``:
    the bound still reads term1, whose spectrum has a gap."""
    _hold_against_pallas(route, 256, jdt, with_step_mat=True)


@pytest.mark.parametrize("jdt", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("mode", ["spd", "skh"])
def test_norm_bound_matches_pallas_interpret(interpret, mode, jdt):
    """The storage-dtype bound against ``_tiled_bound`` in interpret mode, on
    ``_spiked`` matrices: within rtol 0.06 of it, and at most 1.001 x the true norm of the stored
    matrix (f64 eigenvalues)."""
    b, n = 2, 256
    _, _, seed_words = _jax_inputs(b, n, jdt, 9)
    mat = jnp.asarray(_spiked(b, n, 9)[mode == "skh"], jdt)
    tag = 0 if mode == "spd" else kernels.SKH_TAG
    ref = pk._tiled_bound(mat, seed_words, mode=mode, k=128,
                          mxu_bf16=jdt == jnp.bfloat16, tag=tag)
    tm = torch.from_numpy(np.array(mat.astype(jnp.float32))).to(_TDT[jdt])
    seeds = kernels.key_seed_words(fastrand.split(fastrand.prng_key(9), b),
                                   "cpu")
    got = kernels.norm_bound(tm, seeds, mode, tag, k=128)
    assert got.dtype == torch.float32 and got.shape == (b,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0.06)
    m64 = tm.double().numpy()
    true = np.linalg.norm(m64, ord=2, axis=(1, 2))
    assert (got.numpy() <= 1.001 * true).all(), (got, true)


@pytest.fixture(scope="module", params=[jnp.float32, jnp.bfloat16],
                ids=["float32", "bfloat16"])
def tiled_calls(request):
    """The Pallas tiled route run once in interpret mode, every
    pallas_call's kernel, operands and outputs recorded in order."""
    orig = pk.pl.pallas_call
    calls = []

    def recording(kernel, *a, **kw):
        call = orig(kernel, *a, interpret=pltpu.InterpretParams(), **kw)

        def run(*operands):
            out = call(*operands)
            name = getattr(kernel, "func", kernel).__name__
            calls.append((name, operands, out))
            return out
        return run

    jdt = request.param
    term1, q, seed_words = _jax_inputs(2, 256, jdt, 13)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pk.pl, "pallas_call", recording)
        pk._tiled_ns_update(term1, q, jnp.zeros(2, jnp.float32),
                            jnp.full(2, 3.0, jnp.float32), seed_words, 0.1,
                            0.9, 1 / 8, 128, None)
    return _TDT[jdt], calls


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32)))
    return t.to(dtype) if dtype is not None else t


def _only(calls, name):
    found = [c for c in calls if c[0] == name]
    assert found, f"no {name} call recorded"
    return found


def test_tiled_pieces_store_where_the_pallas_route_stores(tiled_calls):
    """Each tiled piece's plain version on the Pallas route's own operands
    (recorded in interpret mode) gives the Pallas kernel's output, in Q's
    dtype: the transpose-subtract bit for bit; the combine to one unit in
    the last place of the stored dtype (XLA may contract a multiply-add the
    plain version rounds twice); the step and the scaled products to f32
    accumulation order (1e-5 of the largest entry, plus in bf16 one unit in
    the last place of each entry, since a reordered f32 sum may round to
    the neighbouring bf16 value), and the traces within 1e-4 of the sum of
    |diagonal| (they cancel)."""
    dt, calls = tiled_calls
    names = [c[0] for c in calls]
    assert names == ["_tiled_bound_kernel", "_tiled_step_kernel",
                     "_tiled_tsub_kernel", "_tiled_bound_kernel",
                     "_tiled_smm_kernel", "_tiled_smm_kernel",
                     "_tiled_combine_kernel"]
    ulp = 2.0 ** -7 if dt == torch.bfloat16 else 2.0 ** -22

    def close(got, ref, exact=False):
        assert got.dtype == dt
        ref = _t(ref)
        diff = (got.float() - ref).abs()
        if exact:
            assert torch.equal(got.float(), ref)
        elif dt == torch.float32:
            assert diff.max() <= 1e-5 * ref.abs().max(), diff.max()
        else:
            tol = ulp * ref.abs() + 1e-5 * ref.abs().max()
            assert (diff <= tol).all(), diff.max()

    (_, (step, q, _, coeff, term2), q1), = _only(calls, "_tiled_step_kernel")
    close(kernels.tiled_step(_t(step, dt), _t(q, dt), _t(coeff), _t(term2)), q1)
    (_, (xt, _), r), = _only(calls, "_tiled_tsub_kernel")
    close(kernels.tsub(_t(xt, dt)), r, exact=True)
    for _, (a, bm, inv), (out, tr) in _only(calls, "_tiled_smm_kernel"):
        got, got_tr = kernels.scaled_matmul_trace(_t(a, dt), _t(bm, dt), _t(inv))
        close(got, out)
        scale = (torch.diagonal(_t(a) @ _t(bm), dim1=-2, dim2=-1).abs().sum(-1)
                 * _t(inv))
        assert ((got_tr - _t(tr)).abs() <= 1e-4 * scale).all(), (got_tr, tr)
    (_, (q1c, rq, rrq, a_step), out), = _only(calls, "_tiled_combine_kernel")
    got = kernels.combine(_t(q1c, dt), _t(rq, dt), _t(rrq, dt), _t(a_step))
    diff = (got.float() - _t(out)).abs()
    assert (diff <= ulp * _t(out).abs() + 1e-30).all(), diff.max()
