"""The port's five examples ported from examples/ (psgd_torch_tpu_torch
.examples: hello_psgd, tensor_rank_decomposition, logistic_regression,
flat_minima_mdl, xor_rnn) and the NS-width sweep
(tools/bench_ns_widths_torch.py) against the JAX package's examples and
tools/bench_ns_widths.py, at small sizes on the CPU.

Each example's pieces are held against the JAX example's on the same
numpy inputs, in float64 on replayed draws (``jax_draw``), at rtol 1e-9
unless a case says otherwise: the optimizer steps of each PSGD arm, the
problems, losses and featurizer (the featurizer bit for bit).  The JAX
examples' own functions are used where they take their sizes from module
constants (monkeypatched smaller); where they fix float32 or a size in
their body (the MDL fit, the XOR cells' main), the JAX side is the same
lines in float64.  Then each example's ``main`` runs on the CPU at 1-3
steps per arm, and the Kron arms' leaf plans (which chip_smoke.py's launch
counts come from) are JAX's.  The sweep runs its plain route on the CPU;
its FLOP model and its route choice are JAX's.
"""

import functools
import importlib.util
import os

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
import psgd_torch_tpu.optim as jopt
from psgd_torch_tpu.models import lenet5 as jlenet5
from psgd_torch_tpu.models import rnn as jrnn
from psgd_torch_tpu.precond import kron as jkron
from psgd_torch_tpu.precond import lra as jlra
from psgd_torch_tpu_torch.examples import (flat_minima_mdl, hello_psgd,
                                           logistic_regression,
                                           tensor_rank_decomposition, xor_rnn)
from psgd_torch_tpu_torch.models import lenet5, rnn
from psgd_torch_tpu_torch.precond import kron as tkron
from test_torch_kron import jax_draw, to_np
from test_torch_legacy import FAST_COMPILE
from test_torch_ns_routes import _jax_route

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-9
trd = tensor_rank_decomposition


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU side in one thread: its plain versions are many small
    operations (the Philox draws alone some hundreds), and under the
    parallel test run's load each multi-threaded one waits on its thread
    pool far longer than it computes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def jax_example(name: str):
    """examples/<name>.py, the JAX example, as a module."""
    return _load(f"examples/{name}.py", f"jax_example_{name}")


@functools.lru_cache(maxsize=None)
def sweep_tool(which: str = "torch"):
    """tools/bench_ns_widths_torch.py (or the JAX tools/bench_ns_widths.py)."""
    path = "tools/bench_ns_widths_torch.py" if which == "torch" else \
        "tools/bench_ns_widths.py"
    return _load(path, f"bench_ns_widths_{which}")


def jit(fn, **kw):
    return jax.jit(fn, compiler_options=FAST_COMPILE, **kw)


def close(got, ref, what="", rtol=RTOL):
    ref = to_np(ref)
    np.testing.assert_allclose(to_np(got), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(initial=0.0), 1e-300),
                               err_msg=what)


def jax_steps(opt, loss, params, steps, newton, batches=None):
    """``steps`` jitted JAX steps of ``opt`` on ``loss(params, *batch)``
    (the Newton arms fed ``make_hvp_fn``); returns (params, the state)."""
    @jit
    def step(p, s, *batch):
        fn = lambda q: loss(q, *batch)   # noqa: E731
        kw = {"hvp_fn": jopt.make_hvp_fn(loss, *batch)} if newton else {}
        upd, s = opt.update(jax.grad(fn)(p), s, p, **kw)
        return optax.apply_updates(p, upd), s

    state = opt.init(params)
    for i in range(steps):
        params, state = step(params, state, *(batches[i] if batches else ()))
    return params, state


def jax_precond(state):
    return [s for s in state if hasattr(s, "precond")][0].precond


# ---------------------------------------------------------------------------
# hello_psgd
# ---------------------------------------------------------------------------


def test_hello_steps_match_jax():
    """Three ``dense_newton`` steps from 0 on the 100-variable Rosenbrock
    function (the JAX example's ``rosenbrock`` and settings, the port's
    ``minimize``): x, Q and L at rtol 1e-9 in f64."""
    jmod = jax_example("hello_psgd")
    x = np.random.default_rng(0).standard_normal(hello_psgd.N)
    close(hello_psgd.rosenbrock(torch.from_numpy(x)), jmod.rosenbrock(jnp.asarray(x)),
          "rosenbrock", 1e-13)
    opt = jopt.dense_newton(**hello_psgd.SETTINGS)
    jx, jst = jax_steps(opt, lambda p: jmod.rosenbrock(p), jnp.zeros(hello_psgd.N), 3,
                        True)
    tx, losses, topt = hello_psgd.minimize(3, "cpu", torch.float64, draw=jax_draw,
                                           every=0)
    assert float(losses[0]) == 50.0 and topt.fit_steps == 3
    close(tx, jx, "x")
    for f in topt.precond._fields:
        close(getattr(topt.precond, f), getattr(jax_precond(jst), f), f)


# ---------------------------------------------------------------------------
# tensor_rank_decomposition
# ---------------------------------------------------------------------------

SMALL = (2, (3, 4, 5))


@pytest.fixture
def small_cp(monkeypatch):
    """The JAX example's problem at (R, I, J, K) = (2, 3, 4, 5) in f64:
    (its loss_fn, its init, the target it closes over)."""
    jmod = jax_example("tensor_rank_decomposition")
    r, (i, j, k) = SMALL
    for name, v in dict(R=r, I=i, J=j, K=k).items():
        monkeypatch.setattr(jmod, name, v)
    key = jax.random.key(0)
    loss_fn, init = jmod.make_problem(key)
    # the target as make_problem draws it (its first split's factors)
    k1, _ = jax.random.split(key)
    truth = [jax.random.normal(jax.random.fold_in(k1, n), (r, s))
             for n, s in enumerate((i, j, k))]
    return loss_fn, init, jnp.einsum("ri,rj,rk->ijk", *truth)


def test_tensor_rank_problem_matches_jax(small_cp):
    """The port's loss at the JAX example's target and factors is JAX's;
    ``make_problem`` draws the target's factors, then the start, in f32
    from one generator (chip_smoke's tensor-rank problem)."""
    loss_fn, init, target = small_cp
    tloss = trd.cp_loss(torch.from_numpy(np.asarray(target)),
                        [torch.from_numpy(np.asarray(x)) for x in init])
    close(tloss, loss_fn(init), "loss", 1e-13)
    r, sizes = SMALL
    fn, got = trd.make_problem(torch.Generator().manual_seed(3), r, sizes, "cpu")
    gen = torch.Generator().manual_seed(3)
    truth = [torch.randn((r, s), generator=gen) for s in sizes]
    want = [torch.randn((r, s), generator=gen) for s in sizes]
    assert all(torch.equal(a, b) and a.dtype == torch.float32 for a, b in zip(got, want))
    assert torch.equal(fn(truth), torch.zeros(()))


# (arm, arguments besides the example's, rtol): KronNewton takes its
# on-the-fly init scale in float32 on both sides (as the JAX transform casts
# before its sums), and the two sum its leaves' 6 to 10 entries in another
# order, which moves the parameters by ~5e-7 relative after two steps; with
# an explicit scale the same arm holds at 1e-9
CP_ARMS = [("DenseNewton", {}, RTOL), ("LRANewton", {}, RTOL), ("KronNewton", {}, 1e-6),
           ("KronNewton", {"preconditioner_init_scale": 1.0}, RTOL)]


@pytest.mark.parametrize("arm,extra,rtol", CP_ARMS)
def test_tensor_rank_newton_arms_match_jax(small_cp, arm, extra, rtol):
    """Two steps of each PSGD arm (the example's settings, JAX's names) on
    the small problem: the port's ``run`` (one step outside the clock, one
    timed) against the JAX factory of the same name, parameters at ``rtol``
    in f64.  The settings are the JAX example's (:107-122)."""
    assert trd.NEWTON == dict(learning_rate=0.2, lr_preconditioner=0.5, momentum=0.9,
                              grad_clip_max_norm=10.0)
    assert sorted(trd.PSGD_ARMS) == ["DenseNewton", "KronNewton", "LRANewton"]
    loss_fn, init, target = small_cp
    factory, kw = trd.PSGD_ARMS[arm]
    kw = dict(kw, **extra)
    opt = getattr(jopt, factory.__name__)(**trd.NEWTON, **kw)
    jparams, _ = jax_steps(opt, loss_fn, list(init), 2, True)
    make = functools.partial(factory, device="cpu", draw=jax_draw, **trd.NEWTON, **kw)
    out, params = trd.run(arm, make, functools.partial(
        trd.cp_loss, torch.from_numpy(np.asarray(target))),
        [torch.from_numpy(np.asarray(x)) for x in init], iters=1)
    assert out["fit_steps"] == 2 and out["final"] < out["start"]
    for n, (p, j) in enumerate(zip(params, jparams)):
        close(p, j, f"{arm} {extra} factor {n}", rtol)


# ---------------------------------------------------------------------------
# logistic_regression
# ---------------------------------------------------------------------------

SIDE = 4


def test_featurize_is_jax_bit_for_bit(monkeypatch):
    """The JAX example's quadrant fold and triangle (SIDE 4, NHWC images)
    against the port's ``featurize`` (NCHW) on the same f32 images: equal
    to the bit, and the feature count."""
    jmod = jax_example("logistic_regression")
    monkeypatch.setattr(jmod, "SIDE", SIDE)
    x = np.random.default_rng(1).standard_normal((5, 2 * SIDE, 2 * SIDE, 1)).astype(
        np.float32)
    got = logistic_regression.featurize(
        torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(), SIDE)
    ref = np.asarray(jmod.featurize(jnp.asarray(x)))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    assert logistic_regression.n_features(SIDE) == ref.shape[1]
    assert logistic_regression.n_features() == 33152


def test_logistic_loss_and_lra_steps_match_jax(monkeypatch):
    """``loss_fn`` at a random W (rtol 1e-12), then two ``lra_whiten``
    steps (the example's settings, W = 0, the on-the-fly init scale) on
    two batches of SIDE-4 features: W at rtol 1e-9 in f64, the LRA state
    at 1e-7 (both sides take U's and V's init norm over their 15,300
    entries and the init scale over W's 1,530 in float32, as the JAX
    package does, summed in another order; U then differs by up to 4.4e-9
    relative)."""
    jmod = jax_example("logistic_regression")
    monkeypatch.setattr(jmod, "SIDE", SIDE)
    assert logistic_regression.LRA == dict(learning_rate=0.05, rank_of_approximation=10,
                                           momentum=0.9)
    rng = np.random.default_rng(2)
    nf = logistic_regression.n_features(SIDE)
    batches = []
    for _ in range(2):
        img = rng.standard_normal((6, 2 * SIDE, 2 * SIDE, 1))
        batches.append((np.asarray(jmod.featurize(jnp.asarray(img))),
                        rng.integers(0, 10, 6)))
    w = rng.standard_normal((nf + 1, 10))
    close(logistic_regression.loss_fn(torch.from_numpy(w), torch.from_numpy(batches[0][0]),
                                      torch.from_numpy(batches[0][1])),
          jmod.loss_fn(jnp.asarray(w), *(jnp.asarray(a) for a in batches[0])),
          "loss", 1e-12)
    opt = jopt.lra_whiten(**logistic_regression.LRA)
    jw, jst = jax_steps(opt, jmod.loss_fn, jnp.zeros((nf + 1, 10)), 2, False,
                        [tuple(jnp.asarray(a) for a in b) for b in batches])
    tw = torch.zeros((nf + 1, 10), dtype=torch.float64, requires_grad=True)
    topt = logistic_regression.arms("cpu")["psgd-lra"]
    topt = topt.func([tw], draw=jax_draw, **topt.keywords)
    for f, y in batches:
        logistic_regression._step(topt, tw, torch.from_numpy(f), torch.from_numpy(y))
    close(tw, jw, "W")
    for f in topt.precond._fields:
        close(getattr(topt.precond, f), getattr(jax_precond(jst), f), f, 1e-7)


# ---------------------------------------------------------------------------
# flat_minima_mdl
# ---------------------------------------------------------------------------

def jax_logdet(params, images, labels, key, steps):
    """The JAX example's ``estimate_logdet_hessian`` (examples/
    flat_minima_mdl.py:53-76) in f64 on a given batch and step count."""
    vec, unravel = jax.flatten_util.ravel_pytree(params)
    st = jlra.init_lra(vec.size, flat_minima_mdl.RANK, jax.random.fold_in(key, 0), 1.0,
                       jnp.float64)

    @jit
    def fit(st, k, lr):
        v = jax.random.normal(k, vec.shape, jnp.float64)
        loss_vec = lambda w: jlenet5.loss_lenet5(unravel(w), images, labels)  # noqa: E731
        _, hv = jax.jvp(jax.grad(loss_vec), (vec,), (v,))
        return jlra.update_lra_newton(st, v, hv, jax.random.fold_in(k, 1), lr=lr,
                                      damping=1e-9)

    for i in range(steps):
        st = fit(st, jax.random.fold_in(key, 100 + i), 0.1 * (0.01 ** (i / steps)))
    return -2.0 * float(jlra.log_det(st))


def test_logdet_fit_matches_jax():
    """Three fits of the log-det estimate at a LeNet5 in f64 on a batch of
    8 (the JAX draws replayed: the LRA init, the probes, the damping, the
    coin): the estimate at rtol 1e-7 (H v by double backward against JAX's
    jvp over grad, equal to rounding, and the init's float32 norm summed
    in another order, carried through fits damped by 1e-9: 7.3e-9 apart
    here).  The flattening is ``ravel_pytree``'s order, bit for bit."""
    jparams = jit(functools.partial(jlenet5.init_lenet5, dtype=jnp.float64))(
        jax.random.key(42))
    images, labels = jit(lambda k: jlenet5.synthetic_mnist(k, 8))(jax.random.key(1))
    images = images.astype(jnp.float64)
    params = lenet5.params_from_jax([np.asarray(p) for p in jparams])
    np.testing.assert_array_equal(
        torch.nn.utils.parameters_to_vector(params).numpy(),
        np.asarray(jax.flatten_util.ravel_pytree(jparams)[0]))
    key = flat_minima_mdl.HESS_KEY
    ref = jax_logdet(jparams, images, labels, jnp.asarray(key), 3)
    data = (torch.from_numpy(np.array(images)).permute(0, 3, 1, 2).contiguous(),
            torch.from_numpy(np.array(labels)).long())
    got = flat_minima_mdl.estimate_logdet_hessian(params, None, steps=3, data=data,
                                                  draw=jax_draw)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, ref, rtol=1e-7)


# ---------------------------------------------------------------------------
# xor_rnn
# ---------------------------------------------------------------------------

# the JAX example's settings (examples/xor_rnn.py:38-52)
XOR_SETTINGS = {"rnn": ("kron_whiten", dict(learning_rate=1e-3,
                                            preconditioner_init_scale=1.0,
                                            lr_preconditioner=0.01)),
                "lstm": ("kron_newton", dict(learning_rate=0.02,
                                             preconditioner_init_scale=1.0,
                                             lr_preconditioner=0.1,
                                             grad_clip_max_norm=10.0))}


@pytest.mark.parametrize("cell", ["rnn", "lstm"])
def test_xor_step_matches_jax(cell):
    """One step of each cell's optimizer (the RNN by ``kron_whiten``, the
    LSTM by ``kron_newton`` with the exact Hvp) from the JAX model's own
    30-unit weights on a batch of 4 at seq_len 8: parameters, Q and L at
    rtol 1e-9 in f64."""
    init, apply_fn, factory, kw = xor_rnn.CELLS[cell]
    assert (factory.__name__, kw) == XOR_SETTINGS[cell]
    jinit, japply = ((jrnn.init_rnn, jrnn.apply_rnn) if cell == "rnn"
                     else (jrnn.init_lstm, jrnn.apply_lstm))
    jparams = jit(functools.partial(jinit, dim_hidden=xor_rnn.HIDDEN,
                                    dtype=jnp.float64))(jax.random.key(1))
    xs, target = jit(lambda k: jrnn.xor_batch(k, 4, 8))(jax.random.key(10))
    xs, target = xs.astype(jnp.float64), target.astype(jnp.float64)

    def jloss(p, xs, target):
        return jrnn.xor_loss(japply(p, xs), target)

    opt = getattr(jopt, factory.__name__)(**kw)
    jp, jst = jax_steps(opt, jloss, jparams, 1, cell == "lstm", [(xs, target)])
    params = {k: v.requires_grad_() for k, v in rnn.params_from_jax(
        {k: np.asarray(v) for k, v in jparams.items()}).items()}
    topt = factory(params.items(), device="cpu", draw=jax_draw, **kw)
    xor_rnn.xor_step(topt, params, apply_fn,
                     *(torch.from_numpy(np.array(a)) for a in (xs, target)))
    assert topt.fit_steps == 1
    for name, st in zip(sorted(params), jax_precond(jst)):
        close(params[name], jp[name], name)
        ours = topt.state[params[name]]
        for a, b in zip(list(ours["q"]) + list(ours["lips"]), list(st.q) + list(st.lips)):
            close(a, b, f"{name} Q / L")


# ---------------------------------------------------------------------------
# the Kron arms' plans (chip_smoke.py's launches per fit step)
# ---------------------------------------------------------------------------

KRON_ARMS = {   # (chip_smoke constant, leaf shapes, max_skew)
    "tensor-rank KronNewton": (chip_smoke.CP_KRON_PER_FIT,
                               [(trd.R, s) for s in (trd.I, trd.J, trd.K)], 1.0),
    "flat minima KronWhiten": (chip_smoke.MDL_KRON_PER_FIT,
                               [(f + 1, o) for f, o in lenet5.LAYERS],
                               flat_minima_mdl.KRON["preconditioner_max_skew"]),
    "xor RNN": (chip_smoke.XOR_PER_FIT["rnn"], [(33, 30), (31, 1)], 1.0),
    "xor LSTM": (chip_smoke.XOR_PER_FIT["lstm"], [(33, 120), (31, 1)], 1.0),
}


@pytest.mark.parametrize("arm", sorted(KRON_ARMS))
def test_kron_arm_plans_match_jax(arm):
    """JAX ``make_kron_plan`` with each arm's settings (max_size inf) gives
    the port's plans, as many dense factors as chip_smoke.py counts NS
    updates per fit step, every one on the single route, and a damping
    per leaf."""
    per_fit, shapes, skew = KRON_ARMS[arm]
    dense = []
    for shape in shapes:
        jp, tp = jkron.make_kron_plan(shape, max_skew=skew), tkron.make_kron_plan(
            shape, max_skew=skew)
        assert jp.is_diag == tp.is_diag, (arm, shape)
        dense += [n for n, d in zip(shape, jp.is_diag) if not d]
    assert per_fit["fused_ns_update"] == len(dense) and per_fit["damped_noise"] == len(shapes)
    newton = arm in ("tensor-rank KronNewton", "xor LSTM")
    assert per_fit["unit_noise"] == (len(shapes) if newton else 0)
    assert per_fit["fused_ns_update.step_mat"] == (len(dense) if newton else 0)
    assert all(_jax_route(n, jnp.float32) == "single" for n in dense)
    assert sum(per_fit[k] for k in ("ns_step", "norm_bound", "tiled_step", "tsub")) == 0


def test_example_shapes_are_the_models():
    """The leaf shapes of KRON_ARMS are the models' own."""
    for cell, shapes in (("rnn", [(33, 30), (31, 1)]), ("lstm", [(33, 120), (31, 1)])):
        params = xor_rnn.make_cell(cell, "cpu")[0]
        assert [tuple(params[k].shape) for k in sorted(params)] == shapes
    got = lenet5.init_lenet5(torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(p.shape) for p in got] == KRON_ARMS["flat minima KronWhiten"][1]


# ---------------------------------------------------------------------------
# each example's main on the CPU
# ---------------------------------------------------------------------------

MAINS = {
    "hello_psgd": (hello_psgd, ["--iters", "3"]),
    "tensor_rank_decomposition": (trd, ["--iters", "2"]),
    "logistic_regression": (logistic_regression, ["--epochs", "1", "--steps_per_epoch",
                                                   "2", "--batch", "16"]),
    "flat_minima_mdl": (flat_minima_mdl, ["--train_steps", "2", "--hess_steps", "2"]),
    "xor_rnn --cell rnn": (xor_rnn, ["--cell", "rnn", "--max_iters", "3", "--seq_len",
                                     "8", "--batch", "4"]),
    "xor_rnn --cell lstm": (xor_rnn, ["--cell", "lstm", "--max_iters", "3", "--seq_len",
                                      "8", "--batch", "4"]),
}


def _leaves(x, key=None):
    """(key, value) of every leaf of a result's dicts and lists."""
    if isinstance(x, dict):
        return [y for k, v in x.items() for y in _leaves(v, k)]
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _leaves(v, key)]
    return [(key, x)]


@pytest.mark.parametrize("name", sorted(MAINS))
def test_example_main_on_the_cpu(name, monkeypatch):
    """``main`` with --device cpu at 1-3 steps per arm (the logistic test
    set and the log-det batch cut to 64) returns finite numbers and the
    fit steps it took; without a card and without --device it raises."""
    monkeypatch.setattr(logistic_regression, "TEST_N", 64)
    monkeypatch.setattr(flat_minima_mdl, "HESS_BATCH", 64)
    mod, argv = MAINS[name]
    out = mod.main(["--device", "cpu"] + argv)
    leaves = _leaves(out)
    values = [v for _, v in leaves if isinstance(v, float)]
    assert values and all(np.isfinite(values)), out
    assert any(v for k, v in leaves if k == "fit_steps"), out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.main(argv)


# ---------------------------------------------------------------------------
# the NS-width sweep
# ---------------------------------------------------------------------------

FIELDS = {"n", "b", "dtype", "route", "k", "gflop", "bound_ms", "bound_by", "error",
          "ms", "tflops", "share", "plain_ms", "q_rel_err", "l_rel_err",
          "bound_over_true", "tol_q", "tol_l", "finite", "within"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sweep_on_the_cpu(dtype, monkeypatch):
    """``sweep([256], dtype, "cpu")``: the wrappers take their plain
    versions for CPU tensors, so the route equals its plain version; the
    record's fields, B = WORK // n (WORK cut from 9216 to 512 here: B = 2,
    the CPU's plain products at B = 36 take minutes on a loaded host),
    JAX's FLOP model, a lower bound."""
    bench, jbench = sweep_tool(), sweep_tool("jax")
    monkeypatch.setattr(bench, "WORK", 512)
    (rec,) = bench.sweep([256], dtype, "cpu", repeats=1)
    assert set(rec) == FIELDS and rec["error"] is None and rec["within"]
    assert rec["b"] == 2 and rec["route"] == "single" and rec["q_rel_err"] == 0.0
    assert rec["gflop"] == jbench.ns_flops(2, 256, rec["k"]) / 1e9
    assert rec["k"] == (128 if dtype == torch.bfloat16 else 32)
    assert 0.5 < rec["bound_over_true"] <= 1.001 and rec["ms"] > 0
    (tiled,) = bench.sweep([256], dtype, "cpu", force_path="tiled", repeats=1)
    assert tiled["route"] == "tiled" and tiled["within"]


@pytest.mark.parametrize("jdt", [jnp.float32, jnp.bfloat16])
def test_sweep_routes_match_jax(jdt):
    """The route the sweep runs at each width is the one JAX's
    ``fused_ns_update`` takes (pallas_kernels.py:164-176, :556-570), above
    the caps and off the 128 grid included (the single route where JAX
    runs its XLA tail); ``--force-path`` overrides it."""
    bench = sweep_tool()
    dtype = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[jdt]
    for n in (256, 768, 1280, 1408, 1536, 1600, 2048, 2560, 3072, 3200, 4096, 5120):
        assert bench.route_for(n, dtype) == _jax_route(n, jdt), n
        assert bench.route_for(n, dtype, "split") == "split"
    assert max(1, bench.WORK // 5120) == 1 and bench.WORK // 1536 == 6
