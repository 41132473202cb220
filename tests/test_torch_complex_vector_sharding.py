"""The port's vector-sharded LRAWhiten, LRANewton and DenseNewton on
complex parameters (JAX ``vector_sharding`` with complex leaves: the LRA
and dense-QEQ row-sharded updates, psgd_torch_tpu/precond/lra.py and
dense.py's row-sharded section) against the JAX package, on the CPU with
4 gloo ranks spawned once for the module (``rank_results``, as
test_torch_vector_sharding.py runs them).

The problem is test_torch_vector_sharding.py's, in its complex form
(``vs.problem(n, cplx=True)``, ``vs.build``, ``vs.steps``): two leaves in
complex128 at n = 22, padded to 24 over 4 ranks (the last rank holds two
pad rows), 3 steps.  The gradient convention: for a real loss of a complex
parameter torch's ``.grad`` is the conjugate of ``jax.grad``'s, so each
side gets its own form of one quadratic (torch 0.5 c |p|^2 + Re(conj(b)
p), JAX Re(0.5 c p^2 + b p), c real): both see the gradient c p + b and
the Hessian action c v, as tests/test_torch_complex_lra_dense.py states.
The whitening and LRA Newton cases are fed that gradient (and explicit
(v, H v) pairs of dyadic values) directly; dense QEQ differentiates its
closure.

Held, on the JAX package's draws (the ranks record them, the parent
answers with ``jax_draw``'s complex normals): each case's parameters,
each rank's rows of U, V and d (of Q), the momentum and the estimates
against the JAX transform at rtol 1e-9 (LRANewton's parameters at
``vs.CLIP_RTOL``: its norm clip acts, its float32 norm summed in another
order), and LRA's log-det; the closure class ``classes.LRAWhiten`` under
``vector_sharding`` against the same JAX reference.  On the port's own
draws: k ranks against one rank fed the shards' draws
(``test_torch_checkpoint_gather.WorldDraws``); the pad rows exact; a
per-rank complex ``state_dict`` round trip bit for bit; a 2-rank
checkpoint gathered (``gather_checkpoint``) and resumed at 1 rank;
``lra_state_specs`` / ``dense_state_specs`` and ``collective_bytes`` of a
complex sum and gather against JAX's.  And the row-sharded Frobenius norm
(``precond.lra._norm``, JAX ``_gnorm``) of a complex row block equals
``vector_norm`` of the whole: it sums real(x conj x), not x x.

The JAX steps are jitted with XLA's backend optimizations off
(``test_torch_legacy.FAST_COMPILE``), which cuts their compiles.
"""

import os
import warnings

import numpy as np
import pytest
import torch

import test_torch_checkpoint_gather as cg
import test_torch_vector_sharding as vs
from test_torch_parallel import rank_results

WORLD = 4
N = 22
N_PAD = 24
RTOL = vs.RTOL
C = torch.complex128
GATHER = (2, 5)              # the collective check's all_gather block per rank
NORM_ROWS = (N_PAD, 3)       # the norm check's whole (n_pad, r) block
CLASS_OPTIONS = dict(lr_params=vs.CASES["whiten"][1]["lr"],
                     **{k: v for k, v in vs.CASES["whiten"][1].items() if k != "lr"})


# ---------------------------------------------------------------------------
# rank side: no JAX
# ---------------------------------------------------------------------------


def _summary(params, opt) -> dict:
    """``vs.state`` with this rank's rows, the fits and LRA's log-det."""
    from psgd_torch_tpu_torch.precond import lra
    out = dict(vs.state(params, opt), lo=opt.lo, n_loc=opt.n_loc,
               fits=opt.fit_steps)
    if hasattr(opt.precond, "u"):
        out["log_det"] = float(lra.log_det(opt.precond, opt.rows))
    return out


def closure_class(mesh, draw) -> dict:
    """``classes.LRAWhiten`` with the whitening case's options under
    vector_sharding, its U and V rows from ``vs.start``, 3 steps of its
    closure (torch's form of the loss)."""
    from psgd_torch_tpu_torch.optim import classes
    init, c, b = vs.problem(N, cplx=True)
    params = {k: torch.tensor(v, requires_grad=True) for k, v in init.items()}
    cs = {k: torch.from_numpy(v) for k, v in c.items()}
    bs = {k: torch.from_numpy(v) for k, v in b.items()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        opt = classes.LRAWhiten(list(params.items()), vector_sharding=(mesh, "fsdp"),
                                device="cpu", draw=draw, **CLASS_OPTIONS)
    inner = opt.optimizer
    u, v = (torch.from_numpy(x[inner.lo:inner.lo + inner.n_loc])
            for x in vs.start(N, cplx=True))
    inner.precond = inner.precond._replace(u=u, v=v)

    def loss():
        return sum(torch.sum(0.5 * cs[k] * torch.real(p.conj() * p)
                             + torch.real(bs[k].conj() * p))
                   for k, p in params.items())

    for _ in range(vs.STEPS):
        opt.step(loss)
    return _summary(params, inner)


def k_against_one(mesh, rank) -> dict:
    """Each case on 4 ranks against one rank fed the 4 shards' draws
    (LRA: the unsharded optimizer; dense: a one-rank group, its damping
    at the padded n).  Own draws."""
    import torch.distributed as dist
    ones = [dist.new_group([r]) for r in range(WORLD)]
    out = {}
    for case in vs.CASES:
        dense = case == "dense"
        pk, ok = vs.build(case, N, (mesh, "fsdp"), None, cplx=True)
        vs.steps(case, N, pk, ok)
        draw = cg.WorldDraws(N, dense)
        draw.k = WORLD
        p1, o1 = vs.build(case, N, ones[rank] if dense else None, draw, cplx=True)
        vs.steps(case, N, p1, o1)
        out[case] = (vs.state(pk, ok), vs.state(p1, o1), ok.lo, ok.n_loc)
    return out


def checkpoints(mesh2, rank, directory) -> dict:
    """Each case's complex form checkpointed on (dp 2, fsdp 2)'s fsdp
    after 2 steps and resumed at 1 rank (``cg.vector_resumes``, 2 -> 1),
    and the 2-rank files of the LRAWhiten case gathered into one
    ``state.pt`` (rank 0): its state's dtypes and shapes."""
    import torch.distributed as dist
    from psgd_torch_tpu_torch.utils import gather_checkpoint
    ones = [dist.new_group([r]) for r in range(WORLD)]
    groups = {1: ones[rank], 2: (mesh2, "fsdp")}
    out = dict(resumes=cg.vector_resumes(groups, rank, directory, cplx=True,
                                         moves=((2, 1),)))
    if rank == 0:
        path = gather_checkpoint(os.path.join(directory, "vector_whiten_2_1_complex"),
                                 step=2, device="cpu")
        saved = torch.load(path, weights_only=True)["optimizer"]["psgd"]
        out["gathered"] = {f: (str(x.dtype), tuple(x.shape))
                           for f, x in saved["precond"].items()}
        out["gathered"]["mu"] = (str(saved["mu"].dtype), tuple(saved["mu"].shape))
    cg._barrier()
    return out


def misc(mesh, rank) -> dict:
    """The state placements, collective_bytes of a complex (r, r) sum and
    gather, a complex fit step's bytes, and the row-sharded norm of this
    rank's block of a complex (n_pad, r) matrix."""
    from psgd_torch_tpu_torch.parallel import (RowReduce, all_gather_stack,
                                               dense_state_specs, lra_state_specs,
                                               shard_group)
    from psgd_torch_tpu_torch.precond import lra
    from psgd_torch_tpu_torch.utils import collective_bytes, count_collectives
    out = {}
    _, whiten = vs.build("whiten", N, (mesh, "fsdp"), None, cplx=True)
    _, dense = vs.build("dense", N, (mesh, "fsdp"), None, cplx=True)
    out["lra_specs"] = {k: repr(v) for k, v in lra_state_specs(whiten, mesh, "fsdp").items()}
    out["dense_specs"] = {k: repr(v) for k, v in
                          dense_state_specs(dense, mesh, "fsdp").items()}
    out["dtypes"] = {case: {f: str(getattr(o.precond, f).dtype) for f in o.precond._fields}
                     for case, o in (("whiten", whiten), ("dense", dense))}
    sg = shard_group((mesh, "fsdp"))
    with count_collectives() as calls:
        RowReduce(sg).sum(torch.ones((vs.RANK, vs.RANK), dtype=C))
        all_gather_stack(torch.ones(GATHER, dtype=C), sg)
    out["bytes"] = collective_bytes(calls, per_op=True)
    params, opt = vs.build("whiten", N, (mesh, "fsdp"), None, cplx=True)
    with count_collectives() as calls:
        vs.steps("whiten", N, params, opt, 1)
    out["step_bytes"] = collective_bytes(calls, per_op=True)
    out["step_calls"] = len(calls)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal(NORM_ROWS)
                         + 1j * rng.standard_normal(NORM_ROWS))
    n_loc = N_PAD // WORLD
    got = lra._norm(x[rank * n_loc:(rank + 1) * n_loc], RowReduce(sg))
    out["norm"] = (got.numpy().copy(), float(torch.linalg.vector_norm(x)))
    return out


def run_cases(rank, world, draw, record, directory) -> dict:
    from psgd_torch_tpu_torch.parallel import make_mesh
    mesh = make_mesh(axis_names=("fsdp",), device_type="cpu")
    out = {}
    for case in vs.CASES:
        params, opt = vs.build(case, N, (mesh, "fsdp"), draw, seeded=True, cplx=True)
        vs.steps(case, N, params, opt)
        out[("jax", case)] = _summary(params, opt)
    out[("jax", "class")] = closure_class(mesh, draw)
    if record:
        return out
    mesh2 = make_mesh(axis_names=("dp", "fsdp"), axis_sizes=(2, 2), device_type="cpu")
    params, opt = vs.build("newton", N, (mesh, "fsdp"), None, seeded=True, cplx=True,
                           grad_clip_max_norm=float("inf"))
    vs.steps("newton", N, params, opt)
    out["newton_unclipped"] = vs.state(params, opt)["params"]
    out["k1"] = k_against_one(mesh, rank)
    out["resume"] = vs.resume(mesh2, mesh, cplx=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out["checkpoints"] = checkpoints(mesh2, rank, directory)
    out["misc"] = misc(mesh, rank)
    return out


# ---------------------------------------------------------------------------
# parent side
# ---------------------------------------------------------------------------


def _jax_references() -> dict:
    """The JAX transforms with vector_sharding over 4 devices on the
    complex problem: each case after 3 steps, the LRA and dense state
    specs, and the bytes of a complex psum and all_gather."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PS
    from psgd_torch_tpu.parallel import make_mesh
    from psgd_torch_tpu.parallel.mesh import dense_state_specs, lra_state_specs
    from psgd_torch_tpu.utils.compat import shard_map
    from psgd_torch_tpu.utils.profiling import collective_bytes
    from test_torch_legacy import FAST_COMPILE
    mesh = make_mesh(WORLD, axis_names=("fsdp",))
    refs = {}
    for case in vs.CASES:
        refs[case], st = vs.jax_case(case, N, mesh, cplx=True,
                                     compiler_options=FAST_COMPILE)
        if case != "newton":
            specs = (dense_state_specs if case == "dense" else lra_state_specs)(st, "fsdp")
            core = [s for s in specs if hasattr(s, "precond")][0]
            refs[("specs", case)] = dict(
                {f: getattr(core.precond, f) for f in core.precond._fields},
                mu=core.mu, count=core.count, key=core.key)

    def program(x, y):
        return jax.lax.psum(x, "fsdp"), jax.lax.all_gather(y, "fsdp", tiled=True)

    fn = jax.jit(shard_map(program, mesh=mesh, in_specs=(PS(), PS("fsdp")),
                           out_specs=(PS(), PS()), check_rep=False))
    args = (jnp.ones((vs.RANK, vs.RANK), jnp.complex128),
            jnp.ones((WORLD * GATHER[0], GATHER[1]), jnp.complex128))
    refs["bytes"] = collective_bytes(fn.lower(*args).compile(), per_op=True)
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return rank_results("test_torch_complex_vector_sharding", WORLD,
                            tmp_path_factory.mktemp("ranks"), _jax_references)


def _hold_against_jax(outs, ref, key, params_rtol):
    for rank, out in enumerate(outs):
        got = out[key]
        rows = slice(got["lo"], got["lo"] + got["n_loc"])
        assert got["fits"] == vs.STEPS
        for k in ref["params"]:
            assert got["params"][k].dtype == np.complex128
            vs._close(got["params"][k], ref["params"][k], f"rank {rank} param {k}",
                      params_rtol)
        for f, want in ref["precond"].items():
            assert got["precond"][f].dtype == want.dtype, (rank, f)
            want = want[rows] if want.ndim == 2 else want
            vs._close(got["precond"][f], want, f"rank {rank} {f}")
        if ref["mu"] is not None:
            want = ref["mu"] if key[1] == "dense" else ref["mu"][rows]
            vs._close(got["mu"], want, f"rank {rank} momentum")
        if "log_det" in ref:
            vs._close(got["log_det"], ref["log_det"], f"rank {rank} log_det")
        assert got["layout"]["vector_sharding"] == dict(world=WORLD, rank=rank,
                                                        n_true=N, n_pad=N_PAD)


@pytest.mark.parametrize("case", sorted(vs.CASES))
def test_complex_vector_sharded_matches_jax(ranks, case):
    """Each rank's complex parameters, its rows of U, V and d (Q) and of
    the LRA momentum, the real estimates (and dense's momentum) and LRA's
    log-det against the JAX transform with vector_sharding on the same
    complex problem, rtol 1e-9 (LRANewton's parameters at CLIP_RTOL, its
    norm clip acting); the state keeps JAX's dtypes (complex128 U, V, d, Q;
    float64 estimates)."""
    outs, refs = ranks
    _hold_against_jax(outs, refs[case], ("jax", case),
                      vs.CLIP_RTOL if case == "newton" else RTOL)
    if case == "newton":     # the clip acted
        for out in outs:
            assert not all(np.allclose(out["newton_unclipped"][k],
                                       out[("jax", case)]["params"][k], rtol=1e-3)
                           for k in out["newton_unclipped"])


def test_closure_class_under_vector_sharding(ranks):
    """classes.LRAWhiten with vector_sharding, stepped by its closure, is
    the JAX lra_whiten transform with vector_sharding fed the same
    gradient: rtol 1e-9."""
    outs, refs = ranks
    _hold_against_jax(outs, refs["whiten"], ("jax", "class"), RTOL)


def test_complex_pad_rows_stay_exact(ranks):
    """The last rank's two pad rows stay no-ops in complex: U and V rows
    0, d rows 1, Q's rows e_i and its true rows' pad columns 0, the LRA
    momentum's rows 0."""
    out = ranks[0][WORLD - 1]
    for case in vs.CASES:
        pre = out[("jax", case)]["precond"]
        if case == "dense":
            q = pre["q"]
            assert q.shape == (6, N_PAD) and q.dtype == np.complex128
            assert np.array_equal(q[4:], np.eye(N_PAD)[N:])
            assert not np.any(q[:4, N:])
        else:
            assert not np.any(pre["u"][4:]) and not np.any(pre["v"][4:])
            assert np.array_equal(pre["d"][4:], np.ones((2, 1)))
            mu = out[("jax", case)]["mu"]
            if mu is not None:
                assert not np.any(mu[4:])


@pytest.mark.parametrize("case", sorted(vs.CASES))
def test_complex_k_ranks_against_one(ranks, case):
    """Each case on 4 ranks against one rank fed the shards' draws:
    parameters and each rank's rows at rtol 1e-9 (the sums' order;
    LRANewton's parameters at CLIP_RTOL)."""
    for rank, out in enumerate(ranks[0]):
        k, one, lo, n_loc = out["k1"][case]
        for name in k["params"]:
            vs._close(k["params"][name], one["params"][name], f"rank {rank} {name}",
                      vs.CLIP_RTOL if case == "newton" else RTOL)
        for f, got in k["precond"].items():
            want = one["precond"][f]
            if got.ndim == 2:       # the one rank's whole, padded, cut
                if f == "q":
                    whole = np.eye(N_PAD, dtype=want.dtype)
                    whole[:N, :N] = want
                else:
                    fill = np.ones if f == "d" else np.zeros
                    whole = np.concatenate([want, fill((N_PAD - N,) + want.shape[1:])])
                want = whole[lo:lo + n_loc]
            vs._close(got, want, f"rank {rank} {f}")
        if k["mu"] is not None:
            want = np.concatenate([one["mu"], np.zeros(N_PAD - N)])
            vs._close(k["mu"], want if case == "dense" else want[lo:lo + n_loc],
                      f"rank {rank} momentum")


def test_complex_state_dict_round_trip_is_bitwise(ranks):
    """A per-rank complex state_dict through torch.save and torch.load
    (weights_only) continues bit for bit and keeps its complex128 U, V
    and d; a 2-rank state is refused by a 4-rank optimizer."""
    for out in ranks[0]:
        res = out["resume"]
        assert res["bitwise"] and res["count"] == vs.STEPS
        assert res["dtypes"] == dict(u="torch.complex128", v="torch.complex128",
                                     d="torch.complex128", lu="torch.float64",
                                     lv="torch.float64", ld="torch.float64")
        assert res["refused"].startswith("state_dict does not match")


@pytest.mark.parametrize("case", sorted(vs.CASES))
def test_complex_checkpoint_gathered_two_to_one(ranks, case):
    """A complex 2-rank checkpoint resumed at 1 rank against the 1-rank run
    fed each step's world's draws (``cg.hold_vector_resume``); the
    gathered LRAWhiten ``state.pt`` holds the unsharded optimizer's
    complex128 (n, r) U and V, (n, 1) d and (n,) momentum."""
    cg.hold_vector_resume([out["checkpoints"]["resumes"] for out in ranks[0]],
                          case, (2, 1))
    gathered = ranks[0][0]["checkpoints"]["gathered"]
    assert gathered["u"] == gathered["v"] == ("torch.complex128", (N, vs.RANK))
    assert gathered["d"] == ("torch.complex128", (N, 1))
    assert gathered["mu"] == ("torch.complex128", (N,))
    assert gathered["lu"] == ("torch.float64", ())


def test_complex_state_specs_match_jax(ranks):
    """lra_state_specs and dense_state_specs of complex optimizers place
    the fields as JAX's functions place the complex PSGDStates."""
    outs, refs = ranks
    for out in outs:
        m = out["misc"]
        assert m["dtypes"]["whiten"]["u"] == m["dtypes"]["dense"]["q"] == "torch.complex128"
        for case, key in (("whiten", "lra_specs"), ("dense", "dense_specs")):
            want = {f: None if s is None else vs._placements(s)
                    for f, s in refs[("specs", case)].items()}
            assert {f: (None if v == "None" else v) for f, v in m[key].items()} == want


def test_complex_collective_bytes_match_jax(ranks):
    """collective_bytes of a complex128 (r, r) sum and a complex128
    all_gather equals JAX's on the same shard_map program (16 bytes an
    entry); a complex fit step moves one all_gather of the update's rows
    (n_pad complex128), every other call at most r x r complex128."""
    outs, refs = ranks
    for out in outs:
        m = out["misc"]
        assert m["bytes"] == refs["bytes"]
        assert m["bytes"]["all-reduce"] == 16 * vs.RANK * vs.RANK
        assert m["step_bytes"]["all-gather"] == N_PAD * 16
        assert m["step_bytes"]["all-reduce"] <= m["step_calls"] * 16 * vs.RANK * vs.RANK
        assert set(m["step_bytes"]) == {"all-gather", "all-reduce"}


def test_row_sharded_norm_conjugates(ranks):
    """The row-sharded Frobenius norm of a complex (n_pad, r) matrix from
    each rank's block is real and equals ``vector_norm`` of the whole
    (JAX ``_gnorm``: real(x conj x) summed); squaring without the
    conjugate gives a complex sum and misses it."""
    for out in ranks[0]:
        got, want = out["misc"]["norm"]
        assert not np.iscomplexobj(got)
        np.testing.assert_allclose(got, want, rtol=1e-12)


if __name__ == "__main__":
    raise SystemExit("run through tests/test_torch_parallel.py")
