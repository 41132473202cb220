"""The port's vector-sharded LRAWhiten, LRANewton and DenseNewton (JAX
``vector_sharding``: one LRA or dense preconditioner over the whole
parameter vector, its rows sharded ZeRO-style, psgd_torch_tpu/precond/
lra.py and dense.py's row-sharded section) against the JAX package, on the
CPU with 4 gloo ranks as test_torch_parallel.py describes
(``rank_results``; the ranks record their draws, the parent answers with
the JAX package's).

The problem: two leaves "a" (3, 5) and "b" in float64 under the quadratic
loss sum(c p^2 / 2 + b p), whose gradient c p + b and Hessian-vector
product c v both sides compute alike, 3 steps, at n = 24 (which 4 ranks
divide) and n = 22 (padded to 24: the last rank holds two pad rows).  Each
case (``CASES``) with the JAX draws matches the JAX transform with
``vector_sharding=(make_mesh(4, ("fsdp",)), "fsdp")`` at rtol 1e-9: the
parameters, each rank's rows of U, V and d (of Q for dense) and the
replicated Lipschitz estimates.  Both sides draw U and V alike, but
normalise them by a float32 norm (JAX ``init_lra``) summed in another
order, a rounding that has nothing to do with the sharding: so the LRA
cases start both sides from the same U and V (``start``); that k ranks
start where one does is held bit for bit on its own.  LRANewton runs on
an explicit (v, H v) pair of dyadic values, so the float32 sums of its
on-the-fly init scale are exact in any order; its norm clip acts, and its
float32 norm (JAX's too) is summed in another order, which moves the
update by a float32 rounding: its parameters hold at CLIP_RTOL = 1e-6
(the test checks that the clip acted), its state at 1e-9.  Also: k ranks
against 1 where the draws allow
(dense QEQ, whose damping every rank draws alike; LRAWhiten against the
unsharded optimizer fed the per-shard probes), a per-rank ``state_dict``
round trip, ``lra_state_specs`` / ``dense_state_specs`` against JAX's
PartitionSpecs, and ``collective_bytes`` / ``collective_boundary_bytes``
against JAX's on the same collectives.
"""

import io
import warnings

import numpy as np
import pytest
import torch

from test_torch_parallel import rank_results

WORLD = 4
STEPS = 3
RTOL = 1e-9
CLIP_RTOL = 1e-6
NS = (24, 22)
RANK = 3
WIDE_CLIP = (1e3, 1e3)
# name -> (the JAX factory, options); each case at both n, with the JAX
# draws; a damping large enough that a wrongly keyed draw shows
CASES = {
    "whiten": ("lra_whiten", dict(
        lr=0.05, momentum=0.9, update_preconditioner_first=False,
        rank_of_approximation=RANK, preconditioner_init_scale=1.0,
        grad_clip_max_amps=WIDE_CLIP, damping=1e-3)),
    "newton": ("lra_newton", dict(
        lr=0.1, rank_of_approximation=RANK, grad_clip_max_norm=0.5,
        preconditioner_init_scale=None, damping=1e-3)),
    "dense": ("dense_newton", dict(
        dq="QEQ", lr=0.1, momentum=0.9, lr_preconditioner=0.5,
        preconditioner_init_scale=None, damping=1e-3)),
}
R_SQ = (RANK, RANK)          # the collective check's psum block
GATHER = (2, 5)              # its all_gather's block per rank
A2A = (4, 6)                 # its all_to_all's block (split 0, concat 1)


def tree(n):
    return {"a": (3, 5), "b": (n - 15,)}


def problem(n, cplx=False):
    """(initial values, c, b) per leaf, float64, from seed n; ``cplx``:
    the initial values and b complex128 (their imaginary parts drawn
    after the real stream), c stays real."""
    rng = np.random.default_rng(n)
    init, c, b = {}, {}, {}
    for name, shape in tree(n).items():
        init[name] = 0.5 * rng.standard_normal(shape)
        c[name] = 10.0 ** rng.uniform(-1, 1, shape)
        b[name] = rng.standard_normal(shape)
    if cplx:
        for name, shape in tree(n).items():
            init[name] = init[name] + 0.5j * rng.standard_normal(shape)
            b[name] = b[name] + 1j * rng.standard_normal(shape)
    return init, c, b


def start(n, cplx=False):
    """The LRA cases' U and V at their start: (n_pad, r) from seed 200 + n,
    zero on the pad rows; ``cplx``: complex."""
    rng = np.random.default_rng(200 + n)
    uv = 0.05 * rng.standard_normal((2, n, RANK))
    if cplx:
        uv = uv + 0.05j * rng.standard_normal((2, n, RANK))
    return np.concatenate([uv, np.zeros((2, 24 - n, RANK))], axis=1)


def pairs(n, cplx=False):
    """STEPS explicit (v, H v) pairs per leaf: v in {+-1/2, +-1} (and so
    its imaginary part with ``cplx``), H v = v times {1/2, 1, 2}, so every
    float32 sum of their powers is exact."""
    rng = np.random.default_rng(100 + n)
    out = []
    for _ in range(STEPS):
        vs, hs = {}, {}
        for name, shape in tree(n).items():
            vs[name] = rng.choice([-1.0, -0.5, 0.5, 1.0], shape)
            if cplx:
                vs[name] = vs[name] + 1j * rng.choice([-1.0, -0.5, 0.5, 1.0], shape)
            hs[name] = vs[name] * rng.choice([0.5, 1.0, 2.0], shape)
        out.append((vs, hs))
    return out


# ---------------------------------------------------------------------------
# rank side: no JAX
# ---------------------------------------------------------------------------


def build(case, n, spec, draw, seeded=False, cplx=False, **over):
    """(parameters by name, optimizer) of ``case`` at n; ``seeded``: an
    LRA optimizer's U and V rows from ``start``; ``cplx``: complex128
    parameters (``problem``)."""
    from psgd_torch_tpu_torch.optim import DenseNewton, LRANewton, LRAWhiten
    cls = {"whiten": LRAWhiten, "newton": LRANewton, "dense": DenseNewton}[case]
    init, _, _ = problem(n, cplx)
    params = {k: torch.tensor(v, requires_grad=True) for k, v in init.items()}
    kw = dict(CASES[case][1], **over)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        opt = cls(list(params.items()), vector_sharding=spec, device="cpu",
                  draw=draw, **kw)
    if seeded and case != "dense":
        u, v = (torch.from_numpy(x[opt.lo:opt.lo + opt.n_loc])
                for x in start(n, cplx))
        opt.precond = opt.precond._replace(u=u, v=v)
    return params, opt


def steps(case, n, params, opt, count=STEPS, start=0):
    """``count`` steps from step ``start``: the gradient c p + b (dense:
    of the closure's loss), the Newton cases' pairs explicit.  Complex
    parameters take torch's form of the loss, 0.5 c |p|^2 + Re(conj(b) p),
    whose ``.grad`` is c p + b (the JAX side's 0.5 c p^2 + b p, real
    part, has the same ``jax.grad``)."""
    cplx = next(iter(params.values())).is_complex()
    _, c, b = problem(n, cplx)
    cs = {k: torch.from_numpy(v) for k, v in c.items()}
    bs = {k: torch.from_numpy(v) for k, v in b.items()}

    def loss():
        if cplx:
            return sum(torch.sum(0.5 * cs[k] * torch.real(p.conj() * p)
                                 + torch.real(bs[k].conj() * p))
                       for k, p in params.items())
        return sum(torch.sum(0.5 * cs[k] * p * p + bs[k] * p)
                   for k, p in params.items())

    for i in range(start, start + count):
        if case == "dense":
            opt.step(loss)
            continue
        for k, p in params.items():
            p.grad = cs[k] * p.detach() + bs[k]
        if case == "whiten":
            opt.step()
        else:
            vs, hs = pairs(n, cplx)[i]
            opt.step(vs=[torch.from_numpy(vs[k]) for k in params],
                     hvs=[torch.from_numpy(hs[k]) for k in params])


def state(params, opt) -> dict:
    st = opt.precond
    return dict(params={k: p.detach().numpy().copy() for k, p in dict(params).items()},
                precond={f: getattr(st, f).numpy().copy() for f in st._fields},
                mu=None if opt.mu is None else opt.mu.numpy().copy(),
                layout=opt.state_dict()["psgd"]["layout"])


class ShardProbes:
    """The unsharded LRAWhiten's draw hook that feeds it what k row shards
    draw: the probe of key kv at (n, 1) is each shard's own draw under
    fold_in(kv, shard), zero on the pad rows, joined and cut to n; every
    other draw the port's own."""

    def __init__(self, n, k):
        self.n, self.k = n, k

    def __call__(self, kind, keys, shape, dtype):
        from psgd_torch_tpu_torch.ops import fastrand
        key = np.asarray(keys, np.uint32).reshape(2)
        if kind == "uniform":
            return torch.from_numpy(np.asarray(fastrand.uniform01(key[None]))
                                    ).to(dtype)
        if tuple(shape) != (self.n, 1):
            return fastrand.unit_noise(key, shape, dtype, "cpu")[None]
        n_loc = -(-self.n // self.k)
        parts = [fastrand.unit_noise(fastrand.fold_in(key, r), (n_loc, 1), dtype,
                                     "cpu") for r in range(self.k)]
        return torch.cat(parts)[:self.n][None]


def k_against_one(mesh, rank) -> dict:
    """Dense QEQ at n = 24 on 4 ranks and on a 1-rank group; LRAWhiten at
    n = 22 on 4 ranks and unsharded, fed the 4 shards' probes.  Own
    draws, no replay."""
    import torch.distributed as dist
    ones = [dist.new_group([r]) for r in range(WORLD)]
    out = {}
    for case, n, one in (("dense", 24, ones[rank]), ("whiten", 22, None)):
        pk, ok = build(case, n, (mesh, "fsdp"), None)
        steps(case, n, pk, ok)
        draw = None if one is not None else ShardProbes(n, WORLD)
        p1, o1 = build(case, n, one, draw)
        steps(case, n, p1, o1)
        out[case] = (state(pk, ok), state(p1, o1), ok.lo, ok.n_loc)
    return out


def resume(mesh2, mesh, cplx=False) -> dict:
    """LRAWhiten at n = 22 on 4 ranks: 3 steps unbroken against 2 steps, a
    per-rank state_dict through torch.save and load into a fresh
    optimizer, and 1 more; a 2-rank state offered to a 4-rank optimizer.
    ``cplx``: complex parameters and state."""
    pa, oa = build("whiten", 22, (mesh, "fsdp"), None, cplx=cplx)
    steps("whiten", 22, pa, oa)
    pb, ob = build("whiten", 22, (mesh, "fsdp"), None, cplx=cplx)
    steps("whiten", 22, pb, ob, 2)
    buf = io.BytesIO()
    torch.save(ob.state_dict(), buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    pc, oc = build("whiten", 22, (mesh, "fsdp"), None, cplx=cplx)
    with torch.no_grad():
        for k in pc:
            pc[k].copy_(pb[k])
    oc.load_state_dict(saved)
    steps("whiten", 22, pc, oc, 1, start=2)
    a, c = state(pa, oa), state(pc, oc)
    same = (all(np.array_equal(a["params"][k], c["params"][k]) for k in a["params"])
            and all(np.array_equal(a["precond"][f], c["precond"][f])
                    for f in a["precond"])
            and np.array_equal(a["mu"], c["mu"]))
    _, two = build("whiten", 22, (mesh2, "fsdp"), None, cplx=cplx)
    try:
        oc.load_state_dict(two.state_dict())
        refused = "no error"
    except ValueError as e:
        refused = str(e)
    return dict(bitwise=same, refused=refused, count=oc.count,
                dtypes={f: str(getattr(oc.precond, f).dtype)
                        for f in oc.precond._fields})


def specs_and_collectives(mesh, mesh2, rank) -> dict:
    """The state placements, collective_bytes of one sum of an (r, r)
    block, one all_gather and one all_to_all over the 4 ranks, the
    boundary split of a sum over fsdp and one over dp on the (dp 2, fsdp 2)
    mesh, a fit step's bytes, and the metrics and memory report."""
    from psgd_torch_tpu_torch.parallel import (MeshAxes, RowReduce,
                                               all_gather_stack,
                                               dense_state_specs,
                                               lra_state_specs, shard_group)
    from psgd_torch_tpu_torch.utils import (collective_boundary_bytes,
                                            collective_bytes, count_collectives,
                                            psgd_metrics, state_memory_report)
    out = {}
    _, lra = build("whiten", 22, (mesh, "fsdp"), None)
    _, dense = build("dense", 22, (mesh, "fsdp"), None)
    out["lra_specs"] = {k: repr(v) for k, v in
                        lra_state_specs(lra, mesh, "fsdp").items()}
    out["dense_specs"] = {k: repr(v) for k, v in
                          dense_state_specs(dense, mesh, "fsdp").items()}
    try:
        lra_state_specs(dense, mesh, "fsdp")
        out["specs_refused"] = "no error"
    except ValueError as e:
        out["specs_refused"] = str(e)
    sg = shard_group((mesh, "fsdp"))
    dt = torch.float64
    with count_collectives() as calls:
        RowReduce(sg).sum(torch.ones(R_SQ, dtype=dt))
        all_gather_stack(torch.ones(GATHER, dtype=dt), sg)
        MeshAxes(mesh).all_to_all(torch.ones(A2A, dtype=dt), "fsdp", 0, 1)
    out["bytes"] = collective_bytes(calls, per_op=True)
    out["bytes_total"] = collective_bytes(calls)
    axes = MeshAxes(mesh2)
    with count_collectives() as calls:
        axes.sum(torch.ones(R_SQ, dtype=dt), ("fsdp",))
        axes.sum(torch.ones(4, dtype=dt), ("dp",))
    out["boundary"] = collective_boundary_bytes(calls, [0, 0, 1, 1], per_op=True)
    out["boundary_total"] = collective_boundary_bytes(calls, [0, 0, 1, 1])
    params, opt = build("whiten", 22, (mesh, "fsdp"), None)
    with count_collectives() as calls:
        steps("whiten", 22, params, opt, 1)
    out["step_bytes"] = collective_bytes(calls, per_op=True)
    out["step_calls"] = len(calls)
    out["metrics"] = sorted(psgd_metrics(opt))
    out["memory"] = (state_memory_report(opt, per_device=True),
                     state_memory_report(opt))
    _, plain = build("whiten", 22, None, None)
    out["memory_plain"] = state_memory_report(plain)
    return out


def run_cases(rank, world, draw, record, directory) -> dict:
    from psgd_torch_tpu_torch.parallel import make_mesh
    mesh = make_mesh(axis_names=("fsdp",), device_type="cpu")
    mesh2 = make_mesh(axis_names=("dp", "fsdp"), axis_sizes=(2, 2),
                      device_type="cpu")
    out = {}
    for case in CASES:
        for n in NS:
            params, opt = build(case, n, (mesh, "fsdp"), draw, seeded=True)
            steps(case, n, params, opt)
            out[("jax", case, n)] = dict(state(params, opt), lo=opt.lo,
                                         n_loc=opt.n_loc, fits=opt.fit_steps)
            if case != "dense":
                from psgd_torch_tpu_torch.precond import lra
                out[("jax", case, n)]["log_det"] = float(
                    lra.log_det(opt.precond, opt.rows))
    if not record:
        params, opt = build("newton", 24, (mesh, "fsdp"), None, seeded=True,
                            grad_clip_max_norm=float("inf"))
        steps("newton", 24, params, opt)
        out["newton_unclipped"] = state(params, opt)["params"]
        out["starts"] = {}
        for case in ("whiten", "newton"):
            for n in NS:
                _, ok = build(case, n, (mesh, "fsdp"), None)
                _, o1 = build(case, n, None, None)
                out["starts"][(case, n)] = (state([], ok)["precond"],
                                            state([], o1)["precond"], ok.lo)
        out["k1"] = k_against_one(mesh, rank)
        out["resume"] = resume(mesh2, mesh)
        out["misc"] = specs_and_collectives(mesh, mesh2, rank)
    return out


# ---------------------------------------------------------------------------
# parent side
# ---------------------------------------------------------------------------


def jax_case(case, n, mesh, cplx=False, compiler_options=None):
    """The JAX transform of ``case`` with vector_sharding over ``mesh``'s
    fsdp after STEPS steps at n: ({params, precond, mu, log_det}, its
    optimizer state).  ``cplx``: ``problem``'s complex form, the loss
    0.5 c p^2 + b p's real part (``jax.grad`` c p + b)."""
    import jax
    import jax.numpy as jnp
    import optax
    import psgd_torch_tpu.optim as jopt
    from psgd_torch_tpu.optim.hvp import make_hvp_fn
    factory, options = CASES[case]
    init, c, b = problem(n, cplx)
    cj = {k: jnp.asarray(v) for k, v in c.items()}
    bj = {k: jnp.asarray(v) for k, v in b.items()}
    kw = dict(options)
    kw["learning_rate"] = kw.pop("lr")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        opt = getattr(jopt, factory)(vector_sharding=(mesh, "fsdp"), **kw)

    def loss(p):
        return sum(jnp.sum(jnp.real(0.5 * cj[k] * p[k] ** 2 + bj[k] * p[k]))
                   for k in p)

    def step(p, s, v=None, h=None):
        g = jax.tree_util.tree_map(lambda x, cc, bb: cc * x + bb, p, cj, bj)
        if case == "whiten":
            u, s = opt.update(g, s, p)
        elif case == "newton":
            u, s = opt.update(g, s, p, vs=v, hvs=h)
        else:
            u, s = opt.update(g, s, p, hvp_fn=make_hvp_fn(loss))
        return optax.apply_updates(p, u), s

    step = jax.jit(step, compiler_options=compiler_options)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    st = opt.init(params)
    if case != "dense":
        u, v = (jnp.asarray(x) for x in start(n, cplx))
        st = tuple(s._replace(precond=s.precond._replace(u=u, v=v))
                   if hasattr(s, "precond") else s for s in st)
    for i in range(STEPS):
        if case == "newton":
            v, h = pairs(n, cplx)[i]
            params, st = step(params, st, {k: jnp.asarray(x) for k, x in v.items()},
                              {k: jnp.asarray(x) for k, x in h.items()})
        else:
            params, st = step(params, st)
    core = [s for s in st if hasattr(s, "precond")][0]
    ref = dict(params={k: np.asarray(v) for k, v in params.items()},
               precond={f: np.asarray(getattr(core.precond, f))
                        for f in core.precond._fields},
               mu=None if core.mu is None else np.asarray(core.mu))
    if case != "dense":     # over the whole padded state, unsharded
        from psgd_torch_tpu.precond.lra import log_det
        ref["log_det"] = float(log_det(core.precond))
    return ref, st


def _jax_references() -> dict:
    """The JAX transforms with vector_sharding over 4 devices: (params,
    state) after STEPS steps per case and n; the specs; the collectives'
    bytes."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as PS
    from psgd_torch_tpu.parallel import make_mesh
    from psgd_torch_tpu.parallel.mesh import dense_state_specs, lra_state_specs
    from psgd_torch_tpu.utils.compat import shard_map
    from psgd_torch_tpu.utils.profiling import (collective_boundary_bytes,
                                                collective_bytes)
    mesh = make_mesh(WORLD, axis_names=("fsdp",))
    refs = {}
    for case in CASES:
        for n in NS:
            refs[(case, n)], st = jax_case(case, n, mesh)
            if n == NS[1]:
                specs = (lra_state_specs if case != "dense" else dense_state_specs)(
                    st, "fsdp")
                core = [s for s in specs if hasattr(s, "precond")][0]
                refs[("specs", case)] = dict(
                    {f: getattr(core.precond, f) for f in core.precond._fields},
                    mu=core.mu, count=core.count, key=core.key)

    def program(x, y, z):
        return (jax.lax.psum(x, "fsdp"),
                jax.lax.all_gather(y, "fsdp", tiled=True),
                jax.lax.all_to_all(z, "fsdp", 0, 1, tiled=True))

    fn = jax.jit(shard_map(program, mesh=mesh, in_specs=(PS(), PS("fsdp"), PS("fsdp")),
                           out_specs=(PS(), PS(), PS("fsdp")), check_rep=False))
    args = (jnp.ones(R_SQ), jnp.ones((WORLD * GATHER[0], GATHER[1])),
            jnp.ones((WORLD * A2A[0], A2A[1])))
    refs["bytes"] = collective_bytes(fn.lower(*args).compile(), per_op=True)
    mesh2 = make_mesh(WORLD, axis_names=("dp", "fsdp"), axis_sizes=(2, 2))

    def sums(x, y):
        return jax.lax.psum(x, "fsdp"), jax.lax.psum(y, "dp")

    fn2 = jax.jit(shard_map(sums, mesh=mesh2, in_specs=(PS(), PS()),
                            out_specs=(PS(), PS()), check_rep=False))
    refs["boundary"] = collective_boundary_bytes(
        fn2.lower(jnp.ones(R_SQ), jnp.ones(4)).compile(), [0, 0, 1, 1], per_op=True)
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return rank_results("test_torch_vector_sharding", WORLD,
                            tmp_path_factory.mktemp("ranks"), _jax_references)


def _close(got, want, what, rtol=RTOL):
    """got against want at rtol (atol rtol of want's largest entry), as
    float64, or complex128 where either is complex."""
    wide = (np.complex128 if np.iscomplexobj(got) or np.iscomplexobj(want)
            else np.float64)
    want = np.asarray(want, wide)
    np.testing.assert_allclose(np.asarray(got, wide), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(initial=0.0), 1e-300),
                               err_msg=what)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_vector_sharded_matches_jax(ranks, case, n):
    """Each rank's parameters, its rows of U, V and d (Q) and of the LRA
    momentum, the replicated estimates (and dense's momentum) against the
    JAX transform with vector_sharding at the same k, rtol 1e-9; LRA's
    log_det from the rows (its sums over the ranks) against JAX's over
    the whole padded state."""
    outs, refs = ranks
    ref = refs[(case, n)]
    for rank, out in enumerate(outs):
        got = out[("jax", case, n)]
        rows = slice(got["lo"], got["lo"] + got["n_loc"])
        assert got["fits"] == STEPS
        for k in ref["params"]:
            _close(got["params"][k], ref["params"][k], f"rank {rank} param {k}",
                   CLIP_RTOL if case == "newton" else RTOL)
        if case == "newton" and n == 24:     # the clip acted
            assert not all(np.allclose(out["newton_unclipped"][k], got["params"][k],
                                       rtol=1e-3) for k in got["params"])
        for f, want in ref["precond"].items():
            want = want[rows] if want.ndim == 2 else want
            _close(got["precond"][f], want, f"rank {rank} {f}")
        if ref["mu"] is not None:
            want = ref["mu"] if case == "dense" else ref["mu"][rows]
            _close(got["mu"], want, f"rank {rank} momentum")
        if "log_det" in ref:
            _close(got["log_det"], ref["log_det"], f"rank {rank} log_det")
        vs = got["layout"]["vector_sharding"]
        assert vs == dict(world=WORLD, rank=rank, n_true=n, n_pad=24)


def test_pad_rows_stay_exact(ranks):
    """At n = 22 the last rank's two pad rows stay no-ops: U and V rows 0,
    d rows 1, Q's rows e_i, the LRA momentum's rows 0."""
    out = ranks[0][WORLD - 1]
    for case in CASES:
        got = out[("jax", case, 22)]
        pre = got["precond"]
        if case == "dense":
            q = pre["q"]
            assert q.shape == (6, 24)
            assert np.array_equal(q[4:], np.eye(24)[22:])
            assert not np.any(q[:4, 22:])
        else:
            assert not np.any(pre["u"][4:]) and not np.any(pre["v"][4:])
            assert np.array_equal(pre["d"][4:], np.ones((2, 1)))
            if got["mu"] is not None:
                assert not np.any(got["mu"][4:])


def test_k_ranks_start_where_one_does(ranks):
    """Each rank's U, V and d at construction are its rows of the
    unsharded optimizer's (drawn whole, padded, cut), bit for bit."""
    for out in ranks[0]:
        for (case, n), (mine, one, lo) in out["starts"].items():
            for f in ("u", "v", "d"):
                whole = one[f]
                pad = np.ones if f == "d" else np.zeros
                whole = np.concatenate([whole, pad((24 - n,) + whole.shape[1:])])
                assert np.array_equal(mine[f], whole[lo:lo + 6]), (case, n, f)


@pytest.mark.parametrize("case", ["dense", "whiten"])
def test_k_ranks_against_one(ranks, case):
    """Dense QEQ on 4 ranks against a 1-rank vector_sharding run (every
    rank draws the same damping); LRAWhiten on 4 ranks (n = 22) against
    the unsharded optimizer fed the shards' probes: parameters and each
    rank's rows at rtol 1e-9 (the sums' order)."""
    for rank, out in enumerate(ranks[0]):
        k, one, lo, n_loc = out["k1"][case]
        for name in k["params"]:
            _close(k["params"][name], one["params"][name], f"rank {rank} {name}")
        for f, got in k["precond"].items():
            want = one["precond"][f]
            if got.ndim == 2:
                want = np.concatenate([want, np.zeros((24 - want.shape[0],)
                                                      + want.shape[1:])])[lo:lo + n_loc]
                if f == "d":
                    want[want == 0] = 1.0
            _close(got, want, f"rank {rank} {f}")


def test_state_dict_round_trip_is_bitwise(ranks):
    """A per-rank state_dict through torch.save and torch.load
    (weights_only) continues bit for bit; a 2-rank state is refused by a
    4-rank optimizer, naming the layout."""
    for out in ranks[0]:
        res = out["resume"]
        assert res["bitwise"] and res["count"] == STEPS
        assert res["refused"].startswith("state_dict does not match")
        assert "vector_sharding" in res["refused"]


def _placements(spec) -> str:
    """A JAX PartitionSpec of a 1-D fsdp mesh as the placements repr."""
    return "(Shard(dim=0),)" if tuple(spec) and spec[0] == "fsdp" else "(Replicate(),)"


def test_state_specs_match_jax(ranks):
    """lra_state_specs and dense_state_specs name the fields of the JAX
    functions' PSGDStates and place them alike: rows Shard(0), the rest
    Replicate() (dense's momentum whole); a dense optimizer is refused by
    lra_state_specs."""
    outs, refs = ranks
    for out in outs:
        m = out["misc"]
        for case, key in (("whiten", "lra_specs"), ("dense", "dense_specs")):
            want = {f: None if s is None else _placements(s)
                    for f, s in refs[("specs", case)].items()}
            assert m[key] == {f: None if v == "None" else v for f, v in m[key].items()}
            assert {f: (None if v == "None" else v) for f, v in m[key].items()} == want
        assert "LRA" in m["specs_refused"]


def test_collective_bytes_match_jax(ranks):
    """collective_bytes of one sum of an (r, r) block, one all_gather and
    one all_to_all equals JAX's on the same shard_map program over 4
    devices, per kind; collective_boundary_bytes of a sum over fsdp and
    one over dp on (dp 2, fsdp 2), with the dp halves as two hosts, JAX's
    too (the dp sum crosses)."""
    outs, refs = ranks
    for out in outs:
        m = out["misc"]
        assert m["bytes"] == refs["bytes"]
        assert m["bytes_total"] == sum(refs["bytes"].values())
        assert m["boundary"] == refs["boundary"]
        assert m["boundary_total"] == {"intra": 8 * R_SQ[0] * R_SQ[1], "cross": 32}


def test_fit_step_moves_r_sized_data_but_the_gather(ranks):
    """A fit step's collectives: one all_gather of the update's rows (n_pad
    float64), every other call an all-reduce of at most r x r float64."""
    for out in ranks[0]:
        m = out["misc"]
        assert m["step_bytes"]["all-gather"] == 24 * 8
        assert m["step_bytes"]["all-reduce"] <= m["step_calls"] * 8 * RANK * RANK
        assert set(m["step_bytes"]) == {"all-gather", "all-reduce"}


def test_metrics_and_memory_per_rank(ranks):
    """psgd_metrics names the rank in its keys; state_memory_report's
    per-device bytes are this rank's rows, a quarter of the padded whole,
    and the whole is the unsharded optimizer's plus the pad rows."""
    for rank, out in enumerate(ranks[0]):
        m = out["misc"]
        assert "step" in m["metrics"] and f"q_abs_max@rank{rank}" in m["metrics"]
        assert all(k == "step" or k.endswith(f"@rank{rank}") for k in m["metrics"])
        mine, whole = m["memory"]
        plain = m["memory_plain"]
        assert 4 * mine["q"] == whole["q"] == plain["q"] * 24 // 22
        assert 4 * mine["momentum"] == whole["momentum"]
