"""The per-shard optimizers over DTensor parameters against the JAX
package's per-shard transforms (psgd_torch_tpu/parallel/sharded.py), on
the CPU with 4 gloo ranks on a (dp 2, fsdp 2) mesh; the ranks run as
test_torch_parallel.py describes (``rank_results``).

The problem: three small leaves, one sharded over fsdp, one over dp and
fsdp on one dim (or on two), one replicated, under the quadratic loss
sum(c p^2 / 2 + b p) in float64, 3 steps.  The initial values, c and b
are multiples of 1/8 with few bits, so the step-0 gradient's mean |g|^4,
which both sides take in float32 for the on-the-fly init scale, is exact
in any summation order.  The amplitude clip is set where it cannot act
(its RMS is float32 too).  Each rank's shard of the parameters and its Q
match the JAX run at rtol 1e-9.
"""


import numpy as np
import pytest
import torch

from test_torch_parallel import rank_results

WORLD = 4
STEPS = 3
RTOL = 1e-9
WIDE_CLIP = (1e3, 1e3)

# case -> leaves {name: (shape, per-dim mesh axes)}
LEAVES = {
    "fsdp": {"a": ((8, 6), ("fsdp", None)), "b": ((6, 8), (None, "fsdp")),
             "s": ((6,), (None,))},
    "two_axes": {"a": ((8, 6), (("dp", "fsdp"), None)),
                 "b": ((4, 8), ("dp", "fsdp")), "s": ((6,), (None,))},
}
# case -> (whitening or Newton, leaves, options)
CASES = {
    # the on-the-fly init scale (one mean per leaf over its fsdp shards)
    "whiten": ("W", "fsdp", dict(lr=0.05, momentum=0.9, whiten_grad=False,
                                 preconditioner_init_scale=None, weight_decay=0.01)),
    "whiten_options": ("W", "two_axes", dict(
        lr=0.05, update_preconditioner_first=False, share_fit_apply=True,
        cache_p=True, weight_decay=0.01, weight_decay_mode="classic",
        preconditioner_update_probability=0.5)),
    "newton": ("N", "two_axes", dict(lr=0.1, momentum=0.9, cache_p=True,
                                     grad_clip_max_norm=0.05,
                                     preconditioner_update_probability=0.5)),
}
COMMON = dict(preconditioner_max_skew=2.0, lr_preconditioner=0.2)


def problem(leaves):
    """(initial values, c, b) per leaf, multiples of 1/8, from seed 1."""
    rng = np.random.default_rng(1)
    init, c, b = {}, {}, {}
    for name, (shape, _) in LEAVES[leaves].items():
        init[name] = rng.integers(-8, 9, shape) / 8.0
        c[name] = rng.choice([0.5, 1.0, 2.0], shape)
        b[name] = rng.integers(-8, 9, shape) / 8.0
    return init, c, b


def _placements(mesh, axes):
    """DTensor placements of per-dim mesh axes (the partition maps' rule)."""
    from psgd_torch_tpu_torch.parallel.mesh import _placements
    return _placements(mesh, axes)


def _local(x, mesh, axes):
    """This rank's block of a global tensor under the per-dim axes (dims
    over several mesh axes major to minor)."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    size = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    for d, ax in enumerate(axes):
        ax = (ax,) if isinstance(ax, str) else ax or ()
        k, i = 1, 0
        for a in ax:
            k, i = k * size[a], i * size[a] + coord[a]
        n = x.shape[d] // k
        x = x.narrow(d, i * n, n)
    return x.clone()


def port_run(case, mesh, draw, hvp_calls=None, grads=None):
    """The per-shard optimizer on the case: (local parameters, Q per leaf,
    the optimizer); the local gradients of each step appended to
    ``grads``."""
    from torch.distributed.tensor import DTensor
    from psgd_torch_tpu_torch.parallel import per_shard_kron_newton, per_shard_kron_whiten
    kind, leaves, options = CASES[case]
    init, c, b = problem(leaves)
    spec = LEAVES[leaves]
    params = {n: torch.nn.Parameter(DTensor.from_local(
        _local(torch.from_numpy(v), mesh, spec[n][1]), mesh,
        _placements(mesh, spec[n][1]), run_check=False)) for n, v in init.items()}
    full = {n: torch.from_numpy(v) for n, v in init.items()}
    kw = dict(COMMON, **options)
    lr = kw.pop("lr")
    if kind == "W":
        opt = per_shard_kron_whiten(list(params.items()), mesh, learning_rate=lr,
                                    grad_clip_max_amps=WIDE_CLIP, device="cpu",
                                    draw=draw, **kw)
    else:
        opt = per_shard_kron_newton(list(params.items()), mesh, learning_rate=lr,
                                    device="cpu", draw=draw, **kw)
    cs = {n: torch.from_numpy(v) for n, v in c.items()}
    bs = {n: torch.from_numpy(v) for n, v in b.items()}
    names = sorted(params)

    def hvp_fn(vs):
        if hvp_calls is not None:
            hvp_calls.append(opt.count)
        return [cs[n] * v for n, v in zip(names, vs)]

    for _ in range(STEPS):
        # the global gradient c p + b, each rank handed its shard
        for n, p in params.items():
            g = cs[n] * full[n] + bs[n]
            p.grad = DTensor.from_local(_local(g, mesh, spec[n][1]), mesh,
                                        p.placements, run_check=False)
        if grads is not None:
            grads.append({n: p.grad.to_local().clone() for n, p in params.items()})
        if kind == "W":
            opt.step()
        else:
            opt.step(hvp_fn=hvp_fn)
        for n, p in params.items():       # the whole parameter, gathered
            full[n] = _gathered(p)
    local = {n: p.to_local().detach().numpy().copy() for n, p in params.items()}
    q = {n: [f.numpy().copy() for f in opt.state[loc]["q"]]
         for n, loc in zip(names, opt.param_groups[0]["params"])}
    return local, q, opt


def _gathered(p) -> torch.Tensor:
    """A DTensor's global value from every rank's shard (all_gather of the
    shards, then the blocks put in place)."""
    import torch.distributed as dist
    mesh = p.device_mesh
    local = p.to_local().detach().contiguous()
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, local)
    out = torch.empty(p.shape, dtype=local.dtype)
    for r, part in enumerate(parts):
        coord = [int(i) for i in (mesh.mesh == r).nonzero()[0]]
        index = [slice(None)] * p.ndim
        for d in range(p.ndim):
            k, i = 1, 0
            for md, pl in enumerate(p.placements):
                if pl.is_shard(d):
                    k, i = k * mesh.mesh.shape[md], i * mesh.mesh.shape[md] + coord[md]
            n = p.shape[d] // k
            index[d] = slice(i * n, (i + 1) * n)
        out[tuple(index)] = part
    return out


def _error(fn) -> str:
    try:
        fn()
    except (ValueError, TypeError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def run_cases(rank, world, draw, record, directory) -> dict:
    from psgd_torch_tpu_torch.parallel import (PerShardKronWhiten, make_mesh,
                                               per_shard_kron_whiten)
    mesh = make_mesh(axis_names=("dp", "fsdp"), axis_sizes=(2, 2), device_type="cpu")
    out = {}
    for case in CASES:
        calls, grads = [], []
        local, q, opt = port_run(case, mesh, draw, calls, grads)
        out[case] = dict(local=local, q=q, hvp_calls=calls, fit_steps=opt.fit_steps,
                         coord=list(mesh.get_coordinate()))
        if record or case != "whiten_options":
            continue
        # the same shards in one process, from their indices (no mesh)
        kind, leaves, options = CASES[case]
        init, c, b = problem(leaves)
        spec = LEAVES[leaves]
        shards = []
        for n, v in init.items():
            index, coord = {}, dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
            for d, ax in enumerate(spec[n][1]):
                ax = (ax,) if isinstance(ax, str) else ax or ()
                if ax:
                    i = 0
                    for a in ax:
                        i = i * 2 + coord[a]
                    index[d] = i
            shards.append((n, _local(torch.from_numpy(v), mesh, spec[n][1]), index))
        kw = dict(COMMON, **options)
        one = PerShardKronWhiten.on_shards(shards, grad_clip_max_amps=WIDE_CLIP,
                                           device="cpu", draw=draw, **kw)
        tensors = {n: t for n, t, _ in shards}
        for step_grads in grads:        # the gradients the rank was handed
            for n, t in tensors.items():
                t.grad = step_grads[n]
            one.step()
        out["one_process"] = {n: t.detach().numpy().copy() for n, t in tensors.items()}
        # the state through state_dict, and another rank's refused
        sd = opt.state_dict()
        again = port_run(case, mesh, draw)[2]
        again.load_state_dict(sd)
        out["state_dict_same"] = all(
            torch.equal(a, b) for p, p2 in zip(opt.param_groups[0]["params"],
                                                again.param_groups[0]["params"])
            for a, b in zip(opt.state[p]["q"], again.state[p2]["q"]))
        others = [None] * world
        import torch.distributed as dist
        dist.all_gather_object(others, sd["psgd"]["layout"])
        theirs = dict(sd, psgd=dict(sd["psgd"], layout=others[(rank + 1) % world]))
        out["refused"] = _error(lambda: again.load_state_dict(theirs))
    if not record:
        out["plain"] = _error(lambda: per_shard_kron_whiten(
            [("w", torch.zeros(4, 4))], mesh, device="cpu"))
        out["scanned"] = _error(lambda: per_shard_kron_whiten(
            [], mesh, device="cpu", scanned_layers={}))
    return out


def _jax_references() -> dict:
    """The JAX per-shard transforms on the (dp 2, fsdp 2) mesh of the
    conftest's devices: global parameters and the sharded Q states."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as PS
    from psgd_torch_tpu.parallel import make_mesh, named_shardings
    from psgd_torch_tpu.parallel.sharded import (per_shard_kron_newton,
                                                 per_shard_kron_whiten)
    mesh = make_mesh(4, axis_names=("dp", "fsdp"), axis_sizes=(2, 2))
    refs = {}
    for case, (kind, leaves, options) in CASES.items():
        init, c, b = problem(leaves)
        specs = {n: PS(*ax) for n, (_, ax) in LEAVES[leaves].items()}
        kw = dict(COMMON, **options)
        kw["learning_rate"] = kw.pop("lr")
        cj = {n: jnp.asarray(v) for n, v in c.items()}
        bj = {n: jnp.asarray(v) for n, v in b.items()}
        params = jax.device_put({n: jnp.asarray(v) for n, v in init.items()},
                                named_shardings(mesh, specs))
        if kind == "W":
            opt = per_shard_kron_whiten(mesh, specs, grad_clip_max_amps=WIDE_CLIP, **kw)
        else:
            opt = per_shard_kron_newton(mesh, specs, **kw)
        state = opt.init(params)

        def step(p, s):
            g = jax.tree_util.tree_map(lambda x, cc, bb: cc * x + bb, p, cj, bj)
            if kind == "W":
                u, s = opt.update(g, s, p)
            else:
                u, s = opt.update(g, s, p, hvp_fn=lambda pp, vs: (
                    g, jax.tree_util.tree_map(lambda cc, v: cc * v, cj, vs)))
            return optax.apply_updates(p, u), s

        step = jax.jit(step)
        with mesh:
            for _ in range(STEPS):
                params, state = step(params, state)
        core = [s for s in state if hasattr(s, "precond")][0]
        names = sorted(init)
        refs[case] = dict(params={n: np.asarray(params[n]) for n in names},
                          q={n: [np.asarray(f) for f in st.q]
                             for n, st in zip(names, core.precond)})
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return rank_results("test_torch_per_shard", WORLD,
                            tmp_path_factory.mktemp("per_shard"), _jax_references)


def _indices(coord, axes):
    """The shard index along each sharded dim, in dim order."""
    pos = dict(zip(("dp", "fsdp"), coord))
    out = []
    for ax in axes:
        ax = (ax,) if isinstance(ax, str) else ax or ()
        if ax:
            i = 0
            for a in ax:
                i = i * 2 + pos[a]
            out.append(i)
    return tuple(out)


def _block(x, coord, axes):
    pos = dict(zip(("dp", "fsdp"), coord))
    for d, ax in enumerate(axes):
        ax = (ax,) if isinstance(ax, str) else ax or ()
        k, i = 1, 0
        for a in ax:
            k, i = k * 2, i * 2 + pos[a]
        n = x.shape[d] // k
        x = np.take(x, range(i * n, (i + 1) * n), axis=d)
    return x


@pytest.mark.parametrize("case", sorted(CASES))
def test_per_shard_matches_jax(ranks, case):
    """Each rank's shard of every parameter and its Q against the JAX
    per-shard transform at rtol 1e-9: keys folded with the shard's linear
    index along each sharded dim (a dim over dp and fsdp included), the
    on-the-fly init scale's mean over the shards, the gate, Newton's clip
    over the global tree."""
    outs, refs = ranks
    kind, leaves, _ = CASES[case]
    ref = refs[case]
    for out in outs:
        got = out[case]
        for n, (_, axes) in LEAVES[leaves].items():
            want = _block(ref["params"][n], got["coord"], axes)
            np.testing.assert_allclose(got["local"][n], want, rtol=RTOL,
                                       atol=RTOL * np.abs(want).max(), err_msg=n)
            idx = _indices(got["coord"], axes)
            for f, g in zip(got["q"][n], ref["q"][n]):
                g = g[idx] if idx else g
                np.testing.assert_allclose(f, g, rtol=RTOL, atol=RTOL * np.abs(g).max(),
                                           err_msg=n)


def test_newton_hvp_is_lazy(ranks):
    """hvp_fn runs on fit steps only (JAX tests/test_per_shard_features.py
    :225): at p = 0.5 it is called exactly fit_steps times."""
    for out in ranks[0]:
        got = out["newton"]
        assert len(got["hvp_calls"]) == got["fit_steps"]
        assert 0 < got["fit_steps"] < STEPS + 1


def test_one_process_run_equals_the_rank(ranks):
    """``on_shards``: a rank's shards stepped in one process from their
    indices equal the DTensor run's, bit for bit."""
    for out in ranks[0]:
        for n, x in out["one_process"].items():
            assert np.array_equal(x, out["whiten_options"]["local"][n]), n


def test_state_dict_per_rank(ranks):
    """state_dict round-trips a rank's state; another rank's layout (its
    mesh coordinate and shard indices) is refused."""
    for out in ranks[0]:
        assert out["state_dict_same"]
        assert out["refused"].startswith("ValueError: state_dict does not match")


def test_plain_tensors_and_stack_options_refused(ranks):
    out = ranks[0][0]
    assert out["plain"].startswith("TypeError") and "DTensor" in out["plain"]
    assert out["scanned"].startswith("TypeError") and "scanned_layers" in out["scanned"]


if __name__ == "__main__":
    raise SystemExit("run through tests/test_torch_parallel.py")
