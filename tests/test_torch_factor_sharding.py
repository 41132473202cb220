"""The port's factor-sharded KronWhiten and KronNewton (JAX
``factor_sharding``: one global Kron preconditioner over leaves whose dims
are sharded, psgd_torch_tpu/precond/kron.py:916-1274) against the JAX
package, on the CPU with 4 gloo ranks as test_torch_parallel.py describes
(``rank_results``; the ranks record their draws, the parent answers with
the JAX package's).

The tree, float64, under the quadratic loss sum(c p^2 / 2 + b p): an
embedding (64, 16) under (tp, fsdp), whose dense dim's axes move onto its
diagonal vocab dim; a (24, 16) leaf with both dims dense under (None,
fsdp), whose dense dim is gathered; an embedding (48, 8) with only its
vocab dim sharded, which needs no move; a scanned stack (4, 16, 24) with
``stack_sharding`` (its placements in the map, a plain tensor to the
optimizer).  Meshes over the 4 ranks: (dp 2, fsdp 2) with the fsdp axis
sharding (k = 2), fsdp 4 (k = 4) and fsdp 2 x tp 2.

Each case with the JAX draws matches the JAX transform with
``factor_sharding`` at the same k at rtol 1e-9: each rank's block of every
parameter, the dense Q factors, and each diagonal factor's block in the
compute layout.  The cases set the init scale and an amplitude clip that
cannot act (both sides take the clip's RMS and the init scale's mean in
float32, summed in another order); "onthefly" holds both, k ranks
against 1 at rtol 1e-6.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_parallel import rank_results

WORLD = 4
STEPS = 3
RTOL = 1e-9
WIDE_CLIP = (1e3, 1e3)

# name -> (global shape, per-dim mesh axes); "blocks." leaves are scanned
TREE = {"blocks.w": ((4, 16, 24), (None, "fsdp", "tp")),
        "dense": ((24, 16), (None, "fsdp")),
        "emb": ((64, 16), ("tp", "fsdp")),
        "vocab": ((48, 8), ("fsdp", None))}
NAMES = sorted(TREE, key=lambda n: tuple(n.split(".")))
ROUTED = ("dense", "emb", "vocab")
# mesh -> (the port's axis names and sizes over the 4 ranks, the JAX
# mesh's device count, names and sizes on conftest's 8 devices)
MESHES = {"k2": ((("dp", "fsdp"), (2, 2)), (2, ("fsdp",), None)),
          "k4": ((("fsdp",), (4,)), (4, ("fsdp",), None)),
          "2d": ((("fsdp", "tp"), (2, 2)), (4, ("fsdp", "tp"), (2, 2)))}
# a damping large enough that each block's noise draw (its key folded with
# the block's index) shows far above the tolerance
COMMON = dict(preconditioner_max_skew=2.0, preconditioner_init_scale=1.0,
              lr_preconditioner=0.2, damping=1e-3)
# name -> (whitening or Newton, dq, mesh, options); each a JAX compile
CASES = {
    "whiten_share_cache": ("W", "Q0.5EQ1.5", "k4", dict(
        lr=0.05, momentum=0.9, whiten_grad=False, cache_p=True,
        share_fit_apply=True, update_preconditioner_first=False,
        preconditioner_update_probability=0.5, grad_clip_max_amps=WIDE_CLIP)),
    "whiten_pipelined": ("W", "QUAD", "2d", dict(
        lr=0.05, momentum=0.9, whiten_grad=False, pipelined_fit=True,
        weight_decay=0.01, grad_clip_max_amps=WIDE_CLIP)),
    "newton_cache_clip": ("N", "QEQ", "k2", dict(
        lr=0.1, momentum=0.9, cache_p=True, grad_clip_max_norm=0.05)),
    "newton": ("N", "Q0.5EQ1.5", "2d", dict(lr=0.1, momentum=0.9)),
}
# k ranks against 1 only (no damping, so both draw alike): the on-the-fly
# init scale and the clip
ONTHEFLY = ("W", "Q0.5EQ1.5", "2d", dict(lr=0.05, momentum=0.9,
                                         whiten_grad=False, damping=0.0,
                                         preconditioner_init_scale=None))


def problem():
    """(initial values, c, b) per leaf, float64, from seed 0."""
    rng = np.random.default_rng(0)
    init, c, b = {}, {}, {}
    for name, (shape, _) in TREE.items():
        init[name] = 0.5 * rng.standard_normal(shape)
        c[name] = 10.0 ** rng.uniform(-1, 1, shape)
        b[name] = rng.standard_normal(shape)
    return init, c, b


# ---------------------------------------------------------------------------
# rank side: no JAX
# ---------------------------------------------------------------------------


def _mesh(key):
    from psgd_torch_tpu_torch.parallel import make_mesh
    names, sizes = MESHES[key][0]
    return make_mesh(axis_names=names, axis_sizes=sizes, device_type="cpu")


def _placements(mesh):
    from psgd_torch_tpu_torch.parallel.mesh import _placements
    return {n: _placements(mesh, axes) for n, (_, axes) in TREE.items()}


def _dist(x, mesh, placements):
    """This rank's block of a global tensor as a DTensor (no collective)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


def _full(x):
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def build(spec, mesh, draw, sharded=True, routed=ROUTED, placements=None,
          **over):
    """(parameters by name, optimizer) of a case spec on ``mesh``: the
    ``routed`` leaves DTensors with ``placements`` (default: the map's)."""
    from psgd_torch_tpu_torch.optim import KronNewton, KronWhiten
    kind, dq, _, options = spec
    init, _, _ = problem()
    pl = _placements(mesh)
    given = dict(pl, **(placements or {}))
    params = {n: torch.nn.Parameter(
        _dist(torch.tensor(v), mesh, given[n]) if sharded and n in routed
        else torch.tensor(v)) for n, v in init.items()}
    kw = dict(COMMON, dq=dq, **dict(options, **over))
    if sharded:
        kw.update(stack_sharding=(mesh, "fsdp"), factor_sharding=(mesh, pl))
    opt = (KronWhiten if kind == "W" else KronNewton)(
        list(params.items()), device="cpu", draw=draw,
        scanned_layers={n: n.startswith("blocks.") for n in TREE}, **kw)
    return params, opt


def steps(spec, mesh, params, opt, n=STEPS, sharded=True):
    """n steps of the quadratic problem; the global parameters after."""
    _, c, b = problem()
    cs = {k: torch.from_numpy(v) for k, v in c.items()}
    bs = {k: torch.from_numpy(v) for k, v in b.items()}
    for _ in range(n):
        full = {k: _full(p.detach()) for k, p in params.items()}
        for k, p in params.items():
            g = cs[k] * full[k] + bs[k]
            p.grad = _dist(g, mesh, p.placements) if hasattr(p, "placements") else g
        if spec[0] == "W":
            opt.step()
        elif sharded:
            opt.step(hvp_fn=lambda vs: [cs[k] * v for k, v in zip(NAMES, vs)])
        else:
            opt.step(lambda: sum(torch.sum(0.5 * cs[k] * p * p + bs[k] * p)
                                 for k, p in params.items()))
    return {k: _full(p.detach()).numpy().copy() for k, p in params.items()}


def where(opt) -> dict:
    """Per leaf: this rank's block of each diagonal factor in the compute
    layout ((start, stop) or None), the reshard plan, the stack's
    layers."""
    out = {}
    locals_ = opt.param_groups[0]["params"]
    for i, name in enumerate(NAMES):
        r = opt.routed[i]
        if r is not None:
            eff = r.rplan[0]
            blocks = []
            for j, f in enumerate(opt.state[locals_[i]]["q"]):
                if f.ndim == 1 and eff[j]:
                    k = opt.comm.index(eff[j])
                    blocks.append((k * f.shape[0], (k + 1) * f.shape[0]))
                else:
                    blocks.append(None)
            out[name] = dict(blocks=blocks, eff=eff, moves=r.rplan[1],
                             gathers=r.rplan[2])
        elif opt.sharded[i]:
            out[name] = dict(layers=(opt.layers[i].start, opt.layers[i].stop))
    return out


def state(opt) -> dict:
    return {n: dict(q=[f.numpy().copy() for f in opt.state[p]["q"]],
                    mu=opt.state[p]["mu"].numpy().copy())
            for n, p in zip(NAMES, opt.param_groups[0]["params"])}


def replicated(opt, params) -> dict:
    """What must be equal on every rank: the non-routed parameters, the
    routed leaves' dense factors and L, the unsharded leaves' Q and L."""
    out = {}
    for i, (n, p) in enumerate(zip(NAMES, opt.param_groups[0]["params"])):
        st = opt.state[p]
        if opt.routed[i] is None:
            out[f"param {n}"] = p
        if opt.sharded[i]:
            continue
        for j, f in enumerate(st["q"]):
            if opt.routed[i] is None or f.ndim == 2:
                out[f"Q {n}[{j}]"] = f
        for j, f in enumerate(st["lips"]):
            out[f"L {n}[{j}]"] = f
    return out


def _error(fn) -> str:
    try:
        fn()
    except (ValueError, TypeError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def errors(mesh) -> dict:
    """The routing's refusals, each naming the leaf."""
    from torch.distributed.tensor import Replicate, Shard
    from psgd_torch_tpu_torch.optim import KronWhiten
    spec = ("W", "Q0.5EQ1.5", "2d", {})
    pl = _placements(mesh)
    out = {"plain": _error(lambda: build(spec, mesh, None,
                                         routed=("dense", "vocab"))),
           "placements": _error(lambda: build(
               spec, mesh, None, placements=dict(emb=(Shard(1), Replicate())))),
           "unknown": _error(lambda: KronWhiten(
               [("a", torch.zeros(4))], device="cpu",
               factor_sharding=(mesh, dict(pl))))}
    odd = torch.nn.Parameter(_dist(torch.zeros(63, 16), mesh, pl["emb"]))
    out["indivisible"] = _error(lambda: KronWhiten(
        [("emb", odd)], device="cpu", factor_sharding=(mesh, {"emb": pl["emb"]})))
    stack = torch.nn.Parameter(_dist(torch.zeros(4, 16, 24), mesh,
                                     pl["blocks.w"]))
    out["scanned_dtensor"] = _error(lambda: KronWhiten(
        [("blocks.w", stack)], device="cpu", scanned_layers={"blocks.w": True},
        factor_sharding=(mesh, {"blocks.w": pl["blocks.w"]})))
    return out


def resume(mesh, rank, directory) -> dict:
    """A per-rank checkpoint after 2 steps, restored into a fresh optimizer
    and continued 1 step, against the unbroken run; another rank's layout
    refused; the memory report and the metrics' keys."""
    import torch.distributed as dist
    from psgd_torch_tpu_torch.utils import (psgd_metrics, restore_checkpoint,
                                            save_checkpoint, state_memory_report)
    spec = CASES["whiten_share_cache"]
    params, opt = build(spec, mesh, None)
    holder = torch.nn.Module()
    holder.w = params["blocks.w"]
    steps(spec, mesh, params, opt, n=2)
    ckpt = os.path.join(directory, "ckpt")
    save_checkpoint(ckpt, 2, holder, opt)
    dist.barrier()
    params2, opt2 = build(spec, mesh, None)
    holder2 = torch.nn.Module()
    holder2.w = params2["blocks.w"]
    restore_checkpoint(ckpt, holder2, opt2)
    with torch.no_grad():       # the parameters are the model's part
        for n, p in params.items():
            target = params2[n].to_local() if n in ROUTED else params2[n]
            target.copy_(p.to_local() if n in ROUTED else p)
    a = steps(spec, mesh, params, opt, n=1)
    b = steps(spec, mesh, params2, opt2, n=1)
    same = all(np.array_equal(a[n], b[n]) for n in NAMES) and all(
        torch.equal(x, y) for p, p2 in zip(opt.param_groups[0]["params"],
                                           opt2.param_groups[0]["params"])
        for k in ("q", "lips", "pcache") for x, y in
        zip(opt.state[p][k], opt2.state[p2][k]))
    sd = opt.state_dict()
    layouts = [None] * dist.get_world_size()
    dist.all_gather_object(layouts, sd["psgd"]["layout"])
    theirs = dict(sd, psgd=dict(sd["psgd"], layout=layouts[(rank + 1) % WORLD]))
    plain = build(spec, mesh, None, sharded=False)[1]
    return dict(bitwise=same, refused=_error(lambda: opt2.load_state_dict(theirs)),
                files=sorted(os.listdir(os.path.join(ckpt, "step_2"))),
                memory=(state_memory_report(opt, per_device=True),
                        state_memory_report(opt), state_memory_report(plain)),
                metrics=sorted(psgd_metrics(opt)))


def recipe_train(rank) -> dict:
    """A tiny GPT-2 laid out by ``sharding_recipe`` on make_mesh()'s (dp 1,
    fsdp 2, tp 2): each rank takes the forward and backward on the same
    batch, hands the optimizer its blocks of the routed leaves'
    gradients and gathers them back into the model; 3 steps."""
    from psgd_torch_tpu_torch.models import gpt2
    from psgd_torch_tpu_torch.optim import KronWhiten
    from psgd_torch_tpu_torch.parallel import (gpt2_partition_specs, make_mesh,
                                               sharding_recipe)
    mesh = make_mesh(device_type="cpu")
    cfg = gpt2.tiny_config(n_layer=4, n_head=2, n_embd=16, block_size=8,
                           vocab_size=64, compute_dtype=torch.float32)
    model = gpt2.GPT2(cfg, device="cpu", seed=1)
    rec = sharding_recipe(mesh, gpt2_partition_specs(mesh),
                          model.named_parameters(),
                          scanned_layers=gpt2.scanned_layers_mask(model))
    placed = rec.place(model.named_parameters())
    opt = KronWhiten(placed, lr=1e-3, preconditioner_init_scale=1.0,
                     device="cpu", **rec.transform_kwargs)
    x, y = gpt2.synthetic_lm_batch(torch.Generator().manual_seed(2), 8,
                                   cfg.block_size, cfg.vocab_size, device="cpu")
    named = dict(model.named_parameters())
    losses = []
    for _ in range(3):
        model.zero_grad(set_to_none=True)
        loss = gpt2.loss_gpt2(model, x, y)
        loss.backward()
        losses.append(loss.item())
        for n, p in placed:
            p.grad = (_dist(named[n].grad, mesh, p.placements)
                      if hasattr(p, "placements") else named[n].grad)
        opt.step()
        with torch.no_grad():
            for n, p in placed:
                if hasattr(p, "placements"):
                    named[n].copy_(p.full_tensor())
    return dict(losses=losses, routed=rec.routed(), stack=rec.stack_axis,
                wte=repr(tuple(p.placements for n, p in placed if n == "wte")[0]),
                specs=rec.state_specs(opt)["wte"])


def run_cases(rank, world, draw, record, directory) -> dict:
    """This module's cases on this rank.  ``record``: only the JAX-replay
    runs, with the recording hook."""
    from psgd_torch_tpu_torch.parallel import drift_check
    meshes = {k: _mesh(k) for k in MESHES}
    out = {}
    for case, spec in CASES.items():
        mesh = meshes[spec[2]]
        params, opt = build(spec, mesh, draw)
        out[("jax", case)] = dict(params=steps(spec, mesh, params, opt),
                                  state=state(opt), where=where(opt))
        if record:
            continue
        # the port's own draws: k ranks against 1, with and without damping
        for damping in (0.0, None):
            over = {} if damping is None else dict(damping=damping)
            params, opt = build(spec, mesh, None, **over)
            got = steps(spec, mesh, params, opt)
            if damping is None:
                out[("drift", case)] = drift_check(replicated(opt, params))
            p1, o1 = build(spec, mesh, None, sharded=False, **over)
            out[("one", case, damping)] = (got, steps(spec, mesh, p1, o1,
                                                      sharded=False))
    if not record:
        mesh = meshes[ONTHEFLY[2]]
        params, opt = build(ONTHEFLY, mesh, None)
        p1, o1 = build(ONTHEFLY, mesh, None, sharded=False)
        out["onthefly"] = (steps(ONTHEFLY, mesh, params, opt),
                           steps(ONTHEFLY, mesh, p1, o1, sharded=False))
        out["errors"] = errors(meshes["2d"])
        out["resume"] = resume(meshes["2d"], rank, directory)
        out["recipe"] = recipe_train(rank)
    return out


# ---------------------------------------------------------------------------
# parent side
# ---------------------------------------------------------------------------


def _nest(flat):
    out = {"blocks": {}}
    for n, v in flat.items():
        if n.startswith("blocks."):
            out["blocks"][n.split(".", 1)[1]] = v
        else:
            out[n] = v
    return out


def _jax_references() -> dict:
    """The JAX transforms with factor_sharding (and stack_sharding over
    fsdp) on each case's mesh: global parameters and Q after STEPS."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as PS
    import psgd_torch_tpu.optim as jopt
    from psgd_torch_tpu.optim.hvp import make_hvp_fn
    from psgd_torch_tpu.parallel import make_mesh
    init, c, b = problem()
    cj = _nest({n: jnp.asarray(v) for n, v in c.items()})
    bj = _nest({n: jnp.asarray(v) for n, v in b.items()})
    mask = _nest({n: n.startswith("blocks.") for n in TREE})

    def loss(p):
        return sum(jnp.sum(0.5 * cc * x * x + bb * x) for x, cc, bb in zip(
            jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(cj),
            jax.tree_util.tree_leaves(bj)))

    refs = {}
    for case, (kind, dq, mkey, options) in CASES.items():
        n_dev, names, sizes = MESHES[mkey][1]
        mesh = make_mesh(n_dev, axis_names=names, axis_sizes=sizes)
        specs = _nest({n: PS(*(a if a in names else None for a in axes))
                       for n, (_, axes) in TREE.items()})
        kw = dict(COMMON, dq=dq, **options)
        kw["learning_rate"] = kw.pop("lr")
        factory = jopt.kron_whiten if kind == "W" else jopt.kron_newton
        opt = factory(scanned_layers=mask, stack_sharding=(mesh, "fsdp"),
                      factor_sharding=(mesh, specs), **kw)
        params = _nest({n: jnp.asarray(v) for n, v in init.items()})
        state = opt.init(params)
        hvp_fn = make_hvp_fn(loss)

        def step(p, s):
            g = jax.tree_util.tree_map(lambda x, cc, bb: cc * x + bb, p, cj, bj)
            if kind == "W":
                u, s = opt.update(g, s, p)
            else:
                u, s = opt.update(g, s, p, hvp_fn=hvp_fn)
            return optax.apply_updates(p, u), s

        step = jax.jit(step)
        for _ in range(STEPS):
            params, state = step(params, state)
        core = [s for s in state if hasattr(s, "precond")][0]
        flat = jax.tree_util.tree_flatten_with_path(params)[0]
        keys = [".".join(p.key for p in path) for path, _ in flat]
        refs[case] = dict(
            params={n: np.asarray(v) for n, (_, v) in zip(keys, flat)},
            q={n: [np.asarray(f) for f in st.q] for n, st in zip(keys, core.precond)})
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return rank_results("test_torch_factor_sharding", WORLD,
                            tmp_path_factory.mktemp("factor"), _jax_references)


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max(), err_msg=what)


# (shape, diagonal dims, per-dim mesh axes, axis sizes)
PLANS = {
    "one_axis_moves": ((64, 16), (True, False), ((), ("fsdp",)), {"fsdp": 2}),
    "two_axes_on_a_dense_dim": ((64, 16), (True, False), ((), ("fsdp", "tp")),
                                {"fsdp": 2, "tp": 2}),
    "no_diagonal_dim_gathers": ((24, 16), (False, False), ((), ("fsdp",)),
                                {"fsdp": 2}),
    "no_divisible_target_gathers": ((5, 16), (True, False), ((), ("fsdp",)),
                                    {"fsdp": 2}),
    "partial_placement_undone": ((6, 16), (True, False), ((), ("a", "b")),
                                 {"a": 2, "b": 2}),
    "axes_already_on_the_diagonal_dim": ((64, 16), (True, False),
                                         (("tp",), ("fsdp",)), {"tp": 2, "fsdp": 2}),
    "only_the_diagonal_dim_sharded": ((48, 8), (True, False), (("fsdp",), ()),
                                      {"fsdp": 4}),
    "largest_target_of_two": ((8, 6, 12), (True, False, True), ((), ("a",), ("b",)),
                              {"a": 2, "b": 3}),
    "two_dense_dims_onto_one": ((16, 8, 32), (False, False, True),
                                (("a",), ("b",), ()), {"a": 2, "b": 2}),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_reshard_plan_equals_jax(case):
    """kron.dim_shard_reshard_plan (host code) against JAX's
    (kron.py:943-995): the compute axes, the ordered moves (minor axis
    first) and the gathered dims."""
    from types import SimpleNamespace
    from psgd_torch_tpu.precond.kron import dim_shard_reshard_plan as jax_plan
    from psgd_torch_tpu_torch.precond.kron import KronPlan, dim_shard_reshard_plan
    shape, diag, axes, sizes = PLANS[case]
    got = dim_shard_reshard_plan(KronPlan(shape, diag, "QEQ", int(np.prod(shape))),
                                 axes, sizes)
    want = jax_plan(SimpleNamespace(shape=shape, is_diag=diag), axes, sizes)
    assert got == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_factor_sharded_matches_jax(ranks, case):
    """Each rank's blocks against the JAX transform with factor_sharding
    at the same k, rtol 1e-9: every parameter (a routed leaf's block),
    every dense Q factor whole, each diagonal factor's block in the
    compute layout, the stacked leaf's layers."""
    outs, refs = ranks
    ref = refs[case]
    for rank, out in enumerate(outs):
        got = out[("jax", case)]
        for n in NAMES:
            w = got["where"].get(n, {})
            _close(got["params"][n], ref["params"][n], f"rank {rank} {n}")
            for j, (f, g) in enumerate(zip(got["state"][n]["q"], ref["q"][n])):
                if "layers" in w:
                    g = g[slice(*w["layers"])]
                elif "blocks" in w and w["blocks"][j] is not None:
                    g = g[slice(*w["blocks"][j])]
                _close(f, g, f"rank {rank} {n} Q[{j}]")


def test_layouts_move_gather_and_keep(ranks):
    """The reshard plans the tree takes: emb's dense dim moves onto its
    vocab dim (on the 2-D mesh two axes meet there, tp major), dense's
    is gathered, vocab's stays; each rank's momentum is its block."""
    outs, _ = ranks
    w = outs[0][("jax", "whiten_pipelined")]["where"]           # the 2-D mesh
    assert w["emb"]["eff"] == (("tp", "fsdp"), ()) and w["emb"]["moves"] == [
        (1, "fsdp", 0)]
    assert w["dense"]["gathers"] == (1,) and w["dense"]["moves"] == []
    assert w["vocab"]["eff"] == (("fsdp",), ()) and w["vocab"]["moves"] == []
    k4 = outs[0][("jax", "whiten_share_cache")]
    assert k4["state"]["emb"]["mu"].shape == (64, 4)
    assert k4["state"]["emb"]["q"][0].shape == (16,)


@pytest.mark.parametrize("case", sorted(CASES))
def test_k_ranks_equal_one_rank(ranks, case):
    """The port's own draws: with damping 0 the k-rank run equals its
    1-rank unsharded run at rtol 1e-9 (only the sums' order differs);
    with damping (per-block noise draws) every leaf's update has cosine
    > 0.99 with the 1-rank one (JAX tests/test_parallel.py
    :421-445)."""
    init, _, _ = problem()
    for out in ranks[0]:
        got, one = out[("one", case, 0.0)]
        for n in NAMES:
            _close(got[n], one[n], n)
        got, one = out[("one", case, None)]
        for n in NAMES:
            a, b = (got[n] - init[n]).ravel(), (one[n] - init[n]).ravel()
            assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.99, n


def test_onthefly_scale_and_clip_k_against_one(ranks):
    """The on-the-fly init scale and the amplitude clip over the global
    leaves: k ranks against 1 at rtol 1e-6 (both take float32 sums, in
    another order)."""
    for out in ranks[0]:
        got, one = out["onthefly"]
        for n in NAMES:
            np.testing.assert_allclose(got[n], one[n], rtol=1e-6,
                                       atol=1e-6 * np.abs(one[n]).max(), err_msg=n)


@pytest.mark.parametrize("case", sorted(CASES))
def test_replicated_state_has_no_drift(ranks, case):
    """drift_check is exactly 0 on every replicated tensor: the dense Q
    factors and L of the routed leaves, the other leaves and their
    state."""
    for out in ranks[0]:
        drift = out[("drift", case)]
        assert len(drift) >= 10 and set(drift.values()) == {0.0}, drift


def test_state_dict_checkpoint_metrics_memory(ranks):
    """A per-rank checkpoint (one file per rank) resumes bit for bit;
    another rank's layout is refused; the metrics' keys name the rank;
    per_device memory is the rank's, the whole the unsharded run's."""
    for rank, out in enumerate(ranks[0]):
        res = out["resume"]
        assert res["bitwise"]
        assert res["refused"].startswith("ValueError: state_dict does not match")
        assert res["files"] == [f"state.rank{r}of{WORLD}.pt" for r in range(WORLD)]
        assert f"L_max@rank{rank}" in res["metrics"] and "step" in res["metrics"]
        mine, whole, plain = res["memory"]
        for key in ("q", "momentum", "pcache", "lips"):
            assert whole[key] == plain[key], key
        assert mine["momentum"] < whole["momentum"] and mine["q"] < whole["q"]


def test_routing_errors_name_the_leaf(ranks):
    err = ranks[0][0]["errors"]
    assert err["plain"].startswith("ValueError") and "emb is a plain tensor" in err["plain"]
    assert err["placements"].startswith("ValueError") and "emb has placements" in err["placements"]
    assert err["unknown"].startswith("ValueError") and "do not match" in err["unknown"]
    assert err["indivisible"].startswith("ValueError") and "not divisible" in err["indivisible"]
    assert err["scanned_dtensor"].startswith("ValueError") and "blocks.w" in err["scanned_dtensor"]


def test_recipe_place_and_train_step(ranks):
    """JAX tests/test_recipe.py::test_recipe_place_and_train_step: the
    recipe's layout (stack sharding over fsdp, wte and wpe routed, wte a
    DTensor with the map's placements) trains a tiny GPT-2 with a falling
    loss; the state specs place wte's diagonal factor over (tp, fsdp)."""
    for out in ranks[0]:
        rec = out["recipe"]
        assert rec["stack"] == "fsdp" and sorted(rec["routed"]) == ["wpe", "wte"]
        assert rec["wte"] == "(Replicate(), Shard(dim=1), Shard(dim=0))"
        assert rec["losses"][-1] < rec["losses"][0] and np.isfinite(rec["losses"]).all()
        assert repr(rec["specs"]["q"][0]) == "(Replicate(), Shard(dim=0), Shard(dim=0))"


if __name__ == "__main__":
    raise SystemExit("run through tests/test_torch_parallel.py")
