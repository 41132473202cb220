"""Checkpoints across world sizes (``utils.gather_checkpoint``,
``utils.restore_checkpoint``) on the CPU, with 4 gloo ranks as
test_torch_parallel.py describes (``rank_results``; the ranks record
their draws, the parent answers with the JAX package's).

A k-rank run is checkpointed after 2 steps (one file per rank, named by
the world's 4 ranks: on the (dp 2, fsdp 2) mesh k = 2 is two replicas of
a 2-shard run), restored at another world size (the gathered
``state.pt`` cut to the rank's share) and stepped on, then held against
an unbroken run:

* stack-sharded KronWhiten and KronNewton on a tiny GPT-2 (4 layers):
  2 -> 1, 1 -> 2 and 2 -> 4, bit for bit (k ranks equal 1 rank);
* the gathered state of a 2-shard KronWhiten (JAX ``stack_sharding``'s
  problem of test_torch_parallel.py, float64) against the JAX package's
  global state after the same steps, rtol 1e-9;
* factor-sharded KronWhiten and KronNewton (test_torch_factor_sharding.py's
  cases at damping 0, where k ranks equal 1 at rtol 1e-9): 2 -> 1, 1 -> 2;
* vector-sharded LRAWhiten, LRANewton and DenseNewton QEQ
  (test_torch_vector_sharding.py's cases at n = 22): 2 -> 1, 1 -> 2 and
  2 -> 3 (n_pad 22 -> 24), against a 1-rank run fed the draws of the world
  size each step ran at (the shards' folded probes; dense's damping at
  the padded n), at that file's tolerances; the pad rows exact;
* a step saved again over itself at another world size: the last save's
  files alone remain, and they restore bit for bit;
* refusals: a per-shard optimizer at another world size, an incomplete
  rank set.
"""

import os
import shutil
import warnings

import numpy as np
import pytest
import torch

import test_torch_factor_sharding as fs
import test_torch_vector_sharding as vs
from test_torch_parallel import RTOL, _gpt2, rank_results

WORLD = 4
JAX_TREE = {"blocks.attn_qkv_w": (4, 16, 48), "blocks.ln1_scale": (4, 16),
            "wte": (32, 16)}
JAX_OPTS = dict(lr=0.05, momentum=0.9, whiten_grad=False,
                preconditioner_max_skew=2.0, preconditioner_init_scale=1.0,
                lr_preconditioner=0.2, grad_clip_max_amps=(1e3, 1e3))
JAX_STEPS = 3


def _error(fn) -> str:
    try:
        fn()
    except (ValueError, TypeError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def _holder(params: dict) -> torch.nn.Module:
    """A module whose state dict is ``params`` (dotted names nest; a
    plain tensor held as a buffer, in place)."""
    root = torch.nn.Module()
    for name, p in params.items():
        mod = root
        *path, last = name.split(".")
        for part in path:
            if not hasattr(mod, part):
                mod.add_module(part, torch.nn.Module())
            mod = getattr(mod, part)
        if isinstance(p, torch.nn.Parameter):
            mod.register_parameter(last, p)
        else:
            mod.register_buffer(last, p)
    return root


def _barrier():
    import torch.distributed as dist
    dist.barrier()


def _save(ckpt, step, model, opt, only_rank0: bool):
    """Every rank's file of a per-rank optimizer; an unsharded one's
    ``state.pt`` by rank 0 alone (the ranks hold the same)."""
    import torch.distributed as dist
    from psgd_torch_tpu_torch.utils import save_checkpoint
    if not only_rank0 or dist.get_rank() == 0:
        save_checkpoint(ckpt, step, model, opt)
    _barrier()


# ---------------------------------------------------------------------------
# rank side: no JAX
# ---------------------------------------------------------------------------


def _stack_spec(mesh, k):
    return None if k == 1 else (mesh, "fsdp") if k == 2 else (mesh, ("dp", "fsdp"))


def _stack_opt(kind, model, spec):
    from psgd_torch_tpu_torch.models import gpt2
    from psgd_torch_tpu_torch.optim import KronNewton, KronWhiten
    kw = dict(preconditioner_max_skew=2.0, preconditioner_init_scale=1.0,
              device="cpu", scanned_layers=gpt2.scanned_layers_mask(model),
              stack_sharding=spec, cache_p=True)
    if kind == "W":
        return KronWhiten(model.named_parameters(), lr=0.01, momentum=0.9,
                          whiten_grad=False,
                          preconditioner_update_probability=0.5, **kw)
    return KronNewton(model.named_parameters(), lr=0.05, momentum=0.9, **kw)


def _stack_steps(kind, model, opt, n, start):
    from psgd_torch_tpu_torch.models import gpt2
    cfg = model.cfg
    for i in range(start, start + n):
        x, y = gpt2.synthetic_lm_batch(torch.Generator().manual_seed(50 + i), 2,
                                       cfg.block_size, cfg.vocab_size, device="cpu")
        if kind == "W":
            opt.zero_grad()
            gpt2.loss_gpt2(model, x, y).backward()
            opt.step()
        else:
            opt.step(lambda: gpt2.loss_gpt2(model, x, y))


def _stack_state(model, opt) -> dict:
    sd = opt.state_dict()
    return dict(params={n: p.detach().clone() for n, p in model.named_parameters()},
                state=sd["state"], count=sd["psgd"]["count"])


def _stack_whole(opt, model) -> dict:
    """The optimizer's Q, L and caches made whole (its layers gathered
    over the stack group), for the comparison with an unbroken run."""
    from psgd_torch_tpu_torch.parallel import all_gather_stack
    out = _stack_state(model, opt)
    for i, st in out["state"].items():
        if opt.sharded[i]:
            st = dict(st)
            for key in ("q", "lips", "pcache"):
                if key in st:
                    st[key] = tuple(all_gather_stack(f.contiguous(), opt.stack)
                                    for f in st[key])
            out["state"][i] = st
    return out


def stack_resumes(mesh, directory) -> dict:
    """Per optimizer kind: the unbroken 1-rank run (4 steps) and each
    resumed run (2 steps at k, a checkpoint, 2 at k'), made whole."""
    from psgd_torch_tpu_torch.utils import restore_checkpoint
    out = {}
    for kind in ("W", "N"):
        gpt2, model, _ = _gpt2()
        opt = _stack_opt(kind, model, None)
        _stack_steps(kind, model, opt, 4, 0)
        out[(kind, "unbroken")] = _stack_state(model, opt)
        for k, k2 in ((2, 1), (1, 2), (2, 4)):
            ckpt = os.path.join(directory, f"stack_{kind}_{k}_{k2}")
            _, model, _ = _gpt2()
            opt = _stack_opt(kind, model, _stack_spec(mesh, k))
            _stack_steps(kind, model, opt, 2, 0)
            _save(ckpt, 2, model, opt, only_rank0=k == 1)
            _, model2, _ = _gpt2()
            with torch.no_grad():      # not the saved values: the restore's
                for p in model2.parameters():
                    p.mul_(0.5)
            opt2 = _stack_opt(kind, model2, _stack_spec(mesh, k2))
            step, _ = restore_checkpoint(ckpt, model2, opt2)
            _stack_steps(kind, model2, opt2, 2, 2)
            out[(kind, k, k2)] = dict(_stack_whole(opt2, model2), step=step,
                                      files=sorted(os.listdir(os.path.join(ckpt, "step_2"))))
            _barrier()
    return out


def resave_resumes(mesh, directory) -> dict:
    """Step 2 of one directory saved three times, each over the last: a
    2-shard stack-sharded KronWhiten run (gathered: its ``state.pt`` beside
    its rank files, and a planted rank file of another world size), a
    1-rank run, then a 4-shard run; all but the last on other batches.
    The files the last save leaves, and that save restored at 1 and at 2
    shards and stepped twice (the unbroken run's steps 2 and 3)."""
    import torch.distributed as dist
    from psgd_torch_tpu_torch.utils import gather_checkpoint, restore_checkpoint
    ckpt = os.path.join(directory, "resave")
    step_dir = os.path.join(ckpt, "step_2")
    for k, start in ((2, 10), (1, 20), (4, 0)):
        _, model, _ = _gpt2()
        opt = _stack_opt("W", model, _stack_spec(mesh, k))
        _stack_steps("W", model, opt, 2, start)
        _save(ckpt, 2, model, opt, only_rank0=k == 1)
        if k == 2 and dist.get_rank() == 0:
            gather_checkpoint(ckpt, device="cpu")
            shutil.copy(os.path.join(step_dir, "state.rank0of4.pt"),
                        os.path.join(step_dir, "state.rank0of2.pt"))
        _barrier()
    out = {"files": sorted(f for f in os.listdir(step_dir) if not f.startswith("."))}
    _barrier()
    for k2 in (1, 2):
        _, model, _ = _gpt2()
        opt = _stack_opt("W", model, _stack_spec(mesh, k2))
        step, _ = restore_checkpoint(ckpt, model, opt)
        _stack_steps("W", model, opt, 2, 2)
        out[k2] = dict(_stack_whole(opt, model), step=step)
        _barrier()
    return out


def jax_case(mesh, draw, directory) -> dict:
    """JAX_TREE's quadratic problem by a 2-shard KronWhiten with the JAX
    draws, checkpointed after JAX_STEPS steps and gathered (rank 0)."""
    from psgd_torch_tpu_torch.optim import KronWhiten
    from psgd_torch_tpu_torch.utils import gather_checkpoint
    rng = np.random.default_rng(0)
    init, c, b = {}, {}, {}
    for name, shape in JAX_TREE.items():
        init[name] = 0.5 * rng.standard_normal(shape)
        c[name] = torch.from_numpy(10.0 ** rng.uniform(-1, 1, shape))
        b[name] = torch.from_numpy(rng.standard_normal(shape))
    params = {n: torch.nn.Parameter(torch.tensor(v)) for n, v in init.items()}
    opt = KronWhiten(list(params.items()), stack_sharding=(mesh, "fsdp"),
                     device="cpu", draw=draw,
                     scanned_layers={n: n.startswith("blocks.") for n in JAX_TREE},
                     **JAX_OPTS)
    for _ in range(JAX_STEPS):
        for n, p in params.items():
            p.grad = c[n] * p.detach() + b[n]
        opt.step()
    ckpt = os.path.join(directory, "jax_case")
    _save(ckpt, JAX_STEPS, _holder(params), opt, only_rank0=False)
    import torch.distributed as dist
    if dist.get_rank() == 0:
        saved = torch.load(gather_checkpoint(ckpt, device="cpu"), weights_only=True)
        return dict(model={k: v.numpy() for k, v in saved["model"].items()},
                    state=saved["optimizer"]["state"],
                    layout=saved["optimizer"]["psgd"]["layout"])
    return {}


def factor_resumes(meshes, directory) -> dict:
    """Each test_torch_factor_sharding.py case at damping 0: 2 steps at k (its mesh) or 1, a
    checkpoint, 1 step at the other; the unbroken 1-rank run's 3."""
    from psgd_torch_tpu_torch.utils import restore_checkpoint
    out = {}
    for case, spec in fs.CASES.items():
        mesh = meshes[spec[2]]
        p1, o1 = fs.build(spec, mesh, None, sharded=False, damping=0.0)
        out[(case, "unbroken")] = fs.steps(spec, mesh, p1, o1, n=3, sharded=False)
        for sharded in (True, False):
            ckpt = os.path.join(directory, f"factor_{case}_{sharded}")
            pa, oa = fs.build(spec, mesh, None, sharded=sharded, damping=0.0)
            fs.steps(spec, mesh, pa, oa, n=2, sharded=sharded)
            _save(ckpt, 2, _holder(pa), oa, only_rank0=not sharded)
            pb, ob = fs.build(spec, mesh, None, sharded=not sharded, damping=0.0)
            restore_checkpoint(ckpt, _holder(pb), ob)
            got = fs.steps(spec, mesh, pb, ob, n=1, sharded=not sharded)
            out[(case, "2to1" if sharded else "1to2")] = got
            _barrier()
    return out


class WorldDraws:
    """A 1-rank run's draw hook that feeds it what the world size ``k``
    it stands for draws: LRA's (n, 1) probes and damping as k shards draw
    them under fold_in(key, shard), zero on the pad rows
    (``vs.ShardProbes``); dense's damping at the padded n, cut to n.  k
    None: the run's own draws."""

    def __init__(self, n, dense: bool):
        self.n, self.dense, self.k = n, dense, None

    def __call__(self, kind, keys, shape, dtype):
        from psgd_torch_tpu_torch.ops import fastrand
        key = np.asarray(keys, np.uint32).reshape(2)
        if kind == "uniform":
            return torch.from_numpy(np.asarray(fastrand.uniform01(key[None]))).to(dtype)
        if self.k is None or tuple(shape) != (self.n, 1):
            return fastrand.unit_noise(key, shape, dtype, "cpu")[None]
        if self.dense:
            n_pad = -(-self.n // self.k) * self.k
            return fastrand.unit_noise(key, (n_pad, 1), dtype, "cpu")[:self.n][None]
        return vs.ShardProbes(self.n, self.k)(kind, keys, shape, dtype)


VECTOR_MOVES = ((2, 1), (1, 2), (2, 3))


def vector_resumes(groups, rank, directory, cplx=False,
                   moves=VECTOR_MOVES) -> dict:
    """Each test_torch_vector_sharding.py case at n = 22: 2 steps at k, a checkpoint, 1 step at
    k' (on the ranks that k' takes), for (k, k') in ``moves``; the 1-rank
    reference fed each step's world's draws.  "1 rank" is LRA's unsharded
    optimizer and dense's one-rank group (the row-sharded QEQ keys its
    damping as a group does).  ``cplx``: the cases' complex form."""
    from psgd_torch_tpu_torch.utils import restore_checkpoint
    n, out = 22, {}
    for case in vs.CASES:
        dense = case == "dense"

        def spec(k):
            if k == 1:
                return groups[1] if dense else None
            return groups[k]

        for k, k2 in moves:
            draw = WorldDraws(n, dense)
            pr, orf = vs.build(case, n, spec(1), draw, cplx=cplx)
            draw.k = k if k > 1 else None
            vs.steps(case, n, pr, orf, 2)
            draw.k = k2 if k2 > 1 else None
            vs.steps(case, n, pr, orf, 1, start=2)
            ckpt = os.path.join(directory, f"vector_{case}_{k}_{k2}"
                                + "_complex" * cplx)
            pa, oa = vs.build(case, n, spec(k), None, cplx=cplx)
            vs.steps(case, n, pa, oa, 2)
            _save(ckpt, 2, _holder(pa), oa, only_rank0=k == 1 and not dense)
            if k2 != 3 or rank != 3:       # 3 ranks: rank 3 sits this one out
                pb, ob = vs.build(case, n, spec(k2), None, cplx=cplx)
                # 3 ranks restore: the first of them gathers the file
                restore_checkpoint(ckpt, _holder(pb), ob,
                                   group=groups[3] if k2 == 3 else None)
                vs.steps(case, n, pb, ob, 1, start=2)
                out[(case, k, k2)] = dict(got=vs.state(pb, ob), ref=vs.state(pr, orf),
                                          lo=ob.lo, n_loc=ob.n_loc, n_pad=ob.n_pad)
            _barrier()
    return out


def refusals(mesh2, mesh4, directory) -> dict:
    """A per-shard run on (dp 2, fsdp 2)'s fsdp, checkpointed and offered
    to the per-shard optimizer on fsdp 4; gather_checkpoint of those
    files; of a set with one rank file taken away."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor
    from psgd_torch_tpu_torch.parallel import per_shard_kron_whiten
    from psgd_torch_tpu_torch.utils import gather_checkpoint, restore_checkpoint

    def build(mesh):
        w = torch.nn.Parameter(distribute_tensor(
            torch.arange(64.0).reshape(8, 8) / 64, mesh, (Shard(0),) * mesh.ndim,
            src_data_rank=None))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            opt = per_shard_kron_whiten([("w", w)], mesh, device="cpu")
        return w, opt

    w, opt = build(mesh2["fsdp"])
    w.grad = torch.ones_like(w)
    opt.step()
    ckpt = os.path.join(directory, "per_shard")
    _save(ckpt, 1, _holder({"w": w}), opt, only_rank0=False)
    w4, opt4 = build(mesh4)
    out = dict(per_shard=_error(lambda: restore_checkpoint(ckpt, _holder({"w": w4}), opt4)),
               per_shard_gather=_error(lambda: gather_checkpoint(ckpt, device="cpu")))
    _barrier()
    if dist.get_rank() == 0:
        src = os.path.join(directory, "stack_W_2_1", "step_2")
        part = os.path.join(directory, "partial", "step_2")
        os.makedirs(part)
        for r in (0, 1, 3):
            shutil.copy(os.path.join(src, f"state.rank{r}of4.pt"), part)
        out["incomplete"] = _error(lambda: gather_checkpoint(
            os.path.join(directory, "partial"), device="cpu"))
    _barrier()
    return out


def run_cases(rank, world, draw, record, directory) -> dict:
    import torch.distributed as dist
    from psgd_torch_tpu_torch.parallel import make_mesh
    directory = os.path.join(directory, "record" if record else "run")
    os.makedirs(directory, exist_ok=True)
    mesh = make_mesh(axis_names=("dp", "fsdp"), axis_sizes=(2, 2), device_type="cpu")
    out = {"jax": jax_case(mesh, draw, directory)}
    if record:
        return out
    mesh4 = make_mesh(axis_names=("fsdp",), device_type="cpu")
    meshes = {k: fs._mesh(k) for k in fs.MESHES}
    ones = [dist.new_group([r]) for r in range(WORLD)]
    three = dist.new_group([0, 1, 2])
    groups = {1: ones[rank], 2: (mesh, "fsdp"), 3: three}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out["stack"] = stack_resumes(mesh, directory)
        out["resave"] = resave_resumes(mesh, directory)
        out["factor"] = factor_resumes(meshes, directory)
        out["vector"] = vector_resumes(groups, rank, directory)
    out["refusals"] = refusals(mesh, mesh4, directory)
    return out


# ---------------------------------------------------------------------------
# parent side
# ---------------------------------------------------------------------------


def _jax_reference() -> dict:
    """JAX kron_whiten with stack_sharding over 2 devices on JAX_TREE's
    problem: the global parameters, Q and momentum after JAX_STEPS."""
    import jax
    import jax.numpy as jnp
    import optax
    import psgd_torch_tpu.optim as jopt
    from psgd_torch_tpu.parallel import make_mesh
    rng = np.random.default_rng(0)
    init, c, b = {}, {}, {}
    for name, shape in JAX_TREE.items():
        init[name] = 0.5 * rng.standard_normal(shape)
        c[name] = 10.0 ** rng.uniform(-1, 1, shape)
        b[name] = rng.standard_normal(shape)

    def nest(flat):
        out = {"blocks": {}}
        for n, v in flat.items():
            if n.startswith("blocks."):
                out["blocks"][n.split(".", 1)[1]] = v
            else:
                out[n] = v
        return out

    cj, bj = (nest({n: jnp.asarray(v) for n, v in x.items()}) for x in (c, b))
    mask = nest({n: n.startswith("blocks.") for n in JAX_TREE})
    kw = dict(JAX_OPTS)
    kw["learning_rate"] = kw.pop("lr")
    mesh = make_mesh(2, axis_names=("fsdp",))
    opt = jopt.kron_whiten(scanned_layers=mask, stack_sharding=(mesh, "fsdp"), **kw)
    params = nest({n: jnp.asarray(v) for n, v in init.items()})
    state = opt.init(params)

    @jax.jit
    def step(p, s):
        g = jax.tree_util.tree_map(lambda x, cc, bb: cc * x + bb, p, cj, bj)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s

    for _ in range(JAX_STEPS):
        params, state = step(params, state)
    core = [s for s in state if hasattr(s, "precond")][0]
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    names = [".".join(p.key for p in path) for path, _ in flat]
    mus = jax.tree_util.tree_leaves(core.mu)
    return dict(params={n: np.asarray(v) for n, (_, v) in zip(names, flat)},
                q={n: [np.asarray(f) for f in st.q] for n, st in zip(names, core.precond)},
                mu={n: np.asarray(m) for n, m in zip(names, mus)})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return rank_results("test_torch_checkpoint_gather", WORLD,
                            tmp_path_factory.mktemp("gather"), _jax_reference)


def _equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("move", [(2, 1), (1, 2), (2, 4)])
@pytest.mark.parametrize("kind", ["W", "N"])
def test_stack_sharded_resume_across_world_sizes(ranks, kind, move):
    """2 steps stack-sharded over k ranks (or unsharded), a checkpoint, 2
    steps over k': the parameters, Q, L, caches and momentum equal the
    unbroken run's bit for bit, on every rank."""
    for rank, out in enumerate(ranks[0]):
        got, want = out["stack"][(kind,) + move], out["stack"][(kind, "unbroken")]
        assert got["step"] == 2 and got["count"] == want["count"] == 4
        assert _equal(got["params"], want["params"]), rank
        assert _equal(got["state"], want["state"]), rank
        if move[0] > 1:
            assert got["files"][-4:] == [f"state.rank{r}of4.pt" for r in range(4)]


@pytest.mark.parametrize("k2", [1, 2])
def test_a_step_saved_again_at_another_world_size_restores_the_newest(ranks, k2):
    """Step 2 saved by 2 shards (and gathered), by 1 rank, then by 4
    shards: the last save leaves its own rank files only (no gathered
    file, no rank file of another world size), and restored at k' shards
    it steps on bit for bit as the unbroken run (the earlier saves ran on
    other batches)."""
    for rank, out in enumerate(ranks[0]):
        res = out["resave"]
        assert res["files"] == [f"state.rank{r}of4.pt" for r in range(4)], rank
        got, want = res[k2], out["stack"][("W", "unbroken")]
        assert got["step"] == 2 and got["count"] == want["count"] == 4
        assert _equal(got["params"], want["params"]), rank
        assert _equal(got["state"], want["state"]), rank


def test_gathered_state_matches_jax_global_state(ranks):
    """The 2-shard run's gathered checkpoint against the JAX transform's
    global state after the same steps (JAX stack_sharding, the JAX
    draws): parameters, every Q factor whole and the momentum, rtol 1e-9;
    its layout the unsharded optimizer's."""
    outs, ref = ranks
    got = outs[0]["jax"]
    names = sorted(JAX_TREE, key=lambda n: tuple(n.split(".")))
    assert "stack_sharding" not in got["layout"]
    assert "layers" not in got["layout"]["leaf 0"]
    for i, name in enumerate(names):
        want = ref["params"][name]
        np.testing.assert_allclose(got["model"][name], want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max(), err_msg=name)
        st = got["state"][i]
        for f, g in zip(st["q"], ref["q"][name]):
            assert f.shape == g.shape, name
            np.testing.assert_allclose(f.numpy(), g, rtol=RTOL,
                                       atol=RTOL * np.abs(g).max(), err_msg=name)
        m = ref["mu"][name]
        np.testing.assert_allclose(st["mu"].numpy(), m, rtol=RTOL,
                                   atol=RTOL * np.abs(m).max(), err_msg=name)


@pytest.mark.parametrize("move", ["2to1", "1to2"])
@pytest.mark.parametrize("case", sorted(fs.CASES))
def test_factor_sharded_resume_across_world_sizes(ranks, case, move):
    """test_torch_factor_sharding.py's cases at damping 0: resumed across world sizes, every
    parameter within rtol 1e-9 of the unbroken 1-rank run (the tolerance
    k ranks keep against 1 there)."""
    for rank, out in enumerate(ranks[0]):
        got, want = out["factor"][(case, move)], out["factor"][(case, "unbroken")]
        for n in fs.NAMES:
            np.testing.assert_allclose(got[n], want[n], rtol=RTOL,
                                       atol=RTOL * np.abs(want[n]).max(),
                                       err_msg=f"rank {rank} {n}")


@pytest.mark.parametrize("move", [(2, 1), (1, 2), (2, 3)])
@pytest.mark.parametrize("case", sorted(vs.CASES))
def test_vector_sharded_resume_across_world_sizes(ranks, case, move):
    """test_torch_vector_sharding.py's cases at n = 22 resumed across world sizes against the
    1-rank run fed each step's world's draws: parameters (LRANewton's,
    whose norm clip acts, at 1e-6) and the rank's rows of U, V and d (Q)
    and of the momentum at 1e-9; the pad rows exact (U, V and the
    momentum 0, d 1, Q's rows e_i)."""
    hold_vector_resume([out["vector"] for out in ranks[0]], case, move)


def hold_vector_resume(results, case, move):
    """``test_vector_sharded_resume_across_world_sizes``'s checks of each
    rank's ``vector_resumes`` result for ``case`` and ``move``."""
    for rank, vector in enumerate(results):
        if move not in [m[1:] for m in vector if m[0] == case]:
            assert move == (2, 3) and rank == 3
            continue
        res = vector[(case,) + move]
        got, ref = res["got"], res["ref"]
        rows = slice(res["lo"], res["lo"] + res["n_loc"])
        for k in ref["params"]:
            vs._close(got["params"][k], ref["params"][k], f"rank {rank} {k}",
                      vs.CLIP_RTOL if case == "newton" else RTOL)
        n, n_pad = 22, res["n_pad"]
        for f, want in ref["precond"].items():
            mine = got["precond"][f]
            if want.ndim == 2 and want.shape[0] == 22:
                fill = 1.0 if f == "d" else 0.0
                pad = np.full((n_pad - n,) + want.shape[1:], fill)
                if f == "q":
                    pad = np.eye(n_pad)[n:, :n]
                whole = np.concatenate([want, pad])
                if f == "q":
                    whole = np.concatenate([whole, np.zeros((n_pad, n_pad - n))], 1)
                    whole[n:, n:] = np.eye(n_pad - n)
                want = whole[rows] if mine.shape[0] != 22 or n_pad != 22 else want
                true = max(0, min(res["lo"] + res["n_loc"], n) - res["lo"])
                assert np.array_equal(mine[true:], want[true:]), (rank, f)
            vs._close(mine, want, f"rank {rank} {f}")
        if ref["mu"] is not None:
            want = ref["mu"]
            if got["mu"].shape != want.shape:
                want = np.concatenate([want, np.zeros(n_pad - n)])
                want = want if case == "dense" else want[rows]
            vs._close(got["mu"], want, f"rank {rank} momentum")


def test_per_shard_refuses_another_world_size(ranks):
    """A per-shard checkpoint restores only at the world size that wrote
    it: the optimizer on fsdp 4 and gather_checkpoint refuse the fsdp-2
    run's files, saying why."""
    for out in ranks[0]:
        res = out["refusals"]
        assert res["per_shard"].startswith("ValueError") and "per-shard" in res["per_shard"]
        assert res["per_shard_gather"].startswith("ValueError")
        assert "per-shard" in res["per_shard_gather"]


def test_gather_refuses_an_incomplete_rank_set(ranks):
    res = ranks[0][0]["refusals"]
    assert res["incomplete"].startswith("ValueError")
    assert "ranks [2] of 4 are missing" in res["incomplete"]


if __name__ == "__main__":
    raise SystemExit("run through tests/test_torch_parallel.py")
