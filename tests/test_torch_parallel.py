"""The port's distributed slice against the JAX package, on the CPU:
stack-sharded KronWhiten and KronNewton (JAX ``stack_sharding``), the mesh,
the partition maps and ``drift_check`` (psgd_torch_tpu/parallel/mesh.py).

How the ranks run.  ``rank_results`` starts ``world`` processes of this
file (``python tests/test_torch_parallel.py <module> <rank> <world>
<dir>``), joined by gloo through a file store in a temporary directory, so
that xdist workers cannot collide on a port.  They import no JAX.  Each runs
its module's ``run_cases`` twice: first with a recording draw that opens
every gate, collecting the (kind, key, shape, dtype) of each draw the
JAX-replay cases make (the draws depend on the keys only, and an open gate
draws at least what a closed one does); then, once the parent has written
the JAX package's draws for those keys into the directory, for real.
Meanwhile the parent runs the JAX references on the 8-device CPU mesh that
conftest.py sets up.

The problem: a 4-layer GPT-2's attention and MLP stacks and embedding
(``TREE``) in float64 under a quadratic loss sum(c p^2 / 2 + b p), whose
gradient c p + b and Hessian-vector product c v both sides compute alike,
3 steps.  The port's k-rank run equals its 1-rank run bit for bit; the
k-rank run with the JAX draws matches the JAX transform at the same k at
rtol 1e-9.
"""

import importlib
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 4
STEPS = 3
RTOL = 1e-9

# name -> shape: the tiny GPT-2's (n_layer 4, n_embd 16, vocab 32) qkv stack
# (sharded), a LayerNorm stack (diagonal: replicated) and the embedding (no
# stack: replicated); three leaves keep the JAX compiles short
TREE = {"blocks.attn_qkv_w": (4, 16, 48), "blocks.ln1_scale": (4, 16),
        "wte": (32, 16)}
COMMON = dict(preconditioner_max_skew=2.0, preconditioner_init_scale=1.0,
              lr_preconditioner=0.2)
# name -> (whitening or Newton, options); every case at k = 1, 2 and 4 with
# the port's own draws, and those of JAX_AT at their k with the JAX draws
# (the options together: each JAX reference is a compile of seconds).  Their
# amplitude clip is set where it cannot act and their init scale is given:
# both sides take the clip's RMS and the whitening init scale's mean|g|^4 in
# float32, summed in another order, which alone moves the parameters ~1e-6
# (test_torch_kron_whiten.py); "whiten" holds both bit for bit, k against 1
WIDE_CLIP = (1e3, 1e3)
CASES = {
    "whiten": ("W", dict(lr=0.05, momentum=0.9, whiten_grad=False,
                         preconditioner_init_scale=None)),
    "whiten_share_cache": ("W", dict(
        lr=0.05, momentum=0.9, whiten_grad=False, cache_p=True,
        share_fit_apply=True, update_preconditioner_first=False,
        preconditioner_update_probability=0.5, grad_clip_max_amps=WIDE_CLIP)),
    "whiten_pipelined": ("W", dict(lr=0.05, momentum=0.9, whiten_grad=False,
                                   pipelined_fit=True, weight_decay=0.01,
                                   grad_clip_max_amps=WIDE_CLIP)),
    "newton": ("N", dict(lr=0.1, momentum=0.9, preconditioner_init_scale=None)),
    "newton_cache_clip": ("N", dict(lr=0.1, cache_p=True, momentum=0.9,
                                    grad_clip_max_norm=0.05,
                                    preconditioner_init_scale=None)),
}
JAX_AT = {"whiten_share_cache": 4, "whiten_pipelined": 2, "newton_cache_clip": 2}


def problem():
    """(initial values, c, b) per leaf, float64, from seed 0."""
    rng = np.random.default_rng(0)
    init, c, b = {}, {}, {}
    for name, shape in TREE.items():
        init[name] = 0.5 * rng.standard_normal(shape)
        c[name] = 10.0 ** rng.uniform(-1, 1, shape)
        b[name] = rng.standard_normal(shape)
    return init, c, b


# ---------------------------------------------------------------------------
# rank side: no JAX
# ---------------------------------------------------------------------------


class Recorder:
    """A draw hook that records what is asked for: every gate open (a
    uniform of 0), normals from a fixed stream."""

    def __init__(self):
        self.requests = set()

    def __call__(self, kind, keys, shape, dtype):
        keys = np.asarray(keys, np.uint32).reshape(-1, 2)
        for a, b in keys:
            self.requests.add((kind, int(a), int(b), tuple(shape), str(dtype)))
        if kind == "uniform":
            return torch.zeros(len(keys), dtype=dtype)
        rng = np.random.default_rng(int(keys[0, 0]))
        return torch.from_numpy(rng.standard_normal((len(keys),) + tuple(shape))).to(dtype)


class Replay:
    """A draw hook that answers from the parent's table of JAX draws."""

    def __init__(self, table):
        self.table = table

    def __call__(self, kind, keys, shape, dtype):
        keys = np.asarray(keys, np.uint32).reshape(-1, 2)
        return torch.stack([self.table[(kind, int(a), int(b), tuple(shape), str(dtype))]
                            for a, b in keys])


def stack_spec(mesh, k):
    """The stack_sharding argument for k shards on the (dp 2, fsdp 2) mesh:
    the fsdp dim, or both dims as one (shard = dp * 2 + fsdp)."""
    return None if k == 1 else (mesh, "fsdp") if k == 2 else (mesh, ("dp", "fsdp"))


def port_run(case, spec, draw):
    """The port on the quadratic problem: (parameters, Q per leaf, layout)."""
    from psgd_torch_tpu_torch.optim import KronNewton, KronWhiten
    kind, options = CASES[case]
    init, c, b = problem()
    params = {n: torch.tensor(v, requires_grad=True) for n, v in init.items()}
    cs = {n: torch.from_numpy(v) for n, v in c.items()}
    bs = {n: torch.from_numpy(v) for n, v in b.items()}
    kw = dict(COMMON, **options)
    opt = (KronWhiten if kind == "W" else KronNewton)(
        list(params.items()), stack_sharding=spec, device="cpu", draw=draw,
        scanned_layers={n: n.startswith("blocks.") for n in TREE}, **kw)

    def loss():
        return sum(torch.sum(0.5 * cs[n] * p * p + bs[n] * p)
                   for n, p in params.items())

    for _ in range(STEPS):
        if kind == "W":
            for n, p in params.items():
                p.grad = cs[n] * p.detach() + bs[n]
            opt.step()
        else:
            opt.step(loss)
    names = sorted(TREE, key=lambda n: tuple(n.split(".")))
    return dict(params={n: params[n].detach().numpy().copy() for n in TREE},
                q={n: [f.numpy().copy() for f in opt.state[params[n]]["q"]]
                   for n in names},
                sharded={n: s for n, s in zip(names, opt.sharded)},
                layout=opt.state_dict()["psgd"]["layout"])


def _gpt2(n_layer=4):
    from psgd_torch_tpu_torch.models import gpt2
    cfg = gpt2.tiny_config(n_layer=n_layer, n_head=2, n_embd=16, block_size=8,
                           vocab_size=32, compute_dtype=torch.float32)
    return gpt2, gpt2.GPT2(cfg, device="cpu", seed=0), cfg


def _gpt2_opt(gpt2, model, spec, **kw):
    from psgd_torch_tpu_torch.optim import KronWhiten
    return KronWhiten(model.named_parameters(), lr=0.01, momentum=0.9,
                      whiten_grad=False, preconditioner_max_skew=2.0,
                      preconditioner_init_scale=1.0, device="cpu",
                      scanned_layers=gpt2.scanned_layers_mask(model),
                      stack_sharding=spec, **kw)


def _error(fn) -> str:
    try:
        fn()
    except (ValueError, TypeError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def dp_drift(mesh, rank, world) -> dict:
    """The production layout: stack sharding over fsdp, every rank its own
    micro-batch, gradients averaged by all_reduce over the world, 6 steps;
    drift_check of every parameter, momentum and replicated Q and L."""
    import torch.distributed as dist
    from psgd_torch_tpu_torch.parallel import drift_check
    gpt2, model, cfg = _gpt2()
    opt = _gpt2_opt(gpt2, model, (mesh, "fsdp"))
    x, y = gpt2.synthetic_lm_batch(torch.Generator().manual_seed(10 + rank), 2,
                                   cfg.block_size, cfg.vocab_size, device="cpu")
    for _ in range(6):
        opt.zero_grad()
        gpt2.loss_gpt2(model, x, y).backward()
        for p in model.parameters():
            dist.all_reduce(p.grad)
            p.grad /= world
        opt.step()
    params = opt.param_groups[0]["params"]
    tensors = {f"param {i}": p for i, p in enumerate(params)}
    tensors.update({f"momentum {i}": opt.state[p]["mu"] for i, p in enumerate(params)})
    for i, p in enumerate(params):
        if not opt.sharded[i]:
            for j, f in enumerate(opt.state[p]["q"] + opt.state[p]["lips"]):
                tensors[f"Q/L {i}.{j}"] = f
    return dict(drift=drift_check(tensors), n_sharded=sum(opt.sharded))


def resume(mesh, rank, directory) -> dict:
    """A 2-shard run broken after 2 of 4 steps by a checkpoint (one file per
    rank) and a fresh model and optimizer, against the unbroken run; a
    4-shard state offered to the 2-shard optimizer."""
    import torch.distributed as dist
    from psgd_torch_tpu_torch.utils import restore_checkpoint, save_checkpoint
    gpt2, _, cfg = _gpt2()
    x, y = gpt2.synthetic_lm_batch(torch.Generator().manual_seed(1), 2,
                                   cfg.block_size, cfg.vocab_size, device="cpu")
    kw = dict(cache_p=True, preconditioner_update_probability=0.5)

    def steps(model, opt, n):
        for _ in range(n):
            opt.zero_grad()
            gpt2.loss_gpt2(model, x, y).backward()
            opt.step()

    _, a, _ = _gpt2()
    oa = _gpt2_opt(gpt2, a, (mesh, "fsdp"), **kw)
    steps(a, oa, 4)
    _, b, _ = _gpt2()
    ob = _gpt2_opt(gpt2, b, (mesh, "fsdp"), **kw)
    steps(b, ob, 2)
    ckpt = os.path.join(directory, "ckpt")
    save_checkpoint(ckpt, 2, b, ob)
    dist.barrier()          # every rank's file in place
    _, c, _ = _gpt2()
    oc = _gpt2_opt(gpt2, c, (mesh, "fsdp"), **kw)
    restore_checkpoint(ckpt, c, oc)
    steps(c, oc, 2)
    same = all(torch.equal(p, q) for p, q in zip(a.parameters(), c.parameters()))
    pa, pc = oa.param_groups[0]["params"], oc.param_groups[0]["params"]
    same_q = all(torch.equal(f, g) for p, q in zip(pa, pc)
                 for f, g in zip(oa.state[p]["q"], oc.state[q]["q"]))
    _, d, _ = _gpt2()
    four = _gpt2_opt(gpt2, d, (mesh, ("dp", "fsdp")), **kw).state_dict()
    refused = _error(lambda: oc.load_state_dict(four))
    files = sorted(os.listdir(os.path.join(ckpt, "step_2")))
    return dict(bitwise=same and same_q, refused=refused, files=files,
                count=oc.count)


def misc(mesh, rank) -> dict:
    """make_mesh's factoring and refusals, the partition maps, the
    indivisible stack, drift_check on a diverged tensor, the sharded
    optimizer's metrics and memory report."""
    from psgd_torch_tpu_torch.models import llama
    from psgd_torch_tpu_torch.parallel import (drift_check, gpt2_partition_specs,
                                               llama_partition_specs, make_mesh)
    from psgd_torch_tpu_torch.utils import psgd_metrics, state_memory_report
    out = {}
    m3 = make_mesh(device_type="cpu")
    out["mesh"] = (tuple(m3.mesh_dim_names), tuple(m3.mesh.shape))
    out["mesh_errors"] = [
        _error(lambda: make_mesh(axis_names=("dp", "fsdp"), axis_sizes=(3, 2),
                                 device_type="cpu")),
        _error(lambda: make_mesh(axis_names=("dp", "fsdp"), axis_sizes=(2, 2, 1),
                                 device_type="cpu"))]
    gpt2, model, _ = _gpt2()
    specs = gpt2_partition_specs(m3)
    out["gpt2_names"] = (sorted(specs), sorted(n for n, _ in model.named_parameters()))
    out["gpt2_specs"] = {n: repr(specs[n]) for n in ("wte", "blocks.attn_qkv_w",
                                                     "blocks.attn_proj_w", "lnf_bias")}
    both = gpt2_partition_specs(mesh, fsdp_axis=("dp", "fsdp"))
    out["gpt2_two_axes"] = repr(both["blocks.mlp_fc_w"])
    lcfg = llama.tiny_llama_config(n_layer=2, compute_dtype=torch.float32)
    lmodel = llama.Llama(lcfg, device="cpu", seed=0)
    lspecs = llama_partition_specs(m3, lmodel)
    out["llama_names"] = (sorted(lspecs), sorted(n for n, _ in lmodel.named_parameters()))
    out["llama_wqkv"] = repr(lspecs["blocks.wqkv"])
    _, six, _ = _gpt2(n_layer=6)
    out["indivisible"] = _error(lambda: _gpt2_opt(gpt2, six, (mesh, ("dp", "fsdp"))))
    out["drift"] = drift_check([torch.arange(6.0) * np.pi,
                                torch.full((2, 2), float(rank))])
    opt = _gpt2_opt(gpt2, model, (mesh, "fsdp"))
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    out["metrics"] = sorted(psgd_metrics(opt))
    out["memory"] = (state_memory_report(opt, per_device=True)["q"],
                     state_memory_report(opt)["q"])
    plain = _gpt2_opt(gpt2, _gpt2()[1], None)
    out["memory_plain"] = state_memory_report(plain)["q"]
    return out


def run_cases(rank, world, draw, record, directory) -> dict:
    """This module's cases on this rank.  ``record``: only the JAX-replay
    runs, with the recording hook."""
    from psgd_torch_tpu_torch.parallel import make_mesh
    mesh = make_mesh(axis_names=("dp", "fsdp"), axis_sizes=(2, 2), device_type="cpu")
    out = {}
    for case in CASES:
        if case in JAX_AT:
            out[("jax", case)] = port_run(case, stack_spec(mesh, JAX_AT[case]), draw)
        if record:
            continue
        for k in (1, 2, 4):
            out[(k, case)] = port_run(case, stack_spec(mesh, k), None)
    if not record:
        out["dp"] = dp_drift(mesh, rank, world)
        out["resume"] = resume(mesh, rank, directory)
        out["misc"] = misc(mesh, rank)
    return out


def _rank_main(module, rank, world, directory) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{directory}/store",
                            rank=rank, world_size=world)
    mod = importlib.import_module(module)
    recorder = Recorder()
    mod.run_cases(rank, world, recorder, True, directory)
    torch.save(sorted(recorder.requests), os.path.join(directory, f"req.{rank}.pt"))
    table = os.path.join(directory, "table.pt")
    deadline = time.monotonic() + 600
    while not os.path.exists(table):
        if time.monotonic() > deadline:
            raise TimeoutError("no draw table from the parent")
        time.sleep(0.05)
    out = mod.run_cases(rank, world, Replay(torch.load(table, weights_only=False)),
                        False, directory)
    dist.barrier()
    dist.destroy_process_group()
    torch.save(out, os.path.join(directory, f"out.{rank}.pt"))


# ---------------------------------------------------------------------------
# parent side
# ---------------------------------------------------------------------------


def _jax_table(requests) -> dict:
    """The JAX package's draws for the requested (kind, key, shape, dtype)."""
    from test_torch_kron import jax_draw
    groups = {}
    for kind, a, b, shape, dt in requests:
        groups.setdefault((kind, shape, dt), []).append((a, b))
    table = {}
    for (kind, shape, dt), keys in groups.items():
        out = jax_draw(kind, np.array(keys, np.uint32), shape,
                       getattr(torch, dt.split(".")[-1]))
        for (a, b), row in zip(keys, out):
            table[(kind, a, b, shape, dt)] = row.clone()
    return table


def rank_results(module, world, directory, references):
    """Start the ranks of ``module``, run ``references()`` meanwhile, answer
    the ranks' draws, and return (their results in rank order, the
    references)."""
    directory = str(directory)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, HERE]))
    logs = [open(os.path.join(directory, f"log.{r}"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), module,
                               str(r), str(world), directory], cwd=ROOT, env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]

    def failed():
        return [(r, open(os.path.join(directory, f"log.{r}")).read()[-3000:])
                for r, p in enumerate(procs) if p.poll() not in (None, 0)]

    try:
        refs = references()
        requests = set()
        deadline = time.monotonic() + 600
        for r in range(world):
            path = os.path.join(directory, f"req.{r}.pt")
            while not os.path.exists(path):
                assert not failed(), failed()
                assert time.monotonic() < deadline, f"rank {r} sent no draw requests"
                time.sleep(0.05)
            time.sleep(0.1)     # the file written through
            requests.update(torch.load(path, weights_only=False))
        tmp = os.path.join(directory, "table.tmp")
        torch.save(_jax_table(requests), tmp)
        os.replace(tmp, os.path.join(directory, "table.pt"))
        for p in procs:
            p.wait(timeout=600)
        assert not failed(), failed()
        return [torch.load(os.path.join(directory, f"out.{r}.pt"), weights_only=False)
                for r in range(world)], refs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()


def _jax_references() -> dict:
    """The JAX transforms with stack_sharding at JAX_AT[case] shards:
    (params, per-leaf Q) after STEPS steps."""
    import jax
    import jax.numpy as jnp
    import optax
    import psgd_torch_tpu.optim as jopt
    from psgd_torch_tpu.optim.hvp import make_hvp_fn
    from psgd_torch_tpu.parallel import make_mesh
    init, c, b = problem()

    def nest(flat):
        out = {"blocks": {}}
        for n, v in flat.items():
            if n.startswith("blocks."):
                out["blocks"][n.split(".", 1)[1]] = v
            else:
                out[n] = v
        return out

    cj, bj = nest({n: jnp.asarray(v) for n, v in c.items()}), \
        nest({n: jnp.asarray(v) for n, v in b.items()})
    mask = nest({n: n.startswith("blocks.") for n in TREE})

    def loss(p):
        return sum(jnp.sum(0.5 * cc * x * x + bb * x) for x, cc, bb in zip(
            jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(cj),
            jax.tree_util.tree_leaves(bj)))

    refs = {}
    for case, k in JAX_AT.items():
        kind, options = CASES[case]
        if k == 2:
            mesh, axis = make_mesh(2, axis_names=("fsdp",)), "fsdp"
        else:
            mesh, axis = make_mesh(4, axis_names=("dp", "fsdp"),
                                   axis_sizes=(2, 2)), ("dp", "fsdp")
        kw = dict(COMMON, **options)
        kw["learning_rate"] = kw.pop("lr")
        factory = jopt.kron_whiten if kind == "W" else jopt.kron_newton
        opt = factory(scanned_layers=mask, stack_sharding=(mesh, axis), **kw)
        params = nest({n: jnp.asarray(v) for n, v in init.items()})
        state = opt.init(params)
        if kind == "W":
            def step(p, s):
                g = jax.tree_util.tree_map(lambda x, cc, bb: cc * x + bb, p, cj, bj)
                u, s = opt.update(g, s, p)
                return optax.apply_updates(p, u), s
        else:
            hvp_fn = make_hvp_fn(loss)

            def step(p, s):
                g = jax.grad(loss)(p)
                u, s = opt.update(g, s, p, hvp_fn=hvp_fn)
                return optax.apply_updates(p, u), s
        step = jax.jit(step)
        for _ in range(STEPS):
            params, state = step(params, state)
        core = [s for s in state if hasattr(s, "precond")][0]
        flat = jax.tree_util.tree_flatten_with_path(params)[0]
        names = [".".join(p.key for p in path) for path, _ in flat]
        refs[case] = dict(
            params={n: np.asarray(v) for n, (_, v) in zip(names, flat)},
            q={n: [np.asarray(f) for f in st.q] for n, st in zip(names, core.precond)})
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return rank_results("test_torch_parallel", WORLD,
                            tmp_path_factory.mktemp("ranks"), _jax_references)


def _shard(rank, k) -> int:
    """Rank's shard of a k-way stack on the (dp 2, fsdp 2) mesh."""
    return rank % 2 if k == 2 else rank


def _layers(q, rank, k):
    n = q.shape[0] // k
    return q[_shard(rank, k) * n:(_shard(rank, k) + 1) * n]


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_stack_sharded_equals_one_rank(ranks, case, k):
    """Every rank's parameters equal the 1-rank run's and its Q its layers
    of the 1-rank Q (the replicated leaves' Q the whole), bit for bit."""
    outs, _ = ranks
    for rank, out in enumerate(outs):
        one, got = out[(1, case)], out[(k, case)]
        for n in TREE:
            assert np.array_equal(got["params"][n], one["params"][n]), (rank, n)
            for f, g in zip(got["q"][n], one["q"][n]):
                want = _layers(g, rank, k) if got["sharded"][n] else g
                assert np.array_equal(f, want), (rank, n)


@pytest.mark.parametrize("case", sorted(JAX_AT))
def test_stack_sharded_matches_jax(ranks, case):
    """The k-rank run with the JAX draws against JAX stack_sharding at the
    same k: parameters and each rank's Q layers at rtol 1e-9."""
    outs, refs = ranks
    ref, k = refs[case], JAX_AT[case]
    for rank, out in enumerate(outs):
        got = out[("jax", case)]
        for n in TREE:
            np.testing.assert_allclose(got["params"][n], ref["params"][n], rtol=RTOL,
                                       atol=RTOL * np.abs(ref["params"][n]).max(),
                                       err_msg=n)
            for f, g in zip(got["q"][n], ref["q"][n]):
                want = _layers(g, rank, k) if got["sharded"][n] else g
                np.testing.assert_allclose(f, want, rtol=RTOL,
                                           atol=RTOL * np.abs(g).max(), err_msg=n)


def test_each_rank_holds_its_layers(ranks):
    """Q work scales 1/k (JAX tests/test_parallel.py:205): a rank's Q of a
    sharded stack, the stacked fit's batch, is L/k layers; the layout
    records the world, the rank and each sharded leaf's layers."""
    outs, _ = ranks
    for rank, out in enumerate(outs):
        for k in (2, 4):
            got, one = out[(k, "whiten")], out[(1, "whiten")]
            assert sum(got["sharded"].values()) == 1
            for n, sharded in got["sharded"].items():
                for f, g in zip(got["q"][n], one["q"][n]):
                    assert f.shape[0] == (g.shape[0] // k if sharded else g.shape[0])
            layout = got["layout"]
            assert layout["stack_sharding"] == dict(world=k, rank=_shard(rank, k))
            s = _shard(rank, k) * 4 // k
            assert layout["leaf 0"]["layers"] == [s, s + 4 // k]
            assert "layers" not in layout["leaf 1"]     # the LayerNorm stack


def test_drift_check_zero_and_nonzero(ranks):
    """drift_check (JAX :183): exactly 0 on replicas of irrational values,
    the true max deviation from rank 0 on a diverged tensor (rank r holds
    r)."""
    for out in ranks[0]:
        assert out["misc"]["drift"] == [0.0, float(WORLD - 1)]


def test_production_layout_adds_no_drift(ranks):
    """Stack sharding with data-parallel gradients (JAX :593): after 6
    steps on distinct micro-batches every parameter, momentum and
    replicated Q and L is the same on every rank, bit for bit."""
    for out in ranks[0]:
        drift = out["dp"]["drift"]
        assert out["dp"]["n_sharded"] == 4
        assert len(drift) > 32 and set(drift.values()) == {0.0}, drift


def test_resume_is_bitwise_and_layout_checked(ranks):
    """A 2-shard run through a per-rank checkpoint equals the unbroken run
    bit for bit; a 4-shard state is refused with the layout mismatch."""
    for rank, out in enumerate(ranks[0]):
        res = out["resume"]
        assert res["bitwise"] and res["count"] == 4
        assert res["files"] == [f"state.rank{r}of{WORLD}.pt" for r in range(WORLD)]
        assert res["refused"].startswith("ValueError: state_dict does not match")
        assert "stack_sharding" in res["refused"]


def test_indivisible_stack_raises(ranks):
    """A 6-layer stack over 4 shards raises at construction, naming the
    leaf, L and k."""
    msg = ranks[0][0]["misc"]["indivisible"]
    assert msg.startswith("ValueError") and "blocks." in msg
    assert "6 layers" in msg and "4 shards" in msg


def test_make_mesh_and_partition_maps(ranks):
    """make_mesh factors 4 ranks as JAX factors 4 devices, (dp 1, fsdp 2,
    tp 2), and refuses sizes that do not fit; the GPT-2 and LLaMA maps
    name every parameter and place fsdp and tp as the JAX maps do (an
    fsdp of two mesh dims shards that tensor dim over both)."""
    m = ranks[0][0]["misc"]
    assert m["mesh"] == (("dp", "fsdp", "tp"), (1, 2, 2))
    assert "multiply to 6" in m["mesh_errors"][0]
    assert "does not match" in m["mesh_errors"][1]
    assert m["gpt2_names"][0] == m["gpt2_names"][1]
    assert m["llama_names"][0] == m["llama_names"][1]
    specs = m["gpt2_specs"]
    assert specs["wte"] == "(Replicate(), Shard(dim=1), Shard(dim=0))"
    assert specs["blocks.attn_qkv_w"] == "(Replicate(), Shard(dim=1), Shard(dim=2))"
    assert specs["blocks.attn_proj_w"] == "(Replicate(), Shard(dim=2), Shard(dim=1))"
    assert specs["lnf_bias"] == "(Replicate(), Replicate(), Replicate())"
    assert m["llama_wqkv"] == "(Replicate(), Shard(dim=1), Shard(dim=2))"
    assert m["gpt2_two_axes"] == "(Shard(dim=1), Shard(dim=1))"


def test_sharded_metrics_and_memory(ranks):
    """psgd_metrics of a stack-sharded optimizer names the rank in its
    keys; state_memory_report's per-device Q is the rank's own, the whole
    the unsharded optimizer's."""
    for rank, out in enumerate(ranks[0]):
        m = out["misc"]
        assert "step" in m["metrics"] and f"L_max@rank{rank}" in m["metrics"]
        mine, whole = m["memory"]
        assert whole == m["memory_plain"] and mine < whole


def test_factor_sharding_is_refused_naming_a8b():
    """factor_sharding is ported (tests/test_torch_factor_sharding.py); a
    map that cannot be matched to the parameters is refused: unnamed
    parameters, and a map that names none of them."""
    from psgd_torch_tpu_torch.optim import KronNewton, KronWhiten
    for opt in (KronWhiten, KronNewton):
        with pytest.raises(ValueError, match="named parameters"):
            opt([torch.zeros(4, 3)], device="cpu", factor_sharding=("mesh", {}))
        with pytest.raises(ValueError, match=r"\['w'\] have no placements"):
            opt([("w", torch.zeros(4, 3))], device="cpu",
                factor_sharding=("mesh", {}))


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
