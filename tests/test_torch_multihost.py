"""The port's multi-host mesh, FSDP2's layer-sharded blocks under
``stack_sharding`` and the sharded GPT-2 trainer, on the CPU with 4 gloo
ranks as test_torch_parallel.py describes (``rank_results``).

* ``make_multihost_mesh`` with ``LOCAL_WORLD_SIZE=2``: the 4 ranks as 2
  hosts of 2.  The JAX function's multi-process branch cannot run in one
  test process (its own test, tests/test_multiprocess.py, is marked
  slow), so the port is held against the rule that branch encodes,
  written out here (``jax_rule``): the leading axis spans the processes,
  the trailing axes factor a host's devices (tp 2 when even and >= 4,
  the rest fsdp), devices process-major; too few axis names raise JAX's
  ValueError; one host falls back to ``make_mesh``.
* A tiny GPT-2 ``fully_shard``-ed by layer (FSDP2, over the fsdp dim of a
  (dp 2, fsdp 2) mesh) and ``KronWhiten`` with ``stack_sharding`` over the
  same dim: parameters and state bit for bit the unsharded 1-rank run's,
  and no update gather for a layer-sharded stack (``count_collectives``).
  A stack sharded within its layers and KronNewton over FSDP2-style
  blocks run, bit for bit the unsharded optimizer; the closure path over
  shards its loss does not reach raises naming ROADMAP A8c.
* The trainer (``examples/train_gpt2_sharded.py``, its model sharded by
  ``gpt2.shard_model``) at its tiny width: on the 4 ranks as 2 hosts
  (replicas over dcn stay equal); 2 ranks
  save, 1 rank resumes and saves, 2 ranks resume; the loss falls;
  its first loss against the JAX ``gpt2.loss_gpt2`` on the same
  parameters (``params_from_jax``'s layout) and tokens, float32.
"""

import math
import os
import warnings

import numpy as np
import pytest
import torch

from test_torch_parallel import rank_results

WORLD = 4
TRAIN = ["--device", "cpu", "--batch", "4"]


def _error(fn) -> str:
    try:
        fn()
    except (ValueError, TypeError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def jax_rule(world: int, per_host: int, axis_names, ici_shape=None):
    """The JAX ``make_multihost_mesh`` multi-process branch
    (psgd_torch_tpu/parallel/mesh.py:110-137) on ``world`` devices of
    ``world // per_host`` processes: the mesh's shape and its devices
    (here ranks) in place, or the ValueError's message."""
    n_proc = world // per_host
    min_axes = 1 + (len(ici_shape) if ici_shape is not None else 2)
    if len(axis_names) < min_axes:
        return (f"make_multihost_mesh needs at least {min_axes} axis names "
                f"(one leading DCN axis + {min_axes - 1} ICI axes), got "
                f"{tuple(axis_names)}. With fewer axes an ICI dimension would "
                "fold into the DCN axis and its collectives would cross DCN.")
    if ici_shape is None:
        tp = 2 if per_host % 2 == 0 and per_host >= 4 else 1
        ici_shape = [1] * (len(axis_names) - 3) + [per_host // tp, tp]
    shape = [n_proc] + [1] * (len(axis_names) - 1 - len(ici_shape)) + list(ici_shape)
    return tuple(shape), np.arange(world).reshape(shape).tolist()


# ---------------------------------------------------------------------------
# rank side: no JAX
# ---------------------------------------------------------------------------


def meshes() -> dict:
    from psgd_torch_tpu_torch.parallel import make_mesh, make_multihost_mesh
    out = {}

    def grid(m):
        return (tuple(m.mesh_dim_names), tuple(int(n) for n in m.mesh.shape),
                m.mesh.tolist(), list(m.get_coordinate()))

    os.environ["LOCAL_WORLD_SIZE"] = "2"
    out["default"] = grid(make_multihost_mesh(device_type="cpu"))
    out["ici"] = grid(make_multihost_mesh(axis_names=("dcn", "fsdp"), ici_shape=(2,),
                                          device_type="cpu"))
    out["four"] = grid(make_multihost_mesh(axis_names=("dcn", "x", "fsdp", "tp"),
                                           device_type="cpu"))
    out["too_few"] = _error(lambda: make_multihost_mesh(axis_names=("dcn", "fsdp"),
                                                        device_type="cpu"))
    out["too_few_ici"] = _error(lambda: make_multihost_mesh(
        axis_names=("dcn", "fsdp"), ici_shape=(2, 1), device_type="cpu"))
    out["bad_ici"] = _error(lambda: make_multihost_mesh(ici_shape=(4, 1),
                                                        device_type="cpu"))
    os.environ["LOCAL_WORLD_SIZE"] = "4"
    out["one_host"] = grid(make_multihost_mesh(device_type="cpu"))
    out["one_host_names"] = grid(make_multihost_mesh(axis_names=("dcn", "fsdp"),
                                                     device_type="cpu"))
    out["make_mesh"] = grid(make_mesh(axis_names=("dcn", "fsdp", "tp"),
                                      device_type="cpu"))
    out["make_mesh_names"] = grid(make_mesh(axis_names=("dcn", "fsdp"),
                                            device_type="cpu"))
    del os.environ["LOCAL_WORLD_SIZE"]
    out["unset"] = grid(make_multihost_mesh(device_type="cpu"))
    return out


def _tiny(seed=0):
    from psgd_torch_tpu_torch.models import gpt2
    cfg = gpt2.tiny_config(n_layer=4, n_head=2, n_embd=16, block_size=8,
                           vocab_size=32, compute_dtype=torch.float32)
    return gpt2, gpt2.GPT2(cfg, device="cpu", seed=seed), cfg


OPTS = dict(lr=0.01, momentum=0.9, whiten_grad=False, preconditioner_max_skew=2.0,
            preconditioner_init_scale=1.0, share_fit_apply=True,
            update_preconditioner_first=False, cache_p=True,
            preconditioner_update_probability=0.5, device="cpu")


def fsdp_case(mesh) -> dict:
    """The FSDP2 model with the blocks Shard(0) over fsdp (the embeddings
    and the final LayerNorm replicated, ignored by FSDP2) and its
    stack-sharded KronWhiten, beside the unsharded run, 3 steps on one
    batch; each step's collectives."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Replicate
    from psgd_torch_tpu_torch.optim import KronWhiten
    from psgd_torch_tpu_torch.parallel import gpt2_partition_specs, sharding_recipe
    from psgd_torch_tpu_torch.utils import collective_bytes, count_collectives
    fm = mesh["fsdp"]
    gpt2, model, cfg = _tiny()
    mask = gpt2.scanned_layers_mask(model)
    pl = {n: (v if n.startswith("blocks.") else (Replicate(),))
          for n, v in gpt2_partition_specs(fm).items()}
    rec = sharding_recipe(fm, pl, model.named_parameters(), scanned_layers=mask)
    fully_shard(model, **rec.fsdp_kwargs(model))
    opt = KronWhiten(model.named_parameters(), **OPTS, **rec.transform_kwargs)
    _, ref, _ = _tiny()
    ropt = KronWhiten(ref.named_parameters(), scanned_layers=mask, **OPTS)
    x, y = gpt2.synthetic_lm_batch(torch.Generator().manual_seed(3), 2,
                                   cfg.block_size, cfg.vocab_size, device="cpu")
    calls, losses = [], []
    for _ in range(3):
        for m, o in ((model, opt), (ref, ropt)):
            o.zero_grad(set_to_none=True)
            loss = gpt2.loss_gpt2(m, x, y)
            loss.backward()
            if o is opt:
                losses.append(loss.item())
                with count_collectives() as c:
                    o.step()
                calls.append(collective_bytes(c, per_op=True))
            else:
                o.step()
    names = sorted(n for n, _ in model.named_parameters())
    order = sorted(names, key=lambda n: tuple(n.split(".")))
    local = dict(model.named_parameters())
    refp = dict(ref.named_parameters())
    out = dict(losses=losses, calls=calls, params={}, state={}, kinds={},
               fits=opt.fit_steps, ref_fits=ropt.fit_steps)
    for i, n in enumerate(order):
        p = local[n]
        if hasattr(p, "to_local"):
            block = opt._block(i)
            out["params"][n] = (p.to_local().clone(), refp[n][tuple(block)].clone())
        else:
            block = None
            out["params"][n] = (p.detach().clone(), refp[n].detach().clone())
        mine = opt.state[opt.param_groups[0]["params"][i]]
        theirs = ropt.state[ropt.param_groups[0]["params"][i]]
        cut = opt.layers[i] if opt.owned[i] else None
        out["state"][n] = dict(
            q=[(f.clone(), (g[cut] if cut is not None else g).clone())
               for f, g in zip(mine["q"] + mine["pcache"], theirs["q"] + theirs["pcache"])],
            mu=(mine["mu"].clone(),
                (theirs["mu"][tuple(block)] if block is not None else theirs["mu"]).clone()))
        out["kinds"][n] = ("owned" if opt.owned[i] else "whole" if opt.whole[i]
                           else "plain")
        out.setdefault("numel", {})[n] = refp[n].numel()
    specs = rec.state_specs(opt)
    out["specs"] = {n: {k: repr(v) for k, v in specs[n].items()}
                    for n in ("blocks.attn_qkv_w", "blocks.ln1_scale", "lnf_bias")}
    out["model_placements"] = {n: repr(v) for n, v in rec.model_placements().items()}
    return out


def refusals(mesh) -> dict:
    """A stack sharded within its layers (JAX's (None, fsdp, tp) layout)
    under stack_sharding, by KronWhiten; KronNewton over FSDP2-style
    layer blocks fed (v, H v); each 2 steps against the unsharded
    optimizer on the same values, bit for bit.  KronNewton's closure over
    blocks its loss does not reach (as under FSDP2); a DTensor leaf
    without stack_sharding."""
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor
    from psgd_torch_tpu_torch.optim import KronNewton, KronWhiten
    fm = mesh["fsdp"]
    whole = torch.randn(4, 16, 24, generator=torch.Generator().manual_seed(4))

    def leaf(pl):
        return torch.nn.Parameter(distribute_tensor(
            whole.clone(), fm, pl, src_data_rank=None))

    kw = dict(scanned_layers={"blocks.w": True}, device="cpu",
              preconditioner_init_scale=1.0)
    out = {}
    for name, cls, pl in (("within", KronWhiten, Shard(1)),
                          ("newton", KronNewton, Shard(0))):
        p, ref = leaf((pl,)), torch.nn.Parameter(whole.clone())
        opt = cls([("blocks.w", p)], stack_sharding=(fm, "fsdp"), **kw)
        one = cls([("blocks.w", ref)], **kw)
        gen = torch.Generator().manual_seed(5)
        for _ in range(2):
            g, v, h = (torch.randn(4, 16, 24, generator=gen) for _ in range(3))
            cut = tuple(slice(a, b) for a, b in _dtensor_box(p))
            p.grad = DTensor.from_local(g[cut].clone(), fm, (pl,), run_check=False)
            ref.grad = g
            if cls is KronWhiten:
                opt.step()
                one.step()
            else:
                opt.step(vs=[v], hvs=[h])
                _newton_reference(one, g, v, h)
        out[name] = dict(kind=("resharded" if opt.resharded[0] is not None else
                               "owned" if opt.owned[0] else "other"),
                         same=torch.equal(p.to_local(), ref.detach()[cut]))
    p = leaf((Shard(0),))
    opt = KronNewton([("blocks.w", p)], stack_sharding=(fm, "fsdp"), **kw)
    swapped = whole.clone().requires_grad_()    # what FSDP2 swaps in
    out["closure"] = _error(lambda: opt.step(lambda: torch.sum(swapped ** 2)))
    out["no_stack"] = _error(lambda: KronWhiten([("blocks.w", leaf((Shard(0),)))],
                                                **kw))
    return out


def _dtensor_box(p) -> list:
    from psgd_torch_tpu_torch.utils.checkpoint import _dtensor_index
    return _dtensor_index(p)


def _newton_reference(opt, g, v, h) -> None:
    """An unsharded KronNewton's step from the given gradient and pair (a
    fit step), its key chain advanced as ``step`` advances it."""
    from psgd_torch_tpu_torch.ops import fastrand
    keys = fastrand.split(opt.key, 4)
    opt.key = keys[0]
    with torch.no_grad():
        opt._newton_step([g], [v], [h], True, keys[3], opt.count)


def hsdp_trainer() -> dict:
    """The trainer's functions on the 4 ranks as 2 hosts of 2 (the stacks
    by layer over fsdp, replicas over dcn, each host its rows of the
    batch), 3 steps:
    the mesh, this rank's replica, its losses and its blocks' digests."""
    import hashlib
    from psgd_torch_tpu_torch.examples import train_gpt2_sharded as tr
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    try:
        cpu = torch.device("cpu")
        cfg = tr.make_config("tiny", cpu)
        s = tr.setup(cfg, 4, cpu)
        make = tr.batch_fn(cfg, 4, cpu, s.replicas, s.replica)
        losses = [tr.train_step(s, *make(i)).item() for i in range(3)]
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    digests = [hashlib.sha256(p.detach().numpy().tobytes()).hexdigest()
               for p in s.opt.param_groups[0]["params"]]
    return dict(mesh=tr.mesh_sizes(s.mesh), replica=s.replica, losses=losses,
                digests=digests, rows=tuple(make(0)[0].shape))


def run_cases(rank, world, draw, record, directory) -> dict:
    from psgd_torch_tpu_torch.parallel import make_mesh
    if record:
        return {}
    out = {"meshes": meshes()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out["hsdp"] = hsdp_trainer()
    mesh = make_mesh(axis_names=("dp", "fsdp"), axis_sizes=(2, 2), device_type="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out["fsdp"] = fsdp_case(mesh)
        out["refusals"] = refusals(mesh)
    return out


# ---------------------------------------------------------------------------
# parent side: the trainer's runs and the JAX loss, while the ranks run
# ---------------------------------------------------------------------------


def _trainer_runs(directory) -> dict:
    """2 ranks for 6 steps (saved), 1 rank resumed for 2 (saved), 2 ranks
    resumed for 2; the JAX loss of the trainer's first step."""
    import jax.numpy as jnp
    from psgd_torch_tpu.models import gpt2 as jgpt2
    from psgd_torch_tpu_torch.examples import train_gpt2_sharded as tr
    from psgd_torch_tpu_torch.models import gpt2
    ckpt = os.path.join(str(directory), "trainer")
    runs = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        runs["two"] = tr.main(TRAIN + ["--nproc", "2", "--steps", "6",
                                       "--ckpt_dir", ckpt])
        runs["files_6"] = sorted(os.listdir(os.path.join(ckpt, "step_6")))
        runs["one"] = tr.main(TRAIN + ["--steps", "2", "--resume", "--ckpt_dir", ckpt])
        runs["two_again"] = tr.main(TRAIN + ["--nproc", "2", "--steps", "2",
                                             "--resume", "--ckpt_dir", ckpt])
    runs["files"] = {s: sorted(os.listdir(os.path.join(ckpt, s)))
                     for s in sorted(os.listdir(ckpt))}
    cpu = torch.device("cpu")
    cfg = tr.make_config("tiny", cpu)
    model = gpt2.GPT2(cfg, device=cpu, seed=0)
    x, y = tr.batch_fn(cfg, 4, cpu)(0)
    runs["port_loss"] = gpt2.loss_gpt2(model, x, y).item()
    tree = {"blocks": {}}
    for n, p in model.named_parameters():
        v = jnp.asarray(p.detach().numpy())
        if n.startswith("blocks."):
            tree["blocks"][n.split(".", 1)[1]] = v
        else:
            tree[n] = v
    runs["round_trip"] = all(
        torch.equal(t, dict(model.named_parameters())[n].detach())
        for n, t in gpt2.params_from_jax(
            {k: (np.asarray(v) if not isinstance(v, dict) else
                 {kk: np.asarray(vv) for kk, vv in v.items()})
             for k, v in tree.items()}).items())
    jcfg = jgpt2.tiny_config(n_layer=4, n_head=4, n_embd=128, block_size=64,
                             vocab_size=512, compute_dtype=jnp.float32)
    runs["jax_loss"] = float(jgpt2.loss_gpt2(tree, jnp.asarray(x.numpy()),
                                             jnp.asarray(y.numpy()), jcfg))
    return runs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    directory = tmp_path_factory.mktemp("multihost")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return rank_results("test_torch_multihost", WORLD, directory,
                            lambda: _trainer_runs(directory))


@pytest.mark.parametrize("case,args", [
    ("default", (("dcn", "fsdp", "tp"), None)),
    ("ici", (("dcn", "fsdp"), (2,))),
    ("four", (("dcn", "x", "fsdp", "tp"), None))])
def test_multihost_mesh_follows_the_jax_rule(ranks, case, args):
    """2 hosts of 2 ranks: dcn spans the hosts (ranks 0-1 on host 0), the
    trailing dims stay within one; shape and layout as JAX's rule."""
    names, ici = args
    shape, grid = jax_rule(WORLD, 2, names, ici)
    for rank, out in enumerate(ranks[0]):
        got = out["meshes"][case]
        assert got[0] == names and got[1] == shape and got[2] == grid
        assert got[3][0] == rank // 2          # this rank's host
    if case == "default":
        assert shape == (2, 2, 1)


def test_multihost_mesh_refuses_too_few_axis_names(ranks):
    """JAX's ValueError, word for word, with the default ICI shape and a
    given one; an ICI shape that is not a host's ranks raises too."""
    for out in ranks[0]:
        m = out["meshes"]
        assert m["too_few"] == "ValueError: " + jax_rule(WORLD, 2, ("dcn", "fsdp"))
        assert m["too_few_ici"] == "ValueError: " + jax_rule(
            WORLD, 2, ("dcn", "fsdp"), (2, 1))
        assert m["bad_ici"].startswith("ValueError") and "2 ranks of a host" in m["bad_ici"]


def test_one_host_falls_back_to_make_mesh(ranks):
    """One host (LOCAL_WORLD_SIZE = the world, or unset): make_mesh's
    mesh, (dcn 1, fsdp 2, tp 2) for 4 ranks, even with two axis names."""
    for out in ranks[0]:
        m = out["meshes"]
        assert m["one_host"] == m["make_mesh"] == m["unset"]
        assert m["one_host"][1] == (1, 2, 2)
        assert m["one_host_names"] == m["make_mesh_names"]


def test_fsdp2_blocks_under_stack_sharding_equal_one_rank(ranks):
    """FSDP2's layer-sharded blocks and stack_sharding over its fsdp dim:
    each rank's parameter blocks, Q factors, caches and momentum equal
    the unsharded run's (its layers, its blocks) bit for bit after 3
    steps; the dense stacks are held by layer, the diagonal ones whole."""
    for rank, out in enumerate(ranks[0]):
        f = out["fsdp"]
        assert f["fits"] == f["ref_fits"] and f["fits"] >= 1
        assert f["kinds"]["blocks.attn_qkv_w"] == "owned"
        assert f["kinds"]["blocks.ln1_scale"] == "whole"
        assert f["kinds"]["wte"] == "plain"
        for n, (mine, theirs) in f["params"].items():
            assert torch.equal(mine, theirs), (rank, n)
        for n, st in f["state"].items():
            for mine, theirs in st["q"] + [st["mu"]]:
                assert mine.shape == theirs.shape and torch.equal(mine, theirs), (rank, n)


def test_no_update_gather_for_layer_sharded_stacks(ranks):
    """Each step's collectives are the all-gathers of the whole-gathered
    (diagonal) stacks' momentum, their bytes exactly; nothing moves a
    layer-sharded stack."""
    for out in ranks[0]:
        f = out["fsdp"]
        whole = sum(f["numel"][n] for n, k in f["kinds"].items() if k == "whole")
        for step in f["calls"]:
            assert step == {"all-gather": whole * 4}


def test_state_specs_follow_the_fsdp_layout(ranks):
    """recipe.model_placements: the stacks Shard(0) over fsdp, the rest
    replicated; state_specs: the momentum follows each parameter, the
    dense stacks' Q is by layer, a diagonal stack's (gathered whole) is
    replicated, as the optimizer holds them."""
    f = ranks[0][0]["fsdp"]
    assert f["model_placements"]["blocks.attn_qkv_w"] == "(Shard(dim=0),)"
    assert f["model_placements"]["blocks.ln1_scale"] == "(Shard(dim=0),)"
    assert f["model_placements"]["wte"] == "(Replicate(),)"
    assert f["specs"]["blocks.attn_qkv_w"]["mu"] == "(Shard(dim=0),)"
    assert f["specs"]["blocks.attn_qkv_w"]["q"] == "((Shard(dim=0),), (Shard(dim=0),))"
    assert f["specs"]["lnf_bias"]["mu"] == "(Replicate(),)"
    assert f["specs"]["blocks.ln1_scale"]["mu"] == "(Shard(dim=0),)"
    assert f["specs"]["blocks.ln1_scale"]["q"] == "((Replicate(),),)"


def test_within_layer_stacks_and_newton_raise_naming_a8c(ranks):
    """A stack sharded within its layers under stack_sharding is resharded
    to the rank's layers and KronNewton takes FSDP2-style layer blocks:
    both run, bit for bit the unsharded optimizer, on every rank.  What
    still raises names what blocks it: KronNewton's closure over shards
    its loss does not reach (FSDP2's) names ROADMAP A8c; a DTensor leaf
    without stack_sharding asks for it."""
    for out in ranks[0]:
        r = out["refusals"]
        assert r["within"] == dict(kind="resharded", same=True)
        assert r["newton"] == dict(kind="owned", same=True)
        assert r["closure"].startswith("NotImplementedError")
        assert "ROADMAP A8c" in r["closure"] and "blocks.w" in r["closure"]
        assert r["no_stack"].startswith("ValueError") and "stack_sharding" in r["no_stack"]


def test_trainer_on_two_hosts_keeps_replicas_equal(ranks):
    """The trainer on 2 hosts of 2 (LOCAL_WORLD_SIZE=2): mesh (dcn 2, fsdp
    2, tp 1), each host its half of the batch; after 3 steps the ranks
    that hold the same blocks on the two hosts hold them bit for bit
    (the trainer's gradient all-reduce over dcn), and the hosts' losses
    differ (their rows do)."""
    outs = ranks[0]
    for rank, out in enumerate(outs):
        h = out["hsdp"]
        assert h["mesh"] == {"dcn": 2, "fsdp": 2, "tp": 1}
        assert h["replica"] == rank // 2 and h["rows"] == (2, 64)
        assert all(math.isfinite(x) for x in h["losses"])
    for rank in (0, 1):
        assert outs[rank]["hsdp"]["digests"] == outs[rank + 2]["hsdp"]["digests"]
        assert outs[rank]["hsdp"]["losses"] != outs[rank + 2]["hsdp"]["losses"]
    assert outs[0]["hsdp"]["losses"] == outs[1]["hsdp"]["losses"]


def test_trainer_saves_and_resumes_across_world_sizes(ranks):
    """The trainer on 2 ranks saves its rank files; 1 rank resumes from
    them (gathering state.pt) and saves; 2 ranks resume from that; the
    loss falls from the first step to the last."""
    runs = ranks[1]
    assert len(runs["two"]) == 6 and len(runs["one"]) == 2 and len(runs["two_again"]) == 2
    assert runs["files_6"] == ["state.rank0of2.pt", "state.rank1of2.pt"]
    assert runs["files"]["step_6"] == ["state.pt", "state.rank0of2.pt", "state.rank1of2.pt"]
    assert runs["files"]["step_8"] == ["state.pt"]
    assert runs["files"]["step_10"] == ["state.rank0of2.pt", "state.rank1of2.pt"]
    losses = runs["two"] + runs["one"] + runs["two_again"]
    assert all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0]


def test_trainer_first_loss_matches_jax(ranks):
    """The trainer's first loss (2 ranks, stacks by layer) is the
    unsharded model's on the same tokens, bit for bit, and the JAX
    gpt2.loss_gpt2 on the same parameters and tokens at rtol 1e-5
    (float32)."""
    runs = ranks[1]
    assert runs["round_trip"]
    assert runs["two"][0] == runs["port_loss"]
    assert runs["jax_loss"] == pytest.approx(runs["port_loss"], rel=1e-5)


if __name__ == "__main__":
    raise SystemExit("run through tests/test_torch_parallel.py")
