"""JAX's production layout on the port, on the CPU with 4 gloo ranks as
test_torch_parallel.py describes (``rank_results``): a tiny GPT-2 (n_layer
4, n_head 4, n_embd 64, block 32, vocab 256) placed by
``gpt2_partition_specs`` on ``make_mesh``'s (dp 1, fsdp 2, tp 2), its blocks
sharded within their layers (``(None, fsdp, tp)``), by
``models.gpt2.shard_model``.

* (1), (2) ``KronWhiten`` and ``KronNewton`` with ``stack_sharding`` over
  fsdp against JAX ``kron_whiten`` and ``kron_newton`` with
  ``stack_sharding=(mesh, "fsdp")`` on ``make_mesh(4)`` over the same
  placements (JAX tests/test_parallel.py:131-177, :507-540), 3 steps in
  float64 with the JAX draws replayed, over three leaves of the model
  (``JAX_LEAVES``: one of each kind the optimizer makes of them; each JAX
  configuration is a compile of seconds per leaf).  The loss is the quadratic sum(c p^2 / 2
  + b p) over them, whose gradient c p + b and
  Hessian-vector product c v both sides compute alike, elementwise on each
  block (the port's Newton takes them through its closure, by autograd
  over the DTensor parameters): parameters and every Q and L row at rtol
  1e-9.  The model's own loss cannot be held there (3).
* (3) The tensor-parallel forward against JAX ``apply_gpt2`` and
  ``loss_gpt2`` on the same parameters (``params_from_jax``'s layout) and
  tokens.  The JAX model runs its LayerNorms and its attention's softmax
  in float32 and casts the logits to float32 whatever the compute dtype
  (the port's its LayerNorms and logits alike), so float64 compute holds
  them to float32's rounding, not 1e-9: the logits, the gradients of
  sum(C logits) (C float32) and their Hessian-vector product (double
  backward through the tp collectives against JAX's forward-over-reverse)
  at ``TP_RTOL``, the vocab-parallel cross-entropy and its gradients
  against ``loss_gpt2``'s at ``CE_RTOL``; float32 compute, the loss and
  its gradients at ``F32_RTOL``.  Every gap is relative to the largest
  entry of the JAX tensor; the readings were 1e-7 to 5e-7 (a wrong head
  or a skipped tp sum moves them by 1e-2 or more).
  With tp 1 the sharded forward is the plain one, bit for bit; at tp 2
  remat (each block recomputed with its collectives) changes no bit.
* (4) The optimizer alone: the within-layer layout, stack axis fsdp and
  ("fsdp", "tp"), whitening and Newton (with an acting norm clip and the
  on-the-fly init scale), against the unsharded model's optimizer on 1
  rank fed the same gradients: parameters and Q bit for bit, drift 0.0
  over the tp replicas, and each step's collective bytes the reshard's.
* (5) The trainer (``examples/train_gpt2_sharded.py``) on the 4 ranks:
  3 steps with a checkpoint after step 2; resumed on 4 ranks it equals the
  unbroken run bit for bit; gathered 4 -> 1 and resumed on 1 rank its step
  is the unbroken 4-rank step within ``RESUME_RTOL`` (the tp partial sums
  round otherwise); the 1-rank checkpoint cut 1 -> 4 restores each rank's
  blocks and state bit for bit; and the gathered 4-rank checkpoint
  resumed by the trainer on 2 ranks (tp 1, a second ``rank_results`` of
  2 ranks) steps as the 1-rank resume does.
"""

import math
import os
import warnings

import numpy as np
import pytest
import torch

from test_torch_parallel import rank_results

WORLD = 4
STEPS = 3
RTOL = 1e-9
# (3), 10x the readings (1.1e-7 to 5.0e-7): float64 compute through the
# float32 LayerNorms, softmax and logits; the vocab-parallel cross-entropy
# against JAX's log_softmax over float32 logits; float32 compute
TP_RTOL = 5e-6
CE_RTOL = 5e-6
F32_RTOL = 5e-6
# the 1-rank resume's step against the unbroken 4-rank step (float32)
RESUME_RTOL = 1e-4
CFG = dict(n_layer=4, n_head=4, n_embd=64, block_size=32, vocab_size=256)
# (1), (2): a resharded stack (None, fsdp, tp), a diagonal stack sharded
# over tp (gathered whole), the vocab-sharded embedding (tp, fsdp)
JAX_LEAVES = ("blocks.attn_qkv_w", "blocks.mlp_fc_b", "wte")
# the JAX cases' amplitude clip is set where it cannot act: both sides take
# its RMS in float32, summed in another order, which alone moves the
# parameters ~1e-7 (test_torch_parallel.py's WIDE_CLIP)
OPTS = {"W": dict(lr=0.05, momentum=0.9, preconditioner_init_scale=1.0,
                  preconditioner_max_skew=2.0, grad_clip_max_amps=(1e3, 1e3)),
        "N": dict(lr=0.05, preconditioner_init_scale=1.0,
                  preconditioner_max_skew=2.0)}
# (4)'s options on top: whitening the momentum with the on-the-fly init
# scale and the acting default clip, Newton with an acting norm clip
ALONE = {"W": dict(whiten_grad=False, preconditioner_init_scale=None,
                   grad_clip_max_amps=(2.0, 10.0)),
         "N": dict(grad_clip_max_norm=0.5, preconditioner_init_scale=None)}


def _cfg(dtype, **kw):
    from psgd_torch_tpu_torch.models import gpt2
    return gpt2.tiny_config(compute_dtype=dtype, param_dtype=dtype, **CFG, **kw)


def _model(dtype, mesh=None, **kw):
    from psgd_torch_tpu_torch.models import gpt2
    model = gpt2.GPT2(_cfg(dtype, **kw), device="cpu", seed=0)
    return model if mesh is None else gpt2.shard_model(model, mesh)


def _tokens():
    from psgd_torch_tpu_torch.models import gpt2
    return gpt2.synthetic_lm_batch(torch.Generator().manual_seed(1), 2,
                                   CFG["block_size"], CFG["vocab_size"],
                                   device="cpu")


def _problem():
    """(initial values, c, b) per parameter name, float64, from seed 0."""
    model = _model(torch.float64)
    rng = np.random.default_rng(0)
    init, c, b = {}, {}, {}
    for name, p in sorted(model.named_parameters()):
        init[name] = p.detach().numpy().copy()
        c[name] = 10.0 ** rng.uniform(-1, 1, p.shape)
        b[name] = rng.standard_normal(p.shape)
    return init, c, b


def _probes(dtype):
    """(C over the logits, float32 values; v per parameter) from seed 2."""
    rng = np.random.default_rng(2)
    c = rng.standard_normal((2, CFG["block_size"], CFG["vocab_size"])).astype(np.float32)
    model = _model(torch.float64)
    vs = {n: rng.standard_normal(p.shape) for n, p in sorted(model.named_parameters())}
    return c, vs


# ---------------------------------------------------------------------------
# rank side: no JAX
# ---------------------------------------------------------------------------


def _error(fn) -> str:
    try:
        fn()
    except (ValueError, TypeError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def _slices(p):
    from torch.distributed.tensor import DTensor
    if not isinstance(p, DTensor):
        return tuple(slice(None) for _ in p.shape)
    from psgd_torch_tpu_torch.parallel.sharded import _LeafShard
    return tuple(_LeafShard(p, p.device_mesh, "p").slices)


def _box(p) -> list:
    return [list(s.indices(int(n))[:2]) for s, n in zip(_slices(p), p.shape)]


def _local(p) -> torch.Tensor:
    return p.to_local() if hasattr(p, "to_local") else p


def port_run(kind, mesh, axis, draw, options=None, leaves=None) -> dict:
    """The port on the quadratic problem, STEPS steps: ``mesh`` None is
    the unsharded model on this rank alone; else ``shard_model``'s with
    ``stack_sharding=(mesh, axis)``; ``leaves``: those parameters only
    (default all).  Each parameter's block (and where it sits), each
    leaf's Q and L, the leaf kinds, each step's collective bytes and the
    drift of what the tp ranks hold alike."""
    from torch.distributed.tensor import DTensor
    from psgd_torch_tpu_torch.models import gpt2
    from psgd_torch_tpu_torch.optim import KronNewton, KronWhiten
    from psgd_torch_tpu_torch.utils import collective_bytes, count_collectives
    model = _model(torch.float64, mesh)
    init, c, b = _problem()
    params = {n: p for n, p in model.named_parameters()
              if leaves is None or n in leaves}
    cs = {n: torch.from_numpy(c[n][_slices(p)].copy()) for n, p in params.items()}
    bs = {n: torch.from_numpy(b[n][_slices(p)].copy()) for n, p in params.items()}
    kw = dict(OPTS[kind], **(options or {}))
    mask = gpt2.scanned_layers_mask(model)
    opt = (KronWhiten if kind == "W" else KronNewton)(
        list(params.items()), device="cpu", draw=draw,
        scanned_layers={n: mask[n] for n in params},
        stack_sharding=None if mesh is None else (mesh, axis), **kw)

    def loss():
        return sum(torch.sum(0.5 * cs[n] * _local(p) ** 2 + bs[n] * _local(p))
                   for n, p in params.items())

    calls = []
    for _ in range(STEPS):
        if kind == "W":
            for n, p in params.items():
                g = cs[n] * _local(p).detach() + bs[n]
                p.grad = (DTensor.from_local(g, p.device_mesh, p.placements,
                                             run_check=False)
                          if isinstance(p, DTensor) else g)
        with count_collectives() as window:
            opt.step() if kind == "W" else opt.step(loss)
        calls.append(collective_bytes(window, per_op=True))
    order = sorted(params, key=lambda n: tuple(n.split(".")))
    out = dict(params={n: (_local(p).detach().numpy().copy(), _box(p))
                       for n, p in params.items()},
               q={}, lips={}, kinds={}, layers={}, calls=calls)
    for i, n in enumerate(order):
        st = opt.state[opt.param_groups[0]["params"][i]]
        out["q"][n] = [f.numpy().copy() for f in st["q"]]
        out["lips"][n] = [f.numpy().copy() for f in st["lips"]]
        if mesh is not None:
            out["kinds"][n] = ("resharded" if opt.resharded[i] is not None else
                               "owned" if opt.owned[i] else
                               "whole" if opt.whole[i] is not None else "plain")
            s = opt.layers[i]
            out["layers"][n] = None if s is None else (s.start, s.stop)
    if mesh is not None:
        from psgd_torch_tpu_torch.parallel import drift_check
        tp = mesh.get_group("tp")
        alike = {}
        for i, n in enumerate(order):
            if opt.resharded[i] is not None and "tp" in axis:
                continue        # the tp ranks hold other layers
            st = opt.state[opt.param_groups[0]["params"][i]]
            for j, f in enumerate(st["q"] + st["lips"]):
                alike[f"{n} Q/L {j}"] = f
        out["drift"] = drift_check(alike, group=tp)
        out["bytes"] = _reshard_bytes(opt) if kind == "W" else None
    return out


def _reshard_bytes(opt) -> dict:
    """The collective bytes a whitening step of ``opt`` after the first
    should count on this rank (each call's result): per resharded stack,
    its momentum's ``to_layers`` (the all-to-all of its block, then the
    all-gathers, the minor mesh dim first, each result larger by its dim's
    size) and its update's ``to_block`` (the all-to-all of its block); per
    gathered leaf, ``gather_whole``'s all-gathers of its momentum."""
    from psgd_torch_tpu_torch.parallel.mesh import sharding_axes
    out = {"all-to-all": 0, "all-gather": 0}
    for i, p in enumerate(opt.param_groups[0]["params"]):
        mu = opt.state[p]["mu"]
        size = mu.element_size()
        if opt.resharded[i] is not None:
            reshard = opt.resharded[i][0]
            out["all-to-all"] += mu.numel() * size + p.numel() * p.element_size()
            kept = set(reshard.by_dim) - {d for _, d in reshard.gather}
            part = reshard.layers * math.prod(
                n if d in kept else m for d, (n, m) in
                enumerate(zip(reshard.shape, p.shape)) if d > 0)
            for name, _ in reversed(reshard.gather):
                part *= reshard.axes.size((name,))
                out["all-gather"] += part * size
        elif opt.whole[i] is not None:
            axes, placements, _ = opt.whole[i]
            part = mu.numel()
            for name, _ in reversed(sharding_axes(placements, axes.mesh.mesh_dim_names)):
                if axes.size((name,)) > 1:
                    part *= axes.size((name,))
                    out["all-gather"] += part * size
    return {k: v for k, v in out.items() if v}


def tp_forward(mesh, dtype) -> dict:
    """The tensor-parallel forward on the tokens: the logits (gathered
    whole), the gradients of sum(C logits) and their Hv (float64 only),
    the loss and its gradients, each parameter's block."""
    from torch.distributed.tensor import DTensor
    from psgd_torch_tpu_torch.models import gpt2
    from psgd_torch_tpu_torch.optim import hvp
    model = _model(dtype, mesh)
    x, y = _tokens()
    params = dict(sorted(model.named_parameters()))
    names, ps = list(params), list(params.values())

    def blocks(gs):
        return {n: (g.to_local().detach().numpy().copy(), _box(p))
                for n, p, g in zip(names, ps, gs)}

    out = {}
    if dtype == torch.float64:
        c, vs = _probes(dtype)
        ct = torch.from_numpy(c)
        out["logits"] = model(x).detach().numpy().copy()

        def functional():
            return torch.sum(model(x) * ct)
        v = [DTensor.from_local(torch.from_numpy(vs[n][_slices(p)].copy()),
                                p.device_mesh, p.placements, run_check=False)
             for n, p in params.items()]
        grads, hvs = hvp.hvp_exact(functional, ps, v)
        out["grads"], out["hv"] = blocks(grads), blocks(hvs)
    loss = gpt2.loss_gpt2(model, x, y)
    out["loss"] = loss.item()
    out["loss_grads"] = blocks(torch.autograd.grad(loss, ps))
    return out


def tp_one() -> dict:
    """The sharded forward on a mesh whose tp dim is 1 ((fsdp 4, tp 1):
    every fsdp block gathered in the forward) against the plain model:
    the loss and each parameter's gradient block, bit for bit."""
    from psgd_torch_tpu_torch.models import gpt2
    from psgd_torch_tpu_torch.parallel import make_mesh
    mesh = make_mesh(axis_names=("fsdp", "tp"), axis_sizes=(4, 1), device_type="cpu")
    sharded, plain = _model(torch.float32, mesh), _model(torch.float32)
    x, y = _tokens()
    out = {}
    for name, model in (("sharded", sharded), ("plain", plain)):
        loss = gpt2.loss_gpt2(model, x, y)
        grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
        out[name] = (loss.item(), {n: _local(g) for (n, _), g in
                                   zip(model.named_parameters(), grads)})
    slices = {n: _slices(p) for n, p in sharded.named_parameters()}
    return dict(loss=(out["sharded"][0], out["plain"][0]), grads={
        n: torch.equal(g, out["plain"][1][n][slices[n]])
        for n, g in out["sharded"][1].items()})


def tp_remat(mesh) -> dict:
    """The tensor-parallel forward with remat (each block, its tp
    collectives included, recomputed in the backward) against the same
    without: the loss and each gradient block (float32)."""
    from psgd_torch_tpu_torch.models import gpt2
    x, y = _tokens()
    out = []
    for remat in (False, True):
        model = _model(torch.float32, mesh, remat=remat)
        loss = gpt2.loss_gpt2(model, x, y)
        grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
        out.append((loss.item(), [_local(g) for g in grads]))
    (l0, g0), (l1, g1) = out
    return dict(loss=(l0, l1), equal=[torch.equal(a, b) for a, b in zip(g0, g1)])


def refusals(mesh) -> dict:
    """What still raises: a layout the reshard cannot express, a model
    layout the tp forward does not take, FSDP2 at tp > 1."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from psgd_torch_tpu_torch.models import gpt2
    from psgd_torch_tpu_torch.optim import KronWhiten
    from psgd_torch_tpu_torch.parallel import gpt2_partition_specs, sharding_recipe
    leaf = torch.nn.Parameter(distribute_tensor(
        torch.zeros(4, 16, 24), mesh, (Replicate(), Shard(1), Shard(0)),
        src_data_rank=None))
    out = {"layer_dim": _error(lambda: KronWhiten(
        [("blocks.w", leaf)], scanned_layers={"blocks.w": True}, device="cpu",
        preconditioner_init_scale=1.0, stack_sharding=(mesh, "fsdp")))}
    specs = gpt2_partition_specs(mesh)
    specs["blocks.mlp_fc_w"] = specs["blocks.attn_proj_w"]
    out["tp_layout"] = _error(lambda: gpt2.shard_model(_model(torch.float32), mesh,
                                                       specs))
    model = _model(torch.float32)
    rec = sharding_recipe(mesh, gpt2_partition_specs(mesh), model.named_parameters(),
                          scanned_layers=gpt2.scanned_layers_mask(model))
    out["fsdp2"] = _error(lambda: rec.fsdp_kwargs(model))
    out["model_placements"] = {n: repr(v) for n, v in rec.model_placements().items()}
    gpt2.shard_model(model, mesh, rec.model_placements())
    opt = KronWhiten(model.named_parameters(), device="cpu", momentum=0.9,
                     preconditioner_init_scale=1.0, **rec.transform_kwargs)
    specs = rec.state_specs(opt)
    out["state_specs"] = {n: {k: repr(v) for k, v in specs[n].items()}
                          for n in ("blocks.attn_qkv_w", "blocks.ln1_scale", "wte")}
    return out


def trainer_case(directory) -> dict:
    """The trainer's functions on the 4 ranks ((dp 1, fsdp 2, tp 2)):
    checkpoint A after 2 steps, the unbroken third; A resumed on 4 ranks;
    A gathered and resumed on 1 rank (rank 0, no group), saved as B after
    its step; B cut for 4 ranks."""
    import torch.distributed as dist
    from psgd_torch_tpu_torch.examples import train_gpt2_sharded as tr
    from psgd_torch_tpu_torch.utils import (gather_checkpoint, restore_checkpoint,
                                            save_checkpoint)
    cpu = torch.device("cpu")
    a, b = os.path.join(directory, "a"), os.path.join(directory, "b")
    cfg = tr.make_config("tiny", cpu)
    make = tr.batch_fn(cfg, 4, cpu)

    def blocks(s):
        return {n: _local(p).detach().clone() for n, p in s.model.named_parameters()}

    s = tr.setup(cfg, 4, cpu)
    out = {"mesh": tr.mesh_sizes(s.mesh),
           "kinds": [("resharded" if r is not None else "owned" if o else
                      "whole" if w is not None else "routed")
                     for r, o, w in zip(s.opt.resharded, s.opt.owned, s.opt.whole)]}
    losses = [tr.train_step(s, *make(i)).item() for i in range(2)]
    save_checkpoint(a, 2, s.model, s.opt)
    out["at_a"] = blocks(s)
    losses.append(tr.train_step(s, *make(2)).item())
    out["losses"], out["unbroken"] = losses, blocks(s)
    out["unbroken_state"] = s.opt.state_dict()
    out["slices"] = {n: _slices(p) for n, p in s.model.named_parameters()}
    s2 = tr.setup(cfg, 4, cpu)
    restore_checkpoint(a, s2.model, s2.opt)
    tr.train_step(s2, *make(2))
    out["same"] = all(torch.equal(x, out["unbroken"][n])
                      for n, x in blocks(s2).items())
    dist.barrier()
    if dist.get_rank() == 0:
        gather_checkpoint(a, device="cpu")
        from psgd_torch_tpu_torch.models import gpt2
        one = gpt2.GPT2(cfg, device=cpu, seed=0)
        opt = tr.make_optimizer(one, 4, cpu,
                                scanned_layers=gpt2.scanned_layers_mask(one))
        s1 = tr.Setup(cfg, one, opt, None, 1, 0)
        restore_checkpoint(a, one, opt)
        out["one_at_a"] = {n: p.detach().clone() for n, p in one.named_parameters()}
        out["one_loss"] = tr.train_step(s1, *make(2)).item()
        out["one"] = {n: p.detach().clone() for n, p in one.named_parameters()}
        save_checkpoint(b, 3, one, opt)
        out["one_state"] = opt.state_dict()
    dist.barrier()
    s3 = tr.setup(cfg, 4, cpu)
    step, _ = restore_checkpoint(b, s3.model, s3.opt)
    out["cut_step"], out["cut"] = step, blocks(s3)
    out["cut_state"] = s3.opt.state_dict()
    out["cut_pieces"] = s3.opt._pieces()
    out["files"] = {d: sorted(os.listdir(os.path.join(directory, d, f"step_{k}")))
                    for d, k in (("a", 2), ("b", 3))}
    return out


def two_rank_resume(directory) -> dict:
    """The trainer's functions on 2 ranks ((dp 1, fsdp 2, tp 1), its
    stacks ``Shard(0)`` by layer): the 4-rank checkpoint A, gathered by
    ``trainer_case``, cut for 2 ranks and its third step taken."""
    from psgd_torch_tpu_torch.examples import train_gpt2_sharded as tr
    from psgd_torch_tpu_torch.utils import restore_checkpoint
    cpu = torch.device("cpu")
    cfg = tr.make_config("tiny", cpu)
    s = tr.setup(cfg, 4, cpu)
    step, _ = restore_checkpoint(os.path.join(os.path.dirname(directory), "a"),
                                 s.model, s.opt)

    def blocks():
        return {n: _local(p).detach().clone() for n, p in s.model.named_parameters()}

    out = dict(mesh=tr.mesh_sizes(s.mesh), step=step, at=blocks(),
               routed=[n for n, r in zip(s.opt._names, s.opt.routed) if r is not None],
               slices={n: _slices(p) for n, p in s.model.named_parameters()})
    out["loss"] = tr.train_step(s, *tr.batch_fn(cfg, 4, cpu)(step)).item()
    out["after"] = blocks()
    return out


_OWN = {}      # the cases that take no JAX draw, run in the recording pass


def run_cases(rank, world, draw, record, directory) -> dict:
    """The JAX-replay cases (with the recording hook first), and in the
    recording pass, while the parent compiles the JAX references, every
    other case."""
    from psgd_torch_tpu_torch.parallel import make_mesh
    if world == 2:       # after the 4 ranks: their checkpoint on 2
        if record:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                _OWN["two"] = two_rank_resume(str(directory))
        return dict(_OWN)
    mesh = make_mesh(device_type="cpu")
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for kind in ("W", "N"):
            out[("jax", kind)] = port_run(kind, mesh, "fsdp", draw,
                                          leaves=JAX_LEAVES)
        if not record:
            return {**_OWN, **out}
        for kind in ("W", "N"):
            _OWN[(1, kind)] = port_run(kind, None, None, None, ALONE[kind])
            for axis in ("fsdp", ("fsdp", "tp")):
                _OWN[(axis, kind)] = port_run(kind, mesh, axis, None, ALONE[kind])
        _OWN["f64"] = tp_forward(mesh, torch.float64)
        _OWN["f32"] = tp_forward(mesh, torch.float32)
        _OWN["tp_one"] = tp_one()
        _OWN["remat"] = tp_remat(mesh)
        _OWN["refusals"] = refusals(mesh)
        _OWN["trainer"] = trainer_case(str(directory))
    return out


# ---------------------------------------------------------------------------
# parent side: the JAX references, while the ranks run
# ---------------------------------------------------------------------------


def _nest(flat: dict) -> dict:
    out = {"blocks": {}}
    for n, v in flat.items():
        if n.startswith("blocks."):
            out["blocks"][n.split(".", 1)[1]] = v
        else:
            out[n] = v
    return out


def _flat(tree) -> dict:
    import jax
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(k.key for k in path): np.asarray(v) for path, v in leaves}


def _jax_stack(kind) -> dict:
    """JAX kron_whiten / kron_newton with stack_sharding over fsdp on
    make_mesh(4), the parameters placed by gpt2_partition_specs, on the
    quadratic problem: (parameters, Q and L per leaf) after STEPS steps."""
    import jax
    import jax.numpy as jnp
    import optax
    import psgd_torch_tpu.optim as jopt
    from psgd_torch_tpu.models import gpt2 as jgpt2
    from psgd_torch_tpu.optim.hvp import make_hvp_fn
    from psgd_torch_tpu.parallel import (gpt2_partition_specs, make_mesh,
                                         named_shardings, psgd_state_specs)
    init, c, b = (_nest({n: jnp.asarray(v) for n, v in x.items() if n in JAX_LEAVES})
                  for x in _problem())
    mesh = make_mesh(4)
    params, cj, bj = init, c, b
    mask = {"blocks": {k: True for k in params["blocks"]}, "wte": False}
    kw = dict(OPTS[kind])
    kw["learning_rate"] = kw.pop("lr")
    factory = jopt.kron_whiten if kind == "W" else jopt.kron_newton
    opt = factory(scanned_layers=mask, stack_sharding=(mesh, "fsdp"), **kw)
    state = opt.init(params)
    every = gpt2_partition_specs()
    p_specs = {"blocks": {k: every["blocks"][k] for k in params["blocks"]},
               "wte": every["wte"]}
    s_specs = psgd_state_specs(p_specs, state, scanned_layers=mask, stack_axis="fsdp")
    state = jax.device_put(state, named_shardings(mesh, s_specs))
    p = jax.device_put(params, named_shardings(mesh, p_specs))

    def loss(q):
        return sum(jnp.sum(0.5 * cc * x * x + bb * x) for x, cc, bb in zip(
            jax.tree_util.tree_leaves(q), jax.tree_util.tree_leaves(cj),
            jax.tree_util.tree_leaves(bj)))

    hvp_fn = make_hvp_fn(loss)

    @jax.jit
    def step(p, s):
        g = jax.tree_util.tree_map(lambda x, cc, bb: cc * x + bb, p, cj, bj)
        u, s = (opt.update(g, s, p) if kind == "W" else
                opt.update(g, s, p, hvp_fn=hvp_fn))
        return optax.apply_updates(p, u), s

    with mesh:
        for _ in range(STEPS):
            p, state = step(p, state)
    core = [s for s in state if hasattr(s, "precond")][0]
    names = list(_flat(p))
    return dict(params=_flat(p),
                q={n: [np.asarray(f) for f in st.q] for n, st in zip(names, core.precond)},
                lips={n: [np.asarray(f) for f in st.lips]
                      for n, st in zip(names, core.precond)})


def _jax_forward(dtype) -> dict:
    """JAX apply_gpt2 / loss_gpt2 on the port model's parameters and the
    tokens: the logits, the gradients of sum(C logits) and their Hv
    (forward-over-reverse; float64), the loss and its gradients."""
    import jax
    import jax.numpy as jnp
    from psgd_torch_tpu.models import gpt2 as jgpt2
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    model = _model(dtype)
    tree = _nest({n: jnp.asarray(p.detach().numpy()) for n, p in model.named_parameters()})
    cfg = jgpt2.tiny_config(compute_dtype=jd, param_dtype=jd, **CFG)
    x, y = (jnp.asarray(t.numpy()) for t in _tokens())
    loss_grad = jax.value_and_grad(lambda p: jgpt2.loss_gpt2(p, x, y, cfg))
    if dtype != torch.float64:
        loss, grads = jax.jit(loss_grad)(tree)
        return dict(loss=float(loss), loss_grads=_flat(grads))
    c, vs = _probes(dtype)
    cj = jnp.asarray(c)

    def functional(p):
        return jnp.sum(jgpt2.apply_gpt2(p, x, cfg) * cj)

    @jax.jit           # one compile for every quantity
    def every(p, v):
        return (jgpt2.apply_gpt2(p, x, cfg), jax.jvp(jax.grad(functional), (p,), (v,)),
                loss_grad(p))
    vt = _nest({n: jnp.asarray(v) for n, v in vs.items()})
    logits, (grads, hv), (loss, lgrads) = every(tree, vt)
    return dict(logits=np.asarray(logits), grads=_flat(grads), hv=_flat(hv),
                loss=float(loss), loss_grads=_flat(lgrads))


def _references() -> dict:
    return {("stack", kind): _jax_stack(kind) for kind in ("W", "N")} | {
        ("forward", dt): _jax_forward(dt) for dt in (torch.float64, torch.float32)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    directory = tmp_path_factory.mktemp("tp")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        outs, refs = rank_results("test_torch_tp_sharding", WORLD, directory,
                                  _references)
        (directory / "two").mkdir()
        twos, _ = rank_results("test_torch_tp_sharding", 2, directory / "two", dict)
    for out, two in zip(outs, twos):      # ranks 0 and 1 of the 2-rank run
        out["two"] = two["two"]
    return outs, refs


def _close(got, want, rtol, what):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300),
                               err_msg=what)


def _block_of(whole, box):
    return whole[tuple(slice(a, b) for a, b in box)]


@pytest.mark.parametrize("kind", ["W", "N"])
def test_within_layer_stack_sharding_matches_jax(ranks, kind):
    """(1) whitening, (2) Newton: each rank's parameter blocks and Q and L
    (its layers of a resharded stack, the whole of a gathered one) against
    JAX stack_sharding over the same placements, rtol 1e-9."""
    outs, refs = ranks
    ref = refs[("stack", kind)]
    for rank, out in enumerate(outs):
        got = out[("jax", kind)]
        assert got["kinds"]["blocks.attn_qkv_w"] == "resharded"
        assert got["kinds"]["blocks.mlp_fc_b"] == "whole"
        assert got["kinds"]["wte"] == "whole"
        for n, (block, box) in got["params"].items():
            _close(block, _block_of(ref["params"][n], box), RTOL, (rank, n))
        for key in ("q", "lips"):
            for n, fs in got[key].items():
                cut = got["layers"][n]
                for f, g in zip(fs, ref[key][n]):
                    want = g if cut is None else g[cut[0]:cut[1]]
                    assert f.shape == want.shape, (rank, n)
                    _close(f, want, RTOL, (rank, n, key))


def test_tp_forward_gradients_and_hvp_match_jax(ranks):
    """(3) float64 compute: the logits, the gradients of sum(C logits) and
    their Hv at ``TP_RTOL``, each rank's blocks."""
    outs, refs = ranks
    ref = refs[("forward", torch.float64)]
    for rank, out in enumerate(outs):
        got = out["f64"]
        _close(got["logits"], ref["logits"], TP_RTOL, "logits")
        for key in ("grads", "hv"):
            for n, (block, box) in got[key].items():
                _close(block, _block_of(ref[key][n], box), TP_RTOL, (rank, key, n))


@pytest.mark.parametrize("dtype,rtol", [("f64", CE_RTOL), ("f32", F32_RTOL)])
def test_tp_loss_and_gradients_match_jax_loss(ranks, dtype, rtol):
    """(3) The vocab-parallel cross-entropy and its gradients against JAX
    ``loss_gpt2``'s: float64 compute at ``CE_RTOL`` (both over float32
    logits), float32 compute at ``F32_RTOL``; the loss the same on every
    rank."""
    outs, refs = ranks
    ref = refs[("forward", torch.float64 if dtype == "f64" else torch.float32)]
    assert len({out[dtype]["loss"] for out in outs}) == 1
    for rank, out in enumerate(outs):
        got = out[dtype]
        _close(got["loss"], ref["loss"], rtol, "loss")
        for n, (block, box) in got["loss_grads"].items():
            _close(block, _block_of(ref["loss_grads"][n], box), rtol, (rank, n))


@pytest.mark.parametrize("kind", ["W", "N"])
@pytest.mark.parametrize("axis", ["fsdp", ("fsdp", "tp")], ids=["fsdp", "fsdp_tp"])
def test_optimizer_alone_equals_one_rank(ranks, kind, axis):
    """(4) The within-layer layout against the unsharded optimizer on 1
    rank, fed the same gradients: every parameter block and Q and L row
    bit for bit; what the tp ranks hold alike, alike (drift 0.0); each
    rank's Q of a resharded stack its L/k layers."""
    k = 2 if axis == "fsdp" else 4
    for rank, out in enumerate(ranks[0]):
        got, one = out[(axis, kind)], out[(1, kind)]
        assert set(got["drift"].values()) == {0.0}
        assert sum(v == "resharded" for v in got["kinds"].values()) == 4
        for n, (block, box) in got["params"].items():
            assert np.array_equal(block, _block_of(one["params"][n][0], box)), (rank, n)
        for key in ("q", "lips"):
            for n, fs in got[key].items():
                cut = got["layers"][n]
                for f, g in zip(fs, one[key][n]):
                    want = g if cut is None else g[cut[0]:cut[1]]
                    assert np.array_equal(f, want), (rank, n, key)
                    if cut is not None:
                        assert f.shape[0] == CFG["n_layer"] // k


@pytest.mark.parametrize("axis", ["fsdp", ("fsdp", "tp")], ids=["fsdp", "fsdp_tp"])
def test_reshard_collective_bytes(ranks, axis):
    """(4) Each whitening step's collectives on each rank are the reshard's
    and the gathered leaves', their bytes exactly: per resharded stack
    the momentum's all-to-all and its tp all-gather (none when the stack
    axis is (fsdp, tp)), the update's all-to-all back; no gather of a
    whole update."""
    for out in ranks[0]:
        got = out[(axis, "W")]
        assert got["bytes"]["all-to-all"] > 0
        for step in got["calls"][1:]:     # the first gathers the init scale's
            assert step == got["bytes"], (step, got["bytes"])


def test_tp_one_is_the_plain_forward(ranks):
    """With tp 1 the sharded model's forward (its fsdp blocks gathered in
    it) is the plain one: the loss and every gradient block bit for bit."""
    for out in ranks[0]:
        r = out["tp_one"]
        assert r["loss"][0] == r["loss"][1]
        assert all(r["grads"].values()), r["grads"]


def test_tp_remat_equals_no_remat(ranks):
    """Remat at tp 2 (fsdp 2 x tp 2): the loss and every gradient block bit
    for bit the tensor-parallel forward's without remat."""
    for out in ranks[0]:
        r = out["remat"]
        assert r["loss"][0] == r["loss"][1]
        assert len(r["equal"]) == 16 and all(r["equal"]), r["equal"]


def test_what_still_raises(ranks):
    """A sharded layer dim raises NotImplementedError naming the
    placements; shard_model refuses a tp placement its forward does not
    take; the recipe's fsdp_kwargs refuses tp > 1 naming A8c and its
    model_placements are the map's; state_specs: Q of a resharded stack by
    layer over fsdp, replicated over tp; a diagonal stack's replicated."""
    r = ranks[0][0]["refusals"]
    assert r["layer_dim"].startswith("NotImplementedError")
    assert "Shard(dim=0)" in r["layer_dim"] and "layer dim" in r["layer_dim"]
    assert r["tp_layout"].startswith("ValueError") and "mlp_fc_w" in r["tp_layout"]
    assert r["fsdp2"].startswith("ValueError") and "ROADMAP A8c" in r["fsdp2"]
    assert r["model_placements"]["blocks.attn_qkv_w"] == \
        "(Replicate(), Shard(dim=1), Shard(dim=2))"
    specs = r["state_specs"]
    assert specs["blocks.attn_qkv_w"]["q"] == (
        "((Replicate(), Shard(dim=0), Replicate()), "
        "(Replicate(), Shard(dim=0), Replicate()))")
    assert specs["blocks.attn_qkv_w"]["mu"] == "(Replicate(), Shard(dim=1), Shard(dim=2))"
    assert specs["blocks.ln1_scale"]["q"] == "((Replicate(), Replicate(), Replicate()),)"


def test_trainer_resumes_across_world_sizes(ranks):
    """(5) The trainer on 4 ranks at (dp 1, fsdp 2, tp 2): finite losses;
    resumed on 4 ranks from its own files it equals the unbroken run bit
    for bit; gathered 4 -> 1, the 1-rank model restores the 4-rank
    blocks bit for bit and its step is the unbroken 4-rank step within
    RESUME_RTOL; the 1-rank checkpoint cut 1 -> 4 restores every block
    and each rank's optimizer state bit for bit."""
    outs = ranks[0]
    one = outs[0]["trainer"]
    for rank, out in enumerate(outs):
        t = out["trainer"]
        assert t["mesh"] == {"dcn": 1, "fsdp": 2, "tp": 2}
        assert t["kinds"].count("resharded") == 4 and t["kinds"].count("routed") == 2
        assert all(math.isfinite(x) for x in t["losses"])
        assert t["same"], rank
        assert t["files"]["a"] == ["state.pt"] + [f"state.rank{r}of4.pt" for r in range(4)]
        assert t["files"]["b"] == ["state.pt"]
        assert t["cut_step"] == 3
        for n, block in t["at_a"].items():
            assert torch.equal(block, one["one_at_a"][n][t["slices"][n]]), (rank, n)
        for n, block in t["unbroken"].items():
            want = one["one"][n][t["slices"][n]]
            _close(block.numpy(), want.numpy(), RESUME_RTOL, (rank, n))
        for n, block in t["cut"].items():
            assert torch.equal(block, one["one"][n][t["slices"][n]]), (rank, n)
        st, full = t["cut_state"], one["one_state"]
        for i, entry in st["state"].items():
            for key, val in entry.items():
                for j, x in enumerate(val if isinstance(val, (tuple, list)) else [val]):
                    ref = full["state"][i][key]
                    ref = ref[j] if isinstance(ref, (tuple, list)) else ref
                    piece = t["cut_pieces"].get(("state", i, key, j) if isinstance(
                        val, (tuple, list)) else ("state", i, key))
                    want = ref if piece is None else _block_of(ref, piece["index"])
                    assert torch.equal(x, want), (rank, i, key, j)
    assert abs(one["one_loss"] - outs[0]["trainer"]["losses"][2]) <= \
        RESUME_RTOL * abs(one["one_loss"])


def test_trainer_resumes_a_tp_checkpoint_on_two_ranks(ranks):
    """(5) The 4-rank checkpoint, gathered, resumed by the trainer on 2
    ranks at (dp 1, fsdp 2, tp 1), whose stacks are ``Shard(0)`` by layer:
    every block at the checkpoint, and the step's loss, bit for bit the
    1-rank resume's; after the step every block but the routed
    embeddings' bit for bit the 1-rank step's (k ranks at tp 1 equal 1),
    the embeddings within RESUME_RTOL."""
    one = ranks[0][0]["trainer"]
    for rank in (0, 1):
        t = ranks[0][rank]["two"]
        assert t["mesh"] == {"dcn": 1, "fsdp": 2, "tp": 1}
        assert t["step"] == 2 and sorted(t["routed"]) == ["wpe", "wte"]
        assert t["loss"] == one["one_loss"]
        for n, block in t["at"].items():
            assert torch.equal(block, one["one_at_a"][n][t["slices"][n]]), (rank, n)
        for n, block in t["after"].items():
            want = one["one"][n][t["slices"][n]]
            if n in t["routed"]:
                _close(block.numpy(), want.numpy(), RESUME_RTOL, (rank, n))
            else:
                assert torch.equal(block, want), (rank, n)
