"""LLaMA in JAX's production layout on the port, on the CPU with 4 gloo
ranks as test_torch_parallel.py describes (``rank_results``): a tiny LLaMA
(n_layer 4, n_head 4, n_embd 64, hidden 176, vocab 256, block 32) placed by
``llama_partition_specs`` on ``make_mesh``'s (dp 1, fsdp 2, tp 2), its
blocks sharded within their layers (``(None, fsdp, tp)``), by
``models.llama.shard_model``; at ``n_kv_head`` 1 (fewer kv heads than tp:
both ranks read the one kv head) and 2 (one each), tied and untied.

* (1) ``KronWhiten`` and ``KronNewton`` with ``stack_sharding`` over fsdp
  against JAX ``kron_whiten`` and ``kron_newton`` with
  ``stack_sharding=(mesh, "fsdp")`` on ``make_mesh(4)`` over JAX
  ``llama_partition_specs`` (JAX tests/test_llama.py:163-207), 3 steps in
  float64 with the JAX draws replayed, over ``JAX_LEAVES``: ``wqkv``
  (resharded, dense x dense), ``w_gu`` (resharded, dense x diag),
  ``rms1_scale`` (a diagonal stack, gathered whole) and the untied
  ``lm_head`` (gathered whole); both at kv 1, whitening at kv 2 too
  (``STACK_CASES``: each JAX configuration is some 10 s of tracing and
  compiling, and kv changes only wqkv's width).  The loss is
  test_torch_tp_sharding.py's quadratic sum(c p^2 / 2 + b p): parameters
  and every Q and L row at rtol 1e-9.
* (2) The tensor-parallel forward against JAX ``apply_llama`` and
  ``loss_llama`` on the same weights (``params_from_jax``'s layout) and
  tokens, in each of the four configurations.  The JAX model computes its
  RMSNorm, RoPE and logits in float32 whatever the compute dtype (the
  port's alike), so float64 compute holds them to float32's rounding:
  the logits, the gradients of sum(C logits) (C float32) and their
  Hessian-vector product (double backward through the tp collectives
  against JAX's forward-over-reverse) at ``TP_RTOL``; the vocab-parallel
  cross-entropy and its gradients at ``CE_RTOL`` in float64 and float32
  compute.  Every gap is relative to the largest entry of the JAX tensor.
* (3) The optimizer alone (the whole model, stack axis fsdp, whitening of
  the momentum with the on-the-fly init scale and the acting clip, and
  Newton with an acting norm clip) against the unsharded model's
  optimizer on 1 rank fed the same gradients: parameters and Q bit for
  bit, drift 0.0 over the tp replicas, each step's collective bytes the
  reshard's.
* (4) With tp 1 the sharded forward is the plain one, bit for bit; at tp 2
  remat (each block recomputed with its collectives) changes no bit.
* (5) The refusals: ``n_head``, ``hidden_dim`` or the vocab not a multiple
  of tp, a tp placement the forward does not take, FSDP2 at tp > 1; and
  the recipe's ``model_placements`` and ``state_specs``.
"""

import warnings

import numpy as np
import pytest
import torch

from test_torch_parallel import rank_results
from test_torch_tp_sharding import (_block_of, _box, _close, _error, _flat, _local,
                                    _nest, _reshard_bytes, _slices)

WORLD = 4
STEPS = 3
RTOL = 1e-9
# (2): float64 compute through the float32 RMSNorm, RoPE and logits, as
# test_torch_tp_sharding.py's GPT-2 (a wrong head, kv head or hidden block
# moves the logits by 1e-2 or more)
TP_RTOL = 5e-6
CE_RTOL = 5e-6
CFG = dict(n_layer=4, n_head=4, n_embd=64, hidden_dim=176, vocab_size=256,
           block_size=32)
# (kv heads, tied): kv < tp and kv = tp, each tied and untied
CONFIGS = ((1, False), (1, True), (2, False), (2, True))
JAX_LEAVES = ("blocks.wqkv", "blocks.w_gu", "blocks.rms1_scale", "lm_head")
STACK_CASES = (("W", 1), ("N", 1), ("W", 2))
OPTS = {"W": dict(lr=0.05, momentum=0.9, preconditioner_init_scale=1.0,
                  preconditioner_max_skew=2.0, grad_clip_max_amps=(1e3, 1e3)),
        "N": dict(lr=0.05, preconditioner_init_scale=1.0,
                  preconditioner_max_skew=2.0)}
ALONE = {"W": dict(whiten_grad=False, preconditioner_init_scale=None,
                   grad_clip_max_amps=(2.0, 10.0)),
         "N": dict(grad_clip_max_norm=0.5, preconditioner_init_scale=None)}


def _cfg(dtype, kv=1, tied=False, **kw):
    from psgd_torch_tpu_torch.models import llama
    return llama.tiny_llama_config(compute_dtype=dtype, param_dtype=dtype,
                                   n_kv_head=kv, tie_embeddings=tied,
                                   **dict(CFG, **kw))


def _model(dtype, mesh=None, kv=1, tied=False, **kw):
    from psgd_torch_tpu_torch.models import llama
    model = llama.Llama(_cfg(dtype, kv, tied, **kw), device="cpu", seed=0)
    return model if mesh is None else llama.shard_model(model, mesh)


def _tokens():
    from psgd_torch_tpu_torch.models import llama
    return llama.synthetic_lm_batch(torch.Generator().manual_seed(1), 2,
                                    CFG["block_size"], CFG["vocab_size"],
                                    device="cpu")


def _problem(kv):
    """(initial values, c, b) per parameter name, float64, from seed 0."""
    model = _model(torch.float64, kv=kv)
    rng = np.random.default_rng(0)
    init, c, b = {}, {}, {}
    for name, p in sorted(model.named_parameters()):
        init[name] = p.detach().numpy().copy()
        c[name] = 10.0 ** rng.uniform(-1, 1, p.shape)
        b[name] = rng.standard_normal(p.shape)
    return init, c, b


def _probes(kv, tied):
    """(C over the logits, float32 values; v per parameter) from seed 2."""
    rng = np.random.default_rng(2)
    c = rng.standard_normal((2, CFG["block_size"], CFG["vocab_size"])).astype(np.float32)
    model = _model(torch.float64, kv=kv, tied=tied)
    vs = {n: rng.standard_normal(p.shape) for n, p in sorted(model.named_parameters())}
    return c, vs


# ---------------------------------------------------------------------------
# rank side: no JAX
# ---------------------------------------------------------------------------


def port_run(kind, mesh, axis, draw, kv=1, options=None, leaves=None) -> dict:
    """The port on the quadratic problem, STEPS steps (test_torch_tp_sharding
    .py's ``port_run`` over the untied LLaMA with ``kv`` kv heads)."""
    from torch.distributed.tensor import DTensor
    from psgd_torch_tpu_torch.models import llama
    from psgd_torch_tpu_torch.optim import KronNewton, KronWhiten
    from psgd_torch_tpu_torch.utils import collective_bytes, count_collectives
    model = _model(torch.float64, mesh, kv=kv)
    init, c, b = _problem(kv)
    params = {n: p for n, p in model.named_parameters()
              if leaves is None or n in leaves}
    cs = {n: torch.from_numpy(c[n][_slices(p)].copy()) for n, p in params.items()}
    bs = {n: torch.from_numpy(b[n][_slices(p)].copy()) for n, p in params.items()}
    kw = dict(OPTS[kind], **(options or {}))
    mask = llama.scanned_layers_mask(model)
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
        alike = {}
        for i, n in enumerate(order):
            st = opt.state[opt.param_groups[0]["params"][i]]
            for j, f in enumerate(st["q"] + st["lips"]):
                alike[f"{n} Q/L {j}"] = f
        out["drift"] = drift_check(alike, group=mesh.get_group("tp"))
        out["bytes"] = _reshard_bytes(opt) if kind == "W" else None
    return out


def tp_forward(mesh, dtype, kv, tied) -> dict:
    """The tensor-parallel forward on the tokens: the logits (gathered
    whole), the gradients of sum(C logits) and their Hv (float64 only),
    the loss and its gradients, each parameter's block."""
    from torch.distributed.tensor import DTensor
    from psgd_torch_tpu_torch.models import llama
    from psgd_torch_tpu_torch.optim import hvp
    model = _model(dtype, mesh, kv, tied)
    x, y = _tokens()
    params = dict(sorted(model.named_parameters()))
    names, ps = list(params), list(params.values())

    def blocks(gs):
        return {n: (g.to_local().detach().numpy().copy(), _box(p))
                for n, p, g in zip(names, ps, gs)}

    out = {}
    if dtype == torch.float64:
        c, vs = _probes(kv, tied)
        ct = torch.from_numpy(c)
        out["logits"] = model(x).detach().numpy().copy()

        def functional():
            return torch.sum(model(x) * ct)
        v = [DTensor.from_local(torch.from_numpy(vs[n][_slices(p)].copy()),
                                p.device_mesh, p.placements, run_check=False)
             for n, p in params.items()]
        grads, hvs = hvp.hvp_exact(functional, ps, v)
        out["grads"], out["hv"] = blocks(grads), blocks(hvs)
    loss = llama.loss_llama(model, x, y)
    out["loss"] = loss.item()
    out["loss_grads"] = blocks(torch.autograd.grad(loss, ps))
    return out


def _loss_and_grads(model):
    from psgd_torch_tpu_torch.models import llama
    x, y = _tokens()
    loss = llama.loss_llama(model, x, y)
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return loss.item(), {n: _local(g) for (n, _), g in zip(model.named_parameters(), grads)}


def tp_one() -> dict:
    """The sharded forward on a mesh whose tp dim is 1 ((fsdp 4, tp 1):
    every fsdp block gathered in the forward) against the plain model,
    untied at kv 1 and tied at kv 2: the loss and each parameter's
    gradient block, bit for bit."""
    from psgd_torch_tpu_torch.parallel import make_mesh
    mesh = make_mesh(axis_names=("fsdp", "tp"), axis_sizes=(4, 1), device_type="cpu")
    out = {}
    for kv, tied in ((1, False), (2, True)):
        sharded = _model(torch.float32, mesh, kv, tied)
        (ls, gs), (lp, gp) = (_loss_and_grads(m) for m in
                              (sharded, _model(torch.float32, kv=kv, tied=tied)))
        slices = {n: _slices(p) for n, p in sharded.named_parameters()}
        out[(kv, tied)] = dict(loss=(ls, lp), grads={
            n: torch.equal(g, gp[n][slices[n]]) for n, g in gs.items()})
    return out


def tp_remat(mesh) -> dict:
    """The tensor-parallel forward with remat (each block, its tp
    collectives included, recomputed in the backward) against the same
    without, untied at kv 1: the loss and each gradient block (float32)."""
    (l0, g0), (l1, g1) = (_loss_and_grads(_model(torch.float32, mesh, remat=r))
                          for r in (False, True))
    return dict(loss=(l0, l1), equal=[torch.equal(g0[n], g1[n]) for n in g0])


def refusals(mesh) -> dict:
    """What raises: a dim the tp forward cannot split, a tp placement it
    does not take, FSDP2 at tp > 1; and the recipe's placements and state
    specs over LLaMA's within-layer blocks."""
    from psgd_torch_tpu_torch.models import llama
    from psgd_torch_tpu_torch.optim import KronWhiten
    from psgd_torch_tpu_torch.parallel import llama_partition_specs, sharding_recipe
    out = {dim: _error(lambda kw=kw: _model(torch.float32, mesh, **kw))
           for dim, kw in (("n_head", dict(n_head=3, n_embd=48)),
                           ("hidden_dim", dict(hidden_dim=175)),
                           ("vocab_size", dict(vocab_size=255)))}
    specs = llama_partition_specs(mesh, _model(torch.float32))
    specs["blocks.w_gu"] = specs["blocks.w_down"]
    out["tp_layout"] = _error(lambda: llama.shard_model(_model(torch.float32), mesh,
                                                        specs))
    model = _model(torch.float32)
    rec = sharding_recipe(mesh, llama_partition_specs(mesh, model),
                          model.named_parameters(),
                          scanned_layers=llama.scanned_layers_mask(model))
    out["fsdp2"] = _error(lambda: rec.fsdp_kwargs(model))
    out["model_placements"] = {n: repr(v) for n, v in rec.model_placements().items()}
    llama.shard_model(model, mesh, rec.model_placements())
    opt = KronWhiten(model.named_parameters(), device="cpu", momentum=0.9,
                     preconditioner_init_scale=1.0, preconditioner_max_skew=2.0,
                     **rec.transform_kwargs)
    specs = rec.state_specs(opt)
    out["routed"] = rec.routed()
    out["state_specs"] = {n: {k: repr(v) for k, v in specs[n].items()}
                          for n in ("blocks.wqkv", "blocks.w_gu", "blocks.rms1_scale")}
    return out


_OWN = {}      # the cases that take no JAX draw, run in the recording pass


def run_cases(rank, world, draw, record, directory) -> dict:
    """The JAX-replay cases (with the recording hook first), and in the
    recording pass, while the parent compiles the JAX references, every
    other case."""
    from psgd_torch_tpu_torch.parallel import make_mesh
    mesh = make_mesh(device_type="cpu")
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for kind, kv in STACK_CASES:
            out[("jax", kind, kv)] = port_run(kind, mesh, "fsdp", draw, kv,
                                              leaves=JAX_LEAVES)
        if not record:
            return {**_OWN, **out}
        for kind in ("W", "N"):
            _OWN[(1, kind)] = port_run(kind, None, None, None, options=ALONE[kind])
            _OWN[("fsdp", kind)] = port_run(kind, mesh, "fsdp", None,
                                            options=ALONE[kind])
        for kv, tied in CONFIGS:
            for dt, name in ((torch.float64, "f64"), (torch.float32, "f32")):
                _OWN[(name, kv, tied)] = tp_forward(mesh, dt, kv, tied)
        _OWN["tp_one"] = tp_one()
        _OWN["remat"] = tp_remat(mesh)
        _OWN["refusals"] = refusals(mesh)
    return out


# ---------------------------------------------------------------------------
# parent side: the JAX references, while the ranks run
# ---------------------------------------------------------------------------


def _jax_stack(kind, kv) -> dict:
    """JAX kron_whiten / kron_newton with stack_sharding over fsdp on
    make_mesh(4), the parameters placed by llama_partition_specs, on the
    quadratic problem: (parameters, Q and L per leaf) after STEPS steps."""
    import jax
    import jax.numpy as jnp
    import optax
    import psgd_torch_tpu.optim as jopt
    from psgd_torch_tpu.optim.hvp import make_hvp_fn
    from psgd_torch_tpu.parallel import (llama_partition_specs, make_mesh,
                                         named_shardings, psgd_state_specs)
    params, cj, bj = (_nest({n: jnp.asarray(v) for n, v in x.items() if n in JAX_LEAVES})
                      for x in _problem(kv))
    mesh = make_mesh(4)
    mask = {"blocks": {k: True for k in params["blocks"]}, "lm_head": False}
    kw = dict(OPTS[kind])
    kw["learning_rate"] = kw.pop("lr")
    factory = jopt.kron_whiten if kind == "W" else jopt.kron_newton
    opt = factory(scanned_layers=mask, stack_sharding=(mesh, "fsdp"), **kw)
    state = opt.init(params)
    every = llama_partition_specs(params)
    p_specs = {"blocks": {k: every["blocks"][k] for k in params["blocks"]},
               "lm_head": every["lm_head"]}
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


def _jax_forward(dtype, kv, tied) -> dict:
    """JAX apply_llama / loss_llama on the port model's parameters and the
    tokens: the logits, the gradients of sum(C logits) and their Hv
    (forward-over-reverse; float64), the loss and its gradients."""
    import jax
    import jax.numpy as jnp
    from psgd_torch_tpu.models import llama as jllama
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    model = _model(dtype, kv=kv, tied=tied)
    tree = _nest({n: jnp.asarray(p.detach().numpy()) for n, p in model.named_parameters()})
    cfg = jllama.tiny_llama_config(compute_dtype=jd, param_dtype=jd, n_kv_head=kv,
                                   tie_embeddings=tied, **CFG)
    x, y = (jnp.asarray(t.numpy()) for t in _tokens())
    loss_grad = jax.value_and_grad(lambda p: jllama.loss_llama(p, x, y, cfg))
    if dtype != torch.float64:
        loss, grads = jax.jit(loss_grad)(tree)
        return dict(loss=float(loss), loss_grads=_flat(grads))
    c, vs = _probes(kv, tied)
    cj = jnp.asarray(c)

    def functional(p):
        return jnp.sum(jllama.apply_llama(p, x, cfg) * cj)

    @jax.jit           # one compile for every quantity
    def every(p, v):
        return (jllama.apply_llama(p, x, cfg),
                jax.jvp(jax.grad(functional), (p,), (v,)), loss_grad(p))
    vt = _nest({n: jnp.asarray(v) for n, v in vs.items()})
    logits, (grads, hv), (loss, lgrads) = every(tree, vt)
    return dict(logits=np.asarray(logits), grads=_flat(grads), hv=_flat(hv),
                loss=float(loss), loss_grads=_flat(lgrads))


def _references() -> dict:
    refs = {("stack", kind, kv): _jax_stack(kind, kv) for kind, kv in STACK_CASES}
    for kv, tied in CONFIGS:
        for dt, name in ((torch.float64, "f64"), (torch.float32, "f32")):
            refs[(name, kv, tied)] = _jax_forward(dt, kv, tied)
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return rank_results("test_torch_llama_tp", WORLD,
                            tmp_path_factory.mktemp("llama_tp"), _references)


@pytest.mark.parametrize("kind,kv", STACK_CASES, ids=[f"{k}-kv{kv}" for k, kv in STACK_CASES])
def test_within_layer_stack_sharding_matches_jax(ranks, kind, kv):
    """(1) whitening, Newton: each rank's parameter blocks and Q and L (its
    layers of a resharded stack, the whole of a gathered one) against JAX
    stack_sharding over llama_partition_specs, rtol 1e-9."""
    outs, refs = ranks
    ref = refs[("stack", kind, kv)]
    for rank, out in enumerate(outs):
        got = out[("jax", kind, kv)]
        assert got["kinds"] == {"blocks.wqkv": "resharded", "blocks.w_gu": "resharded",
                                "blocks.rms1_scale": "whole", "lm_head": "whole"}
        for n, (block, box) in got["params"].items():
            _close(block, _block_of(ref["params"][n], box), RTOL, (rank, n))
        for key in ("q", "lips"):
            for n, fs in got[key].items():
                cut = got["layers"][n]
                for f, g in zip(fs, ref[key][n]):
                    want = g if cut is None else g[cut[0]:cut[1]]
                    assert f.shape == want.shape, (rank, n)
                    _close(f, want, RTOL, (rank, n, key))


@pytest.mark.parametrize("kv,tied", CONFIGS, ids=[f"kv{kv}-{'tied' if t else 'untied'}"
                                                  for kv, t in CONFIGS])
def test_tp_forward_gradients_and_hvp_match_jax(ranks, kv, tied):
    """(2) float64 compute: the logits, the gradients of sum(C logits) and
    their Hv at ``TP_RTOL``, each rank's blocks."""
    outs, refs = ranks
    ref = refs[("f64", kv, tied)]
    for rank, out in enumerate(outs):
        got = out[("f64", kv, tied)]
        _close(got["logits"], ref["logits"], TP_RTOL, "logits")
        for key in ("grads", "hv"):
            assert sorted(got[key]) == sorted(ref[key])
            for n, (block, box) in got[key].items():
                _close(block, _block_of(ref[key][n], box), TP_RTOL, (rank, key, n))


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("kv,tied", CONFIGS, ids=[f"kv{kv}-{'tied' if t else 'untied'}"
                                                  for kv, t in CONFIGS])
def test_tp_loss_and_gradients_match_jax_loss(ranks, kv, tied, dtype):
    """(2) The vocab-parallel cross-entropy and its gradients against JAX
    ``loss_llama``'s at ``CE_RTOL``, in float64 and float32 compute; the
    loss the same on every rank."""
    outs, refs = ranks
    ref = refs[(dtype, kv, tied)]
    assert len({out[(dtype, kv, tied)]["loss"] for out in outs}) == 1
    for rank, out in enumerate(outs):
        got = out[(dtype, kv, tied)]
        _close(got["loss"], ref["loss"], CE_RTOL, "loss")
        for n, (block, box) in got["loss_grads"].items():
            _close(block, _block_of(ref["loss_grads"][n], box), CE_RTOL, (rank, n))


@pytest.mark.parametrize("kind", ["W", "N"])
def test_optimizer_alone_equals_one_rank(ranks, kind):
    """(3) The within-layer layout against the unsharded optimizer on 1
    rank, fed the same gradients: every parameter block and Q and L row
    bit for bit; what the tp ranks hold alike, alike (drift 0.0); each
    rank's Q of a resharded stack its L/2 layers, the four matrix stacks
    resharded."""
    for rank, out in enumerate(ranks[0]):
        got, one = out[("fsdp", kind)], out[(1, kind)]
        assert set(got["drift"].values()) == {0.0}
        assert sorted(n for n, v in got["kinds"].items() if v == "resharded") == \
            ["blocks.w_down", "blocks.w_gu", "blocks.wo", "blocks.wqkv"]
        for n, (block, box) in got["params"].items():
            assert np.array_equal(block, _block_of(one["params"][n][0], box)), (rank, n)
        for key in ("q", "lips"):
            for n, fs in got[key].items():
                cut = got["layers"][n]
                for f, g in zip(fs, one[key][n]):
                    want = g if cut is None else g[cut[0]:cut[1]]
                    assert np.array_equal(f, want), (rank, n, key)
                    if cut is not None:
                        assert f.shape[0] == CFG["n_layer"] // 2


def test_reshard_collective_bytes(ranks):
    """(3) Each whitening step's collectives on each rank are the reshard's
    and the gathered leaves', their bytes exactly."""
    for out in ranks[0]:
        got = out[("fsdp", "W")]
        assert got["bytes"]["all-to-all"] > 0 and got["bytes"]["all-gather"] > 0
        for step in got["calls"][1:]:     # the first gathers the init scale's
            assert step == got["bytes"], (step, got["bytes"])


def test_tp_one_is_the_plain_forward(ranks):
    """(4) With tp 1 the sharded model's forward (its fsdp blocks gathered
    in it) is the plain one: the loss and every gradient block bit for
    bit, untied and tied."""
    for out in ranks[0]:
        for r in out["tp_one"].values():
            assert r["loss"][0] == r["loss"][1]
            assert all(r["grads"].values()), r["grads"]


def test_tp_remat_equals_no_remat(ranks):
    """(4) Remat at tp 2: the loss and every gradient block bit for bit the
    tensor-parallel forward's without remat."""
    for out in ranks[0]:
        r = out["remat"]
        assert r["loss"][0] == r["loss"][1]
        assert len(r["equal"]) == 9 and all(r["equal"]), r["equal"]


def test_what_raises_and_the_recipe(ranks):
    """(5) shard_model refuses n_head, hidden_dim and vocab_size that tp 2
    does not divide, naming each, and a tp placement its forward does not
    take; the recipe's fsdp_kwargs refuses tp > 1 naming both models'
    shard_model and A8c; its model_placements are the map's, wte and
    lm_head routed; state_specs: Q of a resharded stack (dense x dense,
    dense x diag) by layer over fsdp, replicated over tp; a diagonal
    stack's replicated."""
    r = ranks[0][0]["refusals"]
    for dim in ("n_head", "hidden_dim", "vocab_size"):
        assert r[dim].startswith("ValueError") and dim in r[dim], r[dim]
    assert r["tp_layout"].startswith("ValueError") and "w_gu" in r["tp_layout"]
    assert r["fsdp2"].startswith("ValueError") and "ROADMAP A8c" in r["fsdp2"]
    assert "gpt2.shard_model" in r["fsdp2"] and "llama.shard_model" in r["fsdp2"]
    assert r["model_placements"]["blocks.w_gu"] == "(Replicate(), Shard(dim=1), Shard(dim=2))"
    assert r["model_placements"]["lm_head"] == "(Replicate(), Shard(dim=0), Shard(dim=1))"
    assert sorted(r["routed"]) == ["lm_head", "wte"]
    specs = r["state_specs"]
    by_layer = "(Replicate(), Shard(dim=0), Replicate())"
    assert specs["blocks.wqkv"]["q"] == f"({by_layer}, {by_layer})"
    assert specs["blocks.w_gu"]["q"] == f"({by_layer}, {by_layer})"
    assert specs["blocks.w_gu"]["mu"] == "(Replicate(), Shard(dim=1), Shard(dim=2))"
    assert specs["blocks.rms1_scale"]["q"] == "((Replicate(), Replicate(), Replicate()),)"


@pytest.mark.parametrize("cls", ["KronWhiten", "KronNewton"])
def test_one_layer_stack_state_is_contiguous(cls):
    """A stack the optimizer fits at one layer (a rank's share of LLaMA's
    2-layer stacks over fsdp 2): its Q and L are contiguous copies, not the
    init's expanded views (stride 0, whose bytes no collective can view;
    the card's kernels allocate each new L like the last), and their bytes
    view as every collective takes them."""
    from psgd_torch_tpu_torch import optim
    from psgd_torch_tpu_torch.parallel.mesh import _bytes
    p = torch.nn.Parameter(torch.randn(1, 8, 12))
    opt = getattr(optim, cls)([("blocks.w", p)], scanned_layers={"blocks.w": True},
                              device="cpu", preconditioner_init_scale=1.0,
                              preconditioner_max_skew=2.0)
    st = opt.state[opt.param_groups[0]["params"][0]]
    for x in st["q"] + st["lips"]:
        assert x.shape[0] == 1 and x.stride()[-1] == 1, (x.shape, x.stride())
        assert _bytes(x).numel() == x.numel() * x.element_size()


@pytest.mark.parametrize("h,kv,tp", [(4, 1, 2), (4, 2, 2), (32, 4, 2), (6, 3, 2),
                                     (12, 4, 3), (8, 8, 4), (8, 2, 4)])
def test_each_query_head_reads_its_kv_head(h, kv, tp):
    """``llama._heads`` on every rank: the query heads [r h/tp, (r+1) h/tp)
    and kv heads that ``attention`` (GQA's grouping of its heads over the
    kv heads given) pairs so that query head j reads kv head j // (h / kv),
    as the unsharded model's attention does; one slice of kv heads where
    the grouping allows it, one kv head per query head where it does not
    ((6, 3, 2): rank 0's heads 0-2 read kv heads 0, 0, 1; (12, 4, 3): rank
    0's heads 0-3 read 0, 0, 0, 1); all h heads over the tp ranks."""
    from psgd_torch_tpu_torch.models import llama
    seen, slices = [], []
    for r in range(tp):
        qh, kvh = llama._heads(h, kv, tp, r)
        q = list(range(h))[qh]
        k = list(range(kv))[kvh] if isinstance(kvh, slice) else kvh
        assert len(q) % len(k) == 0
        group = len(q) // len(k)
        assert [k[i // group] for i in range(len(q))] == [j // (h // kv) for j in q]
        seen += q
        slices.append(isinstance(kvh, slice))
    assert seen == list(range(h))
    assert all(slices) == ((h, kv, tp) not in ((6, 3, 2), (12, 4, 3)))
