"""The port's ``sharding_recipe`` and ``psgd_state_specs`` against the JAX
package's (psgd_torch_tpu/parallel/recipe.py, mesh.py:206-355), case for
case with tests/test_recipe.py and the state-spec cases of
tests/test_parallel.py, the JAX PartitionSpecs translated to DTensor
placements.

Both are host code over a mesh's names and sizes, so the port's meshes
live in this process on torch's fake process group of 8 ranks (no
collective runs; this process is rank 0), beside the 8 CPU devices
conftest.py gives JAX.  The tiny GPT-2 is JAX's (n_layer 4, n_embd 16,
vocab 64) on both sides.
"""


import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as PS

WORLD = 8


@pytest.fixture(scope="module", autouse=True)
def fake_world():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=WORLD)
    yield
    dist.destroy_process_group()


def _meshes(axis_names=("dp", "fsdp", "tp"), axis_sizes=None):
    """(the JAX mesh, the port's) over 8 devices / ranks."""
    from psgd_torch_tpu.parallel import make_mesh as jax_mesh
    from psgd_torch_tpu_torch.parallel import make_mesh
    return (jax_mesh(WORLD, axis_names=axis_names, axis_sizes=axis_sizes),
            make_mesh(axis_names=axis_names, axis_sizes=axis_sizes,
                      device_type="cpu"))


def _gpt2(n_layer=4):
    """(JAX params, port model, port mask) of the tiny GPT-2."""
    from psgd_torch_tpu.models import gpt2 as jgpt2
    from psgd_torch_tpu_torch.models import gpt2
    jcfg = jgpt2.tiny_config(n_layer=n_layer, n_head=2, n_embd=16, block_size=8,
                             vocab_size=64, compute_dtype=jnp.float32)
    cfg = gpt2.tiny_config(n_layer=n_layer, n_head=2, n_embd=16, block_size=8,
                           vocab_size=64, compute_dtype=torch.float32)
    model = gpt2.GPT2(cfg, device="cpu", seed=0)
    return (jgpt2.init_gpt2(jax.random.key(1), jcfg), model,
            gpt2.scanned_layers_mask(model))


def _translate(spec, mesh_names):
    """A PartitionSpec as DTensor placements on a mesh with these dims."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh_names)
    for d, entry in enumerate(tuple(spec)):
        for ax in (() if entry is None else (entry,) if isinstance(entry, str)
                   else entry):
            out[mesh_names.index(ax)] = Shard(d)
    return tuple(out)


def _jax_specs(specs, params, mesh_names) -> dict:
    """The JAX state specs per dotted name, as the port returns them."""
    from psgd_torch_tpu.optim.transforms import PSGDState
    core = [s for s in specs if isinstance(s, PSGDState)][0]
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    names = [".".join(p.key for p in path) for path, _ in flat]
    mus = (jax.tree_util.tree_leaves(core.mu, is_leaf=lambda x: isinstance(x, PS))
           if core.mu is not None else [None] * len(names))

    def tr(x):
        return tuple(_translate(s, mesh_names) for s in x)

    return {n: {"mu": None if m is None else _translate(m, mesh_names),
                "q": tr(ks.q), "lips": tr(ks.lips),
                "pcache": None if core.pcache is None else tr(core.pcache[i])}
            for i, (n, m, ks) in enumerate(zip(names, mus, core.precond))}


def _port_opt(model, mask, **kw):
    from psgd_torch_tpu_torch.optim import KronWhiten
    named = kw.pop("named", None) or model.named_parameters()
    return KronWhiten(named, lr=1e-3, preconditioner_init_scale=1.0,
                      device="cpu", **kw)


def _jax_state(params, **kw):
    import psgd_torch_tpu.optim as popt
    return popt.kron_whiten(learning_rate=1e-3, preconditioner_init_scale=1.0,
                            **kw).init(params)


def _nested(mask):
    out = {"blocks": {}}
    for n, v in mask.items():
        if n.startswith("blocks."):
            out["blocks"][n.split(".", 1)[1]] = v
        else:
            out[n] = v
    return out


def test_recipe_matches_manual_configuration():
    """JAX test_recipe_matches_manual_configuration: the recipe resolves
    fsdp (the largest axis dividing 4 layers) and turns the embeddings'
    path on; its state specs equal the hand-wired psgd_state_specs and
    JAX's, translated."""
    from psgd_torch_tpu.parallel import (gpt2_partition_specs as jspecs,
                                         psgd_state_specs as jstate_specs)
    from psgd_torch_tpu_torch.parallel import (gpt2_partition_specs,
                                               psgd_state_specs, sharding_recipe)
    jmesh, mesh = _meshes()
    jparams, model, mask = _gpt2()
    pl = gpt2_partition_specs(mesh)
    rec = sharding_recipe(mesh, pl, model.named_parameters(), scanned_layers=mask)
    assert rec.stack_axis == "fsdp" and rec.factor_sharded
    kw = rec.transform_kwargs
    assert kw["stack_sharding"] == (mesh, "fsdp")
    assert kw["factor_sharding"] == (mesh, pl)
    assert kw["scanned_layers"] is mask and kw["dq"] == "Q0.5EQ1.5"
    opt = _port_opt(model, mask, named=rec.place(model.named_parameters()), **kw)
    manual = psgd_state_specs(pl, opt, scanned_layers=mask, stack_axis="fsdp",
                              factor_sharding_params=dict(model.named_parameters()),
                              mesh=mesh)
    got = rec.state_specs(opt)
    assert got == manual
    jp = jspecs()
    jmask = _nested(mask)
    jstate = _jax_state(jparams, scanned_layers=jmask,
                        stack_sharding=(jmesh, "fsdp"), factor_sharding=(jmesh, jp))
    want = _jax_specs(jstate_specs(jp, jstate, scanned_layers=jmask,
                                   stack_axis="fsdp",
                                   factor_sharding_params=jparams, mesh=jmesh),
                      jparams, tuple(mesh.mesh_dim_names))
    assert got == want


def test_auto_stack_axis_falls_back_with_warning():
    from psgd_torch_tpu_torch.parallel import gpt2_partition_specs, sharding_recipe
    _, mesh = _meshes()
    _, model, mask = _gpt2(n_layer=3)
    with pytest.warns(UserWarning, match="stack sharding disabled"):
        rec = sharding_recipe(mesh, gpt2_partition_specs(mesh),
                              model.named_parameters(), scanned_layers=mask)
    assert rec.stack_axis is None
    assert "stack_sharding" not in rec.transform_kwargs


def test_explicit_indivisible_axis_raises():
    from psgd_torch_tpu_torch.parallel import gpt2_partition_specs, sharding_recipe
    _, mesh = _meshes()
    _, model, mask = _gpt2(n_layer=3)
    with pytest.raises(ValueError, match="does not divide"):
        sharding_recipe(mesh, gpt2_partition_specs(mesh), model.named_parameters(),
                        scanned_layers=mask, stack_axis="fsdp")


def test_unknown_axis_raises():
    from psgd_torch_tpu_torch.parallel import gpt2_partition_specs, sharding_recipe
    _, mesh = _meshes()
    _, model, mask = _gpt2()
    with pytest.raises(ValueError, match="not in mesh axes"):
        sharding_recipe(mesh, gpt2_partition_specs(mesh), model.named_parameters(),
                        scanned_layers=mask, stack_axis="nope")


def test_non_shardable_dq_keeps_embedding_state_replicated():
    """dq="EQ": no dim-sharded path, so the recipe routes nothing and wte's
    Q stays replicated."""
    from torch.distributed.tensor import Replicate
    from psgd_torch_tpu_torch.parallel import gpt2_partition_specs, sharding_recipe
    _, mesh = _meshes()
    _, model, mask = _gpt2()
    rec = sharding_recipe(mesh, gpt2_partition_specs(mesh), model.named_parameters(),
                          scanned_layers=mask, dq="EQ")
    assert not rec.factor_sharded and rec.routed() == []
    assert "factor_sharding" not in rec.transform_kwargs
    opt = _port_opt(model, mask, **rec.transform_kwargs)
    wte_q = rec.state_specs(opt)["wte"]["q"]
    assert all(s == (Replicate(),) * 3 for s in wte_q)


@pytest.mark.parametrize("dq", ["Q0.5EQ1.5", "QUAD", "QEQ", "EQ"])
def test_recipe_optimizer_and_state_specs_route_alike(dq):
    """One rule (``parallel.mesh.routed_axes``) picks the routed leaves:
    the recipe's are the optimizer's, and psgd_state_specs shards exactly
    the diagonal factors the optimizer holds in blocks (none for EQ)."""
    from torch.distributed.tensor import Replicate
    from psgd_torch_tpu_torch.parallel import gpt2_partition_specs, sharding_recipe
    _, mesh = _meshes()
    _, model, mask = _gpt2()
    rec = sharding_recipe(mesh, gpt2_partition_specs(mesh), model.named_parameters(),
                          scanned_layers=mask, dq=dq)
    opt = _port_opt(model, mask, named=rec.place(model.named_parameters()),
                    **rec.transform_kwargs)
    names = sorted(mask, key=lambda n: tuple(n.split(".")))
    routed = [n for n, r in zip(names, opt.routed) if r is not None]
    assert sorted(rec.routed()) == sorted(routed)
    assert bool(routed) == (dq != "EQ")
    specs, rep = rec.state_specs(opt), (Replicate(),) * 3
    for n, p, r in zip(names, opt.param_groups[0]["params"], opt.routed):
        sharded = [s != rep for s in specs[n]["q"]]
        if r is None:
            assert mask[n] or not any(sharded), n
        else:
            assert sharded == [f.ndim == 1 and bool(axes) for f, axes in
                               zip(opt.state[p]["q"], r.rplan[0])], n


def test_mismatched_trees_raise():
    from torch.distributed.tensor import Replicate
    from psgd_torch_tpu_torch.parallel import sharding_recipe
    _, mesh = _meshes()
    _, model, mask = _gpt2()
    with pytest.raises(ValueError, match="must match leaf-for-leaf"):
        sharding_recipe(mesh, {"only": (Replicate(),) * 3}, model.named_parameters(),
                        scanned_layers=mask)


# state-spec cases of tests/test_parallel.py: (mesh names, sizes, stack axis,
# factor-sharded, the embedding-only tree, optimizer options)
SPEC_CASES = {
    "stack_fsdp": (("dp", "fsdp", "tp"), None, "fsdp", False, False, {}),
    "stack_tuple_axis": (("dp", "fsdp", "tp"), None, ("fsdp", "tp"), False, False, {}),
    "production": (("dp", "fsdp", "tp"), None, "fsdp", True, False,
                   dict(momentum=0.9)),
    "production_cache_shared": (("dp", "fsdp", "tp"), None, "fsdp", True, False,
                                dict(cache_p=True, shared_layers={
                                    "blocks.mlp_fc_w": True})),
    "wte_tp_fsdp": (("dp", "fsdp", "tp"), None, None, True, True,
                    dict(preconditioner_max_skew=2.0)),
    "fsdp_8": (("fsdp",), None, None, True, True, {}),
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_state_specs_match_jax(case):
    """psgd_state_specs equals JAX's, translated: momentum follows the
    parameter, stacked Q and L Shard(0) over the stack axis, the routed
    diagonal factors over the reshard plan's axes (wte's over (tp, fsdp)),
    pooled leaves and the rest replicated."""
    from psgd_torch_tpu.parallel import (gpt2_partition_specs as jspecs,
                                         psgd_state_specs as jstate_specs)
    from psgd_torch_tpu_torch.parallel import gpt2_partition_specs, psgd_state_specs
    names, sizes, stack, factor, emb_only, options = SPEC_CASES[case]
    jmesh, mesh = _meshes(names, sizes)
    jparams, model, mask = _gpt2()
    pl, jp = gpt2_partition_specs(mesh), jspecs()
    named = dict(model.named_parameters())
    if emb_only:
        keep = ("wte",)
        pl, jp = {"wte": pl["wte"]}, {"wte": jp["wte"]}
        named, jparams = {"wte": named["wte"]}, {"wte": jparams["wte"]}
        mask = {"wte": False}
        if "tp" not in names:
            jp = {"wte": PS(None, "fsdp")}
    else:
        keep = None
    jmask = _nested(mask) if keep is None else mask
    shared = options.get("shared_layers")
    jkw = dict(options, scanned_layers=jmask)
    if shared:
        jkw["shared_layers"] = _nested({n: shared.get(n, False) for n in mask})
    jstate = _jax_state(jparams, **jkw)
    jskw = dict(scanned_layers=jmask, stack_axis=stack,
                shared_layers=jkw.get("shared_layers"))
    if factor:
        jskw.update(factor_sharding_params=jparams, mesh=jmesh)
    want = _jax_specs(jstate_specs(jp, jstate, **jskw), jparams,
                      tuple(mesh.mesh_dim_names))
    opt = _port_opt(model, mask, named=list(named.items()), scanned_layers=mask,
                    **options)
    # the port names the stack axis's mesh dim: it takes mesh= throughout
    kw = dict(scanned_layers=mask, stack_axis=stack, mesh=mesh,
              shared_layers=options.get("shared_layers"))
    if factor:
        kw.update(factor_sharding_params=named)
    assert psgd_state_specs(pl, opt, **kw) == want


def test_state_specs_without_mesh_warn_and_take_raw_axes():
    """JAX warns without mesh= and places a diagonal factor over its own
    dim's raw axes; so does the port."""
    from psgd_torch_tpu.parallel import (gpt2_partition_specs as jspecs,
                                         psgd_state_specs as jstate_specs)
    from psgd_torch_tpu_torch.parallel import gpt2_partition_specs, psgd_state_specs
    _, mesh = _meshes()
    jparams, model, _ = _gpt2()
    pl = {"wte": gpt2_partition_specs(mesh)["wte"]}
    jp = {"wte": jspecs()["wte"]}
    named = {"wte": dict(model.named_parameters())["wte"]}
    jparams = {"wte": jparams["wte"]}
    with pytest.warns(UserWarning, match="without mesh"):
        want = _jax_specs(jstate_specs(jp, _jax_state(jparams), factor_sharding_params=jparams),
                          jparams, tuple(mesh.mesh_dim_names))
    opt = _port_opt(model, {"wte": False}, named=list(named.items()))
    with pytest.warns(UserWarning, match="without mesh"):
        got = psgd_state_specs(pl, opt, factor_sharding_params=named)
    assert got == want
