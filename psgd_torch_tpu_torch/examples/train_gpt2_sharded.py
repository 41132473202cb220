"""Fully sharded GPT-2 training with PSGD on ``torch.distributed``
(counterpart of examples/train_gpt2_sharded.py): every distributed piece
of the port in one program.

* the mesh: ``parallel.make_multihost_mesh`` (a leading "dcn" dim across
  hosts, ``LOCAL_WORLD_SIZE`` ranks each; one host: ``make_mesh``);
* the layout from one declaration: ``gpt2_partition_specs`` and
  ``sharding_recipe`` over the whole mesh, the model placed by
  ``models.gpt2.shard_model`` at ``recipe.model_placements()`` (its forward
  gathers the fsdp blocks itself and is tensor-parallel over tp) and the
  optimizer given ``recipe.transform_kwargs``.  With tp 1 (2 ranks of a
  host): the blocks' layer stacks ``Shard(0)`` over fsdp, each rank's
  layers fitted and stepped in place by ``stack_sharding``.  With tp > 1
  (4 or more ranks of a host: (dp 1, fsdp 2, tp 2) at 4, as JAX's
  ``make_mesh(4)``): JAX's layout, the blocks ``(None, fsdp, tp)``,
  ``stack_sharding`` over fsdp fitting each rank's layers (resharded by
  bytes), Q replicated over tp.  Either way the embeddings sit at the
  map's placements (their Q dim-sharded, ``factor_sharding``) and the final
  LayerNorm is replicated;
* ``KronWhiten`` with the JAX example's settings (lr 1e-3, momentum 0.9,
  max_skew 2, init scale 1, update probability 1.0 -> 0.1 over the first
  half), ``--share-fit-apply``; bf16 Q and momentum on the card;
* a checkpoint at the end (``--ckpt_dir``: one file per rank) and
  ``--resume`` from the latest one at this run's world size, whatever
  size wrote it (``utils.restore_checkpoint`` gathers and cuts).

Every rank of a host's fsdp and tp groups takes the step's whole batch
(the JAX example's data sharding over dp only; across hosts each takes
its rows), so a k-rank run with tp 1 steps as the 1-rank run does, and
with tp > 1 as it does up to the rounding of the tp partial sums.  One
rank runs unsharded: the plain model and optimizer.

Run:  torchrun --nproc-per-node 4 -m psgd_torch_tpu_torch.examples.train_gpt2_sharded [--steps N] [--device cpu]
      python -m psgd_torch_tpu_torch.examples.train_gpt2_sharded --nproc 4 --device cpu
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from .. import resolve_device
from ..models import gpt2
from ..optim import KronWhiten
from ..parallel import (gpt2_partition_specs, make_multihost_mesh,
                        sharding_recipe)
from ..utils import latest_step, restore_checkpoint, save_checkpoint
from .train_gpt2 import linear_schedule


class Setup(NamedTuple):
    """What a rank trains: the model (``shard_model``'s when sharded), its
    optimizer, the mesh (None on one rank), the config and the dcn
    (replica) dim's size and this rank's index on it."""
    cfg: gpt2.GPT2Config
    model: gpt2.GPT2
    opt: KronWhiten
    mesh: object
    replicas: int
    replica: int


def mesh_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.mesh.shape)))


def make_config(model: str, device: torch.device) -> gpt2.GPT2Config:
    """The JAX example's tiny model (4 x 128, vocab 512, block 64) or GPT-2
    124M; bf16 compute on the card, float32 on the CPU."""
    dt = torch.bfloat16 if device.type == "cuda" else torch.float32
    if model == "124m":
        return gpt2.gpt2_124m(compute_dtype=dt)
    return gpt2.tiny_config(n_layer=4, n_head=4, n_embd=128, block_size=64,
                            vocab_size=512, compute_dtype=dt)


def make_optimizer(model, steps: int, device: torch.device,
                   share_fit_apply: bool = False, **sharding) -> KronWhiten:
    """KronWhiten with the JAX example's settings over ``model``'s
    parameters (DTensors when sharded), ``sharding`` the recipe's transform
    kwargs (or the scanned mask alone on one rank)."""
    share = (dict(share_fit_apply=True, whiten_grad=False,
                  update_preconditioner_first=False) if share_fit_apply else {})
    pdt = torch.bfloat16 if device.type == "cuda" else None
    return KronWhiten(
        model.named_parameters(), lr=1e-3, momentum=0.9,
        preconditioner_max_skew=2.0, preconditioner_init_scale=1.0,
        preconditioner_update_probability=linear_schedule(
            1.0, 0.1, max(steps // 2, 1)),
        preconditioner_dtype=pdt, momentum_dtype=pdt,
        norm_k=128 if device.type == "cuda" else None, device=device,
        **share, **sharding)


def setup(cfg: gpt2.GPT2Config, steps: int, device: torch.device,
          share_fit_apply: bool = False) -> Setup:
    """The model, its layout and its optimizer on this rank (every rank of
    the default process group calls it alike)."""
    model = gpt2.GPT2(cfg, device=device, seed=0)
    mask = gpt2.scanned_layers_mask(model)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        opt = make_optimizer(model, steps, device, share_fit_apply,
                             scanned_layers=mask)
        return Setup(cfg, model, opt, None, 1, 0)
    mesh = make_multihost_mesh(device_type=device.type)
    recipe = sharding_recipe(mesh, gpt2_partition_specs(mesh),
                             model.named_parameters(), scanned_layers=mask,
                             stack_axis="fsdp")
    gpt2.shard_model(model, mesh, recipe.model_placements())
    opt = make_optimizer(model, steps, device, share_fit_apply,
                         **recipe.transform_kwargs)
    return Setup(cfg, model, opt, mesh, mesh_sizes(mesh)["dcn"],
                 mesh.get_coordinate()[0])


def batch_fn(cfg: gpt2.GPT2Config, batch: int, device: torch.device,
             replicas: int = 1, replica: int = 0) -> Callable:
    """step -> (tokens, targets): the synthetic stream from a
    ``torch.Generator`` per step (seed 100 + step, as the JAX example
    folds its key), this replica's rows of it."""
    if batch % replicas:
        raise ValueError(f"batch {batch} does not divide over {replicas} hosts")
    rows = slice(replica * batch // replicas, (replica + 1) * batch // replicas)

    def make(i: int):
        x, y = gpt2.synthetic_lm_batch(torch.Generator().manual_seed(100 + i),
                                       batch, cfg.block_size, cfg.vocab_size,
                                       device=device)
        return x[rows], y[rows]
    return make


def train_step(s: Setup, tokens, targets) -> torch.Tensor:
    """One step: forward and backward (the sharded forward's collectives
    in them), every gradient block averaged over the hosts, the
    optimizer's step."""
    s.opt.zero_grad(set_to_none=True)
    loss = gpt2.loss_gpt2(s.model, tokens, targets)
    loss.backward()
    if s.replicas > 1:
        group = s.mesh.get_group("dcn")
        for p in s.model.parameters():
            if p.grad is not None:
                g = p.grad.to_local()
                dist.all_reduce(g, group=group)
                g /= s.replicas
    s.opt.step()
    return loss.detach()


def run(args, device: torch.device) -> list:
    """Train ``args.steps`` steps (after a resume, from its step) on this
    rank; save at the end with ``args.ckpt_dir``.  Returns the losses."""
    cfg = make_config(args.model, device)
    s = setup(cfg, args.steps, device, args.share_fit_apply)
    rank = dist.get_rank() if dist.is_initialized() else 0
    say = print if rank == 0 else (lambda *a: None)
    if s.mesh is not None:
        say(f"mesh: {mesh_sizes(s.mesh)}")
    start = 0
    if args.resume:
        step = latest_step(args.ckpt_dir) if args.ckpt_dir else None
        if step is None:
            say(f"no checkpoint under {args.ckpt_dir}; starting fresh")
        else:
            start, _ = restore_checkpoint(args.ckpt_dir, s.model, s.opt)
            say(f"resumed from step {start}")
    make = batch_fn(cfg, args.batch, device, s.replicas, s.replica)
    losses = []
    end = start + args.steps
    for i in range(start, end):
        loss = train_step(s, *make(i))
        losses.append(loss.item())
        if i % 10 == 0 or i == end - 1:
            say(f"step {i:4d}  loss {losses[-1]:.4f}")
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, end, s.model, s.opt)
        if dist.is_initialized():
            dist.barrier()      # every rank's file in place
        say(f"checkpoint saved to {args.ckpt_dir}/step_{end}")
    return losses


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--model", default="tiny", choices=["tiny", "124m"])
    ap.add_argument("--ckpt_dir", default=None,
                    help="checkpoint directory (saved at the end)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint from --ckpt_dir, at "
                         "this run's world size, and continue from it")
    ap.add_argument("--share-fit-apply", action="store_true",
                    help="reuse the Q fit's Pg product as the update on fit "
                         "steps (needs momentum whitening and unbiased "
                         "ordering, switched on here)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--nproc", type=int, default=None,
                    help="spawn this many ranks here (default: torchrun's, "
                         "or one)")
    return ap.parse_args(argv)


def _device(args, local_rank: int) -> torch.device:
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return device


def _backend(device: torch.device, local_world: int) -> str:
    """gloo on the CPU and where ranks share a card (NCCL refuses two
    ranks on one device); NCCL where each rank has its own."""
    if device.type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def _rank_main(rank: int, world: int, store: str, argv, out: Optional[str]):
    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    args = parse(argv)
    device = _device(args, rank)
    dist.init_process_group(_backend(device, world), init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        losses = run(args, device)
    finally:
        dist.destroy_process_group()
    if out and rank == 0:
        torch.save(losses, out)


def main(argv=None) -> list:
    """Train; returns the losses (rank 0's when it spawns the ranks)."""
    args = parse(argv)
    if args.nproc and args.nproc > 1:
        import torch.multiprocessing as mp
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "losses.pt")
            mp.spawn(_rank_main, args=(args.nproc, os.path.join(tmp, "store"),
                                       argv, out), nprocs=args.nproc)
            return torch.load(out)
    if "RANK" in os.environ and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = _device(args, local)
        dist.init_process_group(_backend(device, int(os.environ.get(
            "LOCAL_WORLD_SIZE", "1"))))
        try:
            return run(args, device)
        finally:
            dist.destroy_process_group()
    return run(args, resolve_device(args.device))


if __name__ == "__main__":
    main()
