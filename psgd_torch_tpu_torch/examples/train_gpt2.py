"""Train GPT-2 with PSGD Kron momentum whitening or AdamW (counterpart of
examples/train_gpt2.py: the reference's settings, misc/gpt2.py; the
committed corpus data/corpus.txt.gz by default, --data synthetic for the
mixing-rule stream).

Run:  python -m psgd_torch_tpu_torch.examples.train_gpt2 [--steps N]
      [--model tiny|124m] [--opt psgd|adamw] [--batch B]
      [--data corpus|synthetic] [--device cuda|cpu]

On the card (the default) Q and the momentum are bf16 and the model
computes in bf16; ``--device cpu`` runs the plain path in float32.
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional

import torch

from .. import resolve_device
from ..models import gpt2, lm_data
from ..optim import KronWhiten
from ..utils import StepTimer


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable[[int], float]:
    """``optax.linear_schedule``: init_value to end_value linearly over
    transition_steps counts, then end_value."""
    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def make_config(model: str, device: torch.device) -> gpt2.GPT2Config:
    if model == "124m":
        return gpt2.gpt2_124m()
    on_card = device.type == "cuda"
    return gpt2.tiny_config(
        compute_dtype=torch.bfloat16 if on_card else torch.float32)


def psgd_optimizer(model: gpt2.GPT2, steps: int, device: torch.device,
                   seed: int = 0) -> KronWhiten:
    """The reference's PSGD settings (misc/gpt2.py:409-413): momentum
    whitening, lr = AdamW's / 4, max_skew 2, init scale 1, weight decay
    0.01, one preconditioner per layer; the production recipe's update
    probability 1.0 -> 0.1 over the first half of training
    (misc/gpt2.py:440); bf16 Q and momentum and norm_k 128 on the card,
    the parameters' dtype and norm_k 32 on the CPU.  ``seed``: the
    optimizer's key."""
    on_card = device.type == "cuda"
    pdt = torch.bfloat16 if on_card else None
    return KronWhiten(
        model.named_parameters(), lr=1e-3 / 4, momentum=0.9,
        whiten_grad=False, preconditioner_max_skew=2.0,
        preconditioner_init_scale=1.0,
        preconditioner_update_probability=linear_schedule(
            1.0, 0.1, max(steps // 2, 1)),
        weight_decay=0.01, preconditioner_dtype=pdt, momentum_dtype=pdt,
        norm_k=128 if on_card else 32,
        scanned_layers=gpt2.scanned_layers_mask(model), device=device,
        seed=seed)


def adamw_optimizer(model: gpt2.GPT2) -> torch.optim.AdamW:
    """The reference's AdamW settings (misc/gpt2.py:400-407)."""
    return torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.95),
                             weight_decay=0.01)


def batch_source(data: str, cfg: gpt2.GPT2Config, batch: int,
                 device: torch.device, log: Optional[Callable] = print):
    """step -> (tokens, targets): the corpus's random windows or the
    synthetic stream, a fresh batch per step keyed by 10_000 + step."""
    if data == "corpus":
        train_toks, _, vocab_used = lm_data.load_tokens(cfg.vocab_size)
        if log:
            log(f"corpus: {train_toks.size / 1e6:.2f}M tokens, vocab "
                f"{vocab_used}")
        return lambda i: lm_data.corpus_batch(
            torch.Generator().manual_seed(10_000 + i), train_toks, batch,
            cfg.block_size, device=device)
    return lambda i: gpt2.synthetic_lm_batch(
        torch.Generator().manual_seed(10_000 + i), batch, cfg.block_size,
        cfg.vocab_size, device=device)


def main(argv=None) -> list:
    """Train and print the loss every 20 steps; returns the losses."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--model", default="tiny", choices=["tiny", "124m"])
    ap.add_argument("--opt", default="psgd", choices=["psgd", "adamw"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--data", default="corpus", choices=["corpus", "synthetic"])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = make_config(args.model, device)
    model = gpt2.GPT2(cfg, device=device, seed=0)
    batch_fn = batch_source(args.data, cfg, args.batch, device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{n_params / 1e6:.1f}M params, block {cfg.block_size}, device "
          f"{device}")
    opt = (adamw_optimizer(model) if args.opt == "adamw"
           else psgd_optimizer(model, args.steps, device))

    timer = StepTimer(device=device)
    timer.start()
    losses = []
    for i in range(args.steps):
        tokens, targets = batch_fn(i)
        opt.zero_grad(set_to_none=True)
        loss = gpt2.loss_gpt2(model, tokens, targets)
        loss.backward()
        opt.step()
        timer.mark()
        losses.append(loss.item())   # a host read: the step is done
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:5d}  loss {losses[-1]:.4f}  "
                  f"({timer.steps_per_sec():.2f} steps/s)")
    return losses


if __name__ == "__main__":
    main()
