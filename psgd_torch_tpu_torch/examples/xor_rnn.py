"""Delayed XOR, the long-horizon recurrence benchmark where first-order
optimizers fail.

Counterpart of examples/xor_rnn.py, in its two modes:

  --cell rnn  (default): the tanh RNN (``rnn.init_rnn``, 30 hidden units)
      by ``kron_whiten`` (lr 1e-3, init scale 1, lr_preconditioner 0.01) --
      the reference's rnn_xor_problem_general_purpose_preconditioner.py:53-68;
  --cell lstm: the LSTM (``rnn.init_lstm``, 30 hidden units) by
      ``kron_newton`` (lr 0.02, init scale 1, lr_preconditioner 0.1, a
      global-norm clip of 10) fitted from exact Hessian-vector products
      (the closure's double backward, ``optim.hvp.hvp_exact``, where the
      JAX example takes ``jax.jvp`` over ``jax.grad``) -- the reference's
      lstm_with_xor_problem.py:55-74.

A fresh batch each iteration (``rnn.xor_batch``, from a generator seeded
10), the loss printed every 500th; it stops at a loss below 0.1, the
reference's threshold for solved.  Runs on the card unless ``--device``
names another device:

    python -m psgd_torch_tpu_torch.examples.xor_rnn [--device cpu]
        [--cell rnn|lstm] [--seq_len 50] [--batch 128] [--max_iters 100000]
"""

from __future__ import annotations

import argparse
import time

import torch

from .. import resolve_device
from ..models import rnn
from ..optim import KronNewton, kron_newton, kron_whiten

HIDDEN = 30
SOLVED = 0.1
PRINT_EVERY = 500
# per cell: (init, apply, optimizer factory, its arguments), the JAX names
CELLS = {
    "rnn": (rnn.init_rnn, rnn.apply_rnn, kron_whiten,
            dict(learning_rate=1e-3, preconditioner_init_scale=1.0,
                 lr_preconditioner=0.01)),
    "lstm": (rnn.init_lstm, rnn.apply_lstm, kron_newton,
             dict(learning_rate=0.02, preconditioner_init_scale=1.0,
                  lr_preconditioner=0.1, grad_clip_max_norm=10.0)),
}


def make_cell(cell: str, device):
    """(params, apply_fn, optimizer) of ``cell``: the model drawn from a
    generator seeded 1 (the JAX example's fold_in(key, 1))."""
    init, apply_fn, factory, kw = CELLS[cell]
    params = init(torch.Generator().manual_seed(1), dim_hidden=HIDDEN, device=device)
    return params, apply_fn, factory(params.items(), device=device, **kw)


def xor_step(opt, params: dict, apply_fn, xs, target) -> torch.Tensor:
    """One step on a batch; returns the loss before it."""
    def loss_fn():
        return rnn.xor_loss(apply_fn(params, xs), target)
    if isinstance(opt, KronNewton):
        return opt.step(loss_fn)
    opt.zero_grad()
    loss = loss_fn()
    loss.backward()
    opt.step()
    return loss


def main(argv=None) -> dict:
    """Returns the cell, the iteration where it was solved (None if not
    within ``--max_iters``), the first and the last loss, the mean of the
    first and of the last hundred (or fewer) losses, every loss, the ms per
    iteration (host clock; each iteration reads its loss) and the fit
    steps."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--cell", default="rnn", choices=sorted(CELLS))
    ap.add_argument("--seq_len", type=int, default=50)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--max_iters", type=int, default=100_000)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    params, apply_fn, opt = make_cell(args.cell, device)
    gen = torch.Generator().manual_seed(10)
    losses, solved = [], None
    t0 = time.perf_counter()
    for i in range(args.max_iters):
        xs, target = rnn.xor_batch(gen, args.batch, args.seq_len, device=device)
        losses.append(xor_step(opt, params, apply_fn, xs, target).item())
        if i % PRINT_EVERY == 0:
            print(f"iter {i}: loss {losses[-1]:.4f}", flush=True)
        if losses[-1] < SOLVED:
            solved = i
            print(f"SOLVED: loss {losses[-1]:.4f} < {SOLVED} at iter {i} "
                  f"({args.cell})", flush=True)
            break
    ms = (time.perf_counter() - t0) * 1e3 / len(losses)
    if solved is None:
        print(f"not solved within {args.max_iters} iters (loss {losses[-1]:.4f})")
    w = min(100, len(losses))
    return {"cell": args.cell, "solved_at": solved, "first": losses[0],
            "final": losses[-1], "first_mean": sum(losses[:w]) / w,
            "last_mean": sum(losses[-w:]) / w, "losses": losses,
            "iters": len(losses), "ms_per_it": ms, "fit_steps": opt.fit_steps}


if __name__ == "__main__":
    main()
