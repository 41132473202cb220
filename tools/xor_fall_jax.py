"""How the JAX package's optimizers move the delayed-XOR loss of
examples/xor_rnn.py in its first iterations, with the example's settings:
the reference that the port's ``chip_smoke.py`` examples path gates its
XOR cells against.

    python tools/xor_fall_jax.py [--cell rnn lstm] [--iters 500]
        [--window 50] [--json PATH]

Runs on the CPU (float32, the example's model from fold_in(key 0, 1) and
its batches from fold_in(key 0, 10 + i), seq_len 50, batch 128) and
prints, per cell, the loss every 100th iteration, the mean of the first
and of the last ``--window`` losses, and the range of the means of the
windows that do not overlap the first and the share of them below it.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import optax  # noqa: E402

import psgd_torch_tpu.optim as popt  # noqa: E402
from psgd_torch_tpu.models import rnn  # noqa: E402

# examples/xor_rnn.py:36-52
CELLS = {
    "rnn": (rnn.init_rnn, rnn.apply_rnn, False, lambda: popt.kron_whiten(
        learning_rate=1e-3, preconditioner_init_scale=1.0, lr_preconditioner=0.01)),
    "lstm": (rnn.init_lstm, rnn.apply_lstm, True, lambda: popt.kron_newton(
        learning_rate=0.02, preconditioner_init_scale=1.0, lr_preconditioner=0.1,
        grad_clip_max_norm=10.0)),
}


def losses(cell: str, iters: int, seq_len: int = 50, batch: int = 128) -> list:
    init, apply_fn, newton, make_opt = CELLS[cell]
    key = jax.random.key(0)
    params = init(jax.random.fold_in(key, 1), dim_hidden=30)
    opt = make_opt()

    def loss_fn(p, xs, target):
        return rnn.xor_loss(apply_fn(p, xs), target)

    @jax.jit
    def step(params, state, xs, target):
        loss, grads = jax.value_and_grad(loss_fn)(params, xs, target)
        kw = {"hvp_fn": popt.make_hvp_fn(loss_fn, xs, target)} if newton else {}
        updates, state = opt.update(grads, state, params, **kw)
        return optax.apply_updates(params, updates), state, loss

    state, out = opt.init(params), []
    for i in range(iters):
        xs, target = rnn.xor_batch(jax.random.fold_in(key, 10 + i), batch, seq_len)
        params, state, loss = step(params, state, xs, target)
        out.append(float(loss))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", nargs="+", default=["rnn", "lstm"], choices=sorted(CELLS))
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--window", type=int, default=50)
    ap.add_argument("--json", default=None, help="write every loss there")
    args = ap.parse_args()
    record = {}
    for cell in args.cell:
        ls = losses(cell, args.iters)
        w = min(args.window, len(ls))
        means = [sum(ls[i:i + w]) / w for i in range(len(ls) - w + 1)]
        first, later = means[0], means[w:]
        print(f"{cell}: " + ", ".join(f"{i}: {ls[i]:.4f}" for i in range(0, len(ls), 100)))
        print(f"{cell}: mean of the first {w} {first:.4f}, of the last {w} "
              f"{means[-1]:.4f} after {len(ls)} iterations")
        if later:
            below = sum(m < first for m in later) / len(later)
            print(f"{cell}: the means of the {len(later)} later windows of {w}: "
                  f"{min(later):.4f} to {max(later):.4f}, {100 * below:.1f}% of them "
                  f"below the first's")
        record[cell] = ls
    if args.json:
        with open(args.json, "w") as f:
            json.dump(record, f)


if __name__ == "__main__":
    main()
