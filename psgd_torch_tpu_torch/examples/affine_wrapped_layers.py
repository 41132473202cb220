"""Affine-wrapped layers driven by the legacy Affine preconditioner.

Counterpart of examples/affine_wrapped_layers.py, the reference's two
affine-wrapping demos:

* misc/affine_wrapping_F_conv2d.py:141: LeNet5's layers as affine maps
  [patch, 1] @ [W; b], one kron(Q2, Q1) per layer; SGD against
  ``optim.Affine`` whitening (``--model lenet5``);
* misc/affine_wrapping_VF_rnn_tanh.py:186-189: a tanh RNN's input,
  recurrent and bias weights as one affine matrix on the delayed XOR,
  ``optim.Affine`` of Newton type with exact Hessian-vector products
  (``--model rnn``; solved at a loss below 0.1).

The models already hold the [W; b] convention (``models.lenet5``,
``models.rnn``).  Runs on the card unless ``--device`` names another
device; ``--iters`` defaults to 200 for lenet5 and to the reference's
budget of 20000 for rnn, which stops once solved:

    python -m psgd_torch_tpu_torch.examples.affine_wrapped_layers \\
        --model lenet5|rnn [--iters N] [--batch 128] [--seq_len 16] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from .. import resolve_device
from ..models import lenet5, rnn
from ..optim import Affine

RNN_SOLVED = 0.1


def lenet5_affine(params, device) -> Affine:
    """Affine whitening with the example's settings."""
    return Affine(params, lr=0.05, preconditioner_type="whitening",
                  lr_preconditioner=0.1, grad_clip_max_norm=10.0, device=device)


def rnn_affine(params: dict, device) -> Affine:
    """Affine Newton with the reference demo's settings
    (affine_wrapping_VF_rnn_tanh.py:153, 186-189): lr 0.01,
    lr_preconditioner 0.01, a trust region of 1."""
    return Affine(params.items(), lr=0.01, preconditioner_type="Newton",
                  lr_preconditioner=0.01, grad_clip_max_norm=1.0, device=device)


def run_lenet5(iters: int, batch: int, device) -> dict:
    """SGD (lr 0.1, momentum 0.9) and Affine whitening from the same start
    on synthetic classes; returns each one's last loss."""
    params0 = lenet5.init_lenet5(torch.Generator().manual_seed(0), device=device)
    results = {}
    for name in ("sgd", "psgd-affine"):
        params = [p.detach().clone().requires_grad_() for p in params0]
        opt = (torch.optim.SGD(params, lr=0.1, momentum=0.9) if name == "sgd"
               else lenet5_affine(params, device))
        gen = torch.Generator().manual_seed(100)
        last = float("nan")
        for i in range(iters):
            images, labels = lenet5.synthetic_mnist(gen, batch, device=device)
            opt.zero_grad()
            loss = lenet5.loss_lenet5(params, images, labels)
            loss.backward()
            opt.step()
            last = float(loss.detach())
            if i % 20 == 0:
                print(f"[lenet5/{name}] iter {i}: loss {last:.4f}")
        results[name] = last
        print(f"[lenet5/{name}] final loss {last:.4f}")
    return results


def run_rnn(iters: int, batch: int, seq_len: int, device) -> float:
    """Affine Newton on the delayed XOR until solved or ``iters`` steps;
    returns the last loss."""
    params = rnn.init_rnn(torch.Generator().manual_seed(1), device=device)
    opt = rnn_affine(params, device)
    gen = torch.Generator().manual_seed(10)
    lv = float("nan")
    for i in range(iters):
        xs, target = rnn.xor_batch(gen, batch, seq_len, device=device)
        lv = float(opt.step(lambda: rnn.xor_loss(rnn.apply_rnn(params, xs),
                                                 target)).detach())
        if i % 200 == 0:
            print(f"[rnn/psgd-affine] iter {i}: loss {lv:.4f}")
        if lv < RNN_SOLVED:
            print(f"[rnn/psgd-affine] SOLVED: loss {lv:.4f} < {RNN_SOLVED} at iter {i}")
            return lv
    print(f"[rnn/psgd-affine] not solved in {iters} iters (loss {lv:.4f})")
    return lv


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=["lenet5", "rnn"], default="lenet5")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seq_len", type=int, default=16)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.model == "lenet5":
        return run_lenet5(args.iters or 200, min(args.batch, 64), device)
    return run_rnn(args.iters or 20000, args.batch, args.seq_len, device)


if __name__ == "__main__":
    main()
