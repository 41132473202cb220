"""Quadratic-feature logistic regression: PSGD-LRA against SGD and L-BFGS.

Counterpart of examples/logistic_regression.py (reference
misc/mnist_logistic_regression.py:61-173, where PSGD-LRA outperforms
L-BFGS, "the algorithm of choice" for logistic regression).  The features
are [x; the upper triangle of x xᵀ] of images folded to SIDE x SIDE
(``featurize``); at SIDE 16 that is 33,152 features, so W is (33,153, 10),
331,530 parameters (the JAX docstring's 6.2M is the reference's size, not
this example's).  ``lenet5.synthetic_mnist`` stands in for MNIST (no
download).  Three arms from W = 0 on the same batches: SGD (lr 0.5),
L-BFGS (history 10) and ``lra_whiten`` (lr 0.05, rank 10, momentum 0.9),
``EPOCHS`` x ``STEPS_PER_EPOCH`` steps of ``BATCH`` images, each epoch
printing its mean train loss and the best test error so far on 2000
held-out images.

The L-BFGS arm is ``torch.optim.LBFGS`` with its strong-Wolfe line search,
one iteration per step (``max_iter=1``), its closure re-evaluated on the
step's batch as ``optax.lbfgs``'s ``value_fn`` is.  It is a baseline, not a
PSGD module: its line search is not optax's zoom, so nothing is held
between the two.

Runs on the card unless ``--device`` names another device:

    python -m psgd_torch_tpu_torch.examples.logistic_regression
        [--device cpu] [--epochs 20] [--steps_per_epoch 50] [--batch 256]
"""

from __future__ import annotations

import argparse
import functools
import time

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..models import lenet5
from ..optim import lra_whiten

EPOCHS = 20
STEPS_PER_EPOCH = 50
BATCH = 256
SIDE = 16  # the 32 x 32 images folded to 16 x 16: the features stay manageable
TEST_N = 2000
LRA = dict(learning_rate=0.05, rank_of_approximation=10, momentum=0.9)


def n_features(side: int = SIDE) -> int:
    d = side * side
    return d + d * (d + 1) // 2


def featurize(images: torch.Tensor, side: int = SIDE) -> torch.Tensor:
    """[x; the upper triangle of x xᵀ] (reference :33-43) for NCHW images
    (b, 1, 2 side, 2 side).  x is the JAX example's fold,
    ``images.reshape(b, 2, SIDE, 2, SIDE, 1).mean(axis=(1, 3))`` on NHWC
    images: the mean of the four side x side quadrants, not a 2 x 2
    average pool; the triangle in ``jnp.triu_indices`` order (row by row)."""
    b = images.shape[0]
    x = images.reshape(b, 2, side, 2, side).mean(dim=(1, 3)).reshape(b, -1)
    iu = torch.triu_indices(x.shape[1], x.shape[1], device=x.device)
    return torch.cat([x, x[:, iu[0]] * x[:, iu[1]]], dim=1)


def loss_fn(w: torch.Tensor, feats: torch.Tensor, labels: torch.Tensor):
    """Mean cross-entropy of the logits feats W[:-1] + W[-1]."""
    logits = feats @ w[:-1] + w[-1]
    return -torch.mean(torch.gather(F.log_softmax(logits, dim=1), 1,
                                    labels[:, None]))


def _step(opt, w, feats, labels):
    """One step of ``opt``; returns the loss before it."""
    def closure():
        opt.zero_grad()
        loss = loss_fn(w, feats, labels)
        loss.backward()
        return loss
    if isinstance(opt, torch.optim.LBFGS):
        return opt.step(closure)
    loss = closure()
    opt.step()
    return loss


def run(name: str, make_opt, device, epochs: int = EPOCHS,
        steps: int = STEPS_PER_EPOCH, batch: int = BATCH):
    """Arm ``name``: W = 0 of (n_features + 1, 10), ``make_opt([W])``, the
    batches drawn from a generator seeded 0 (the same for every arm), the
    test set from one seeded 999.  Returns each epoch's mean train loss,
    the first step's loss, the best test error, the ms per step (host
    clock, each epoch's losses read at its end) and the fit steps (None
    for an optimizer that fits nothing)."""
    w = torch.zeros((n_features() + 1, 10), device=device, requires_grad=True)
    opt = make_opt([w])
    gen = torch.Generator().manual_seed(0)
    test_x, test_y = lenet5.synthetic_mnist(torch.Generator().manual_seed(999),
                                            TEST_N, device=device)
    test_f = featurize(test_x)
    best_err, epoch_losses, first, elapsed = 1.0, [], None, 0.0
    for epoch in range(epochs):
        t0 = time.perf_counter()
        losses = []
        for _ in range(steps):
            images, labels = lenet5.synthetic_mnist(gen, batch, device=device)
            losses.append(_step(opt, w, featurize(images), labels).detach())
        values = torch.stack(losses).tolist()
        elapsed += time.perf_counter() - t0
        first = values[0] if first is None else first
        epoch_losses.append(sum(values) / steps)
        with torch.no_grad():
            err = torch.mean((torch.argmax(test_f @ w[:-1] + w[-1], dim=1)
                              != test_y).float()).item()
        best_err = min(best_err, err)
        print(f"[{name}] epoch {epoch + 1:2d}  train loss {epoch_losses[-1]:.4f}  "
              f"best test err {best_err:.4f}", flush=True)
    return {"first": first, "epoch_losses": epoch_losses, "best_err": best_err,
            "ms_per_it": elapsed * 1e3 / (epochs * steps),
            "fit_steps": getattr(opt, "fit_steps", None)}


def arms(device) -> dict:
    """{arm name: make_opt(params)} in the JAX example's order."""
    return {"sgd": lambda p: torch.optim.SGD(p, lr=0.5),
            "lbfgs": lambda p: torch.optim.LBFGS(p, lr=1.0, max_iter=1,
                                                 history_size=10,
                                                 line_search_fn="strong_wolfe"),
            "psgd-lra": functools.partial(lra_whiten, device=device, **LRA)}


def main(argv=None) -> dict:
    """Every arm; returns {arm name: ``run``'s result}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--steps_per_epoch", type=int, default=STEPS_PER_EPOCH)
    ap.add_argument("--batch", type=int, default=BATCH)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(f"params: {(n_features() + 1) * 10 / 1e6:.2f}M")
    return {name: run(name, make, device, args.epochs, args.steps_per_epoch,
                      args.batch) for name, make in arms(device).items()}


if __name__ == "__main__":
    main()
