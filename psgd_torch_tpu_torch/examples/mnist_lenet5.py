"""LeNet5 classification by the legacy functional Kron preconditioner.

Counterpart of examples/mnist_lenet5.py (reference mnist_with_lenet5.py:
53-72): the shape-dispatching ``precond.legacy.update_precond_kron`` /
``precond_grad_kron`` pair on each of LeNet5's five [W; b] matrices (both
sides dense), fitted every step from exact Hessian-vector products
(``optim.hvp.hvp_exact``), a global-norm trust region of 10, and the lr
annealed by 0.01^(1/(epochs - 1)) per epoch.

Data: the UCI handwritten digits scikit-learn ships (``models.image_data``),
or ``lenet5.synthetic_mnist`` where scikit-learn is missing; it prints
which.  Runs on the card unless ``--device`` names another device:

    python -m psgd_torch_tpu_torch.examples.mnist_lenet5 [--device cpu]
        [--epochs 10] [--steps_per_epoch 100] [--batch 64]
"""

from __future__ import annotations

import argparse

import torch

from .. import resolve_device
from ..models import image_data, lenet5
from ..optim import hvp
from ..precond import legacy

PRECOND_LR = 0.01
MAX_NORM = 10.0


def load_data(device):
    """(batch_fn(generator, n) -> (images, labels), (test images, test
    labels)) on ``device``: the real digits if scikit-learn is present,
    else synthetic classes."""
    try:
        tr_x, tr_y, te_x, te_y = image_data.load_digits_split()
    except ImportError:
        print("data: synthetic (sklearn not available)")
        test = lenet5.synthetic_mnist(torch.Generator().manual_seed(999), 1000,
                                      device=device)
        return (lambda gen, n: lenet5.synthetic_mnist(gen, n, device=device)), test
    x = image_data.digits_resized(tr_x, 32).to(device)
    y = torch.from_numpy(tr_y).long().to(device)
    test = (image_data.digits_resized(te_x, 32).to(device),
            torch.from_numpy(te_y).long().to(device))

    def batch(gen, n):
        idx = torch.randint(0, len(x), (n,), generator=gen).to(device)
        return x[idx], y[idx]

    print(f"data: real UCI digits ({len(x)} train / {len(test[0])} test)")
    return batch, test


def init_preconditioners(params) -> list:
    """One (Ql, Qr) pair per [W; b] matrix, both sides dense identities."""
    return [legacy.init_kron_legacy(p.shape, dtype=p.dtype, device=p.device)
            for p in params]


def kron_step(params, qs, lr: float, images, labels, generator):
    """One step: the loss, the gradients and H v (v standard normal per
    matrix, drawn with ``generator``) in one double backward, each (Ql, Qr)
    fitted from its (v, H v), the gradients preconditioned, clipped to the
    trust region and stepped.  Updates ``params`` in place; returns (the new
    preconditioners, the loss)."""
    losses = []

    def loss_fn():
        losses.append(lenet5.loss_lenet5(params, images, labels))
        return losses[-1]

    vs = [torch.randn(p.shape, dtype=p.dtype, device=p.device, generator=generator)
          for p in params]
    grads, hvs = hvp.hvp_exact(loss_fn, params, vs)
    with torch.no_grad():
        qs = [legacy.update_precond_kron(ql, qr, v, h, lr=PRECOND_LR)
              for (ql, qr), v, h in zip(qs, vs, hvs)]
        pre = [legacy.precond_grad_kron(ql, qr, g) for (ql, qr), g in zip(qs, grads)]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in pre))
        scale = lr * torch.clamp(MAX_NORM / norm, max=1.0)
        for p, g in zip(params, pre):
            p.sub_(scale * g)
    return qs, losses[0].detach()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--steps_per_epoch", type=int, default=100)
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    batch_fn, (test_x, test_y) = load_data(device)
    params = lenet5.init_lenet5(torch.Generator().manual_seed(0), device=device)
    qs = init_preconditioners(params)
    gen_data = torch.Generator().manual_seed(1)
    gen_v = torch.Generator(device=device).manual_seed(2)
    lr, out = 0.1, {}
    for epoch in range(args.epochs):
        total = 0.0
        for _ in range(args.steps_per_epoch):
            images, labels = batch_fn(gen_data, args.batch)
            qs, loss = kron_step(params, qs, lr, images, labels, gen_v)
            total += float(loss)
        with torch.no_grad():
            acc = float(torch.mean((torch.argmax(lenet5.apply_lenet5(params, test_x),
                                                 dim=1) == test_y).float()))
        out = {"train_loss": total / args.steps_per_epoch, "test_acc": acc}
        print(f"epoch {epoch + 1:2d}  lr {lr:.4f}  train loss "
              f"{out['train_loss']:.4f}  test acc {acc:.3f}")
        if args.epochs > 1:   # the reference's annealing
            lr *= 0.01 ** (1.0 / (args.epochs - 1))
    return out


if __name__ == "__main__":
    main()
