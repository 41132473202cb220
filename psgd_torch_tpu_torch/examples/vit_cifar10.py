"""A small ViT on CIFAR-shaped images: Adam against PSGD KronWhiten at the
same lr.

Counterpart of examples/vit_cifar10.py (the reference benchmark
misc/vit.py:323-363): ``torch.optim.Adam(lr)`` (optax.adam's defaults)
and ``KronWhiten(lr, momentum=0.9, preconditioner_max_skew=2.0, dq,
scanned_layers)`` each train ``models.vit.ViT`` (dim 256, depth 4, 8
heads) from the same initial weights on the same batches.

Data: the UCI handwritten digits scikit-learn ships
(``models.image_data``), upscaled to 32 x 32 x 3, or
``vit.synthetic_cifar`` where scikit-learn is missing; it prints which.
Nothing is downloaded.  Runs on the card unless ``--device`` names
another device:

    python -m psgd_torch_tpu_torch.examples.vit_cifar10 [--device cpu]
        [--epochs 5] [--steps_per_epoch 100] [--batch 128] [--dq Q0.5EQ1.5]
        [--lr 1e-3]
"""

from __future__ import annotations

import argparse
import time

import torch

from .. import resolve_device
from ..models import image_data, vit
from ..optim import KronWhiten

EPOCHS = 5
STEPS_PER_EPOCH = 100
BATCH = 128


def load_data(device):
    """(batch_fn(generator, n) -> (images, labels), (test images, test
    labels)) on ``device``, images NHWC: the real digits if scikit-learn is
    present, else synthetic classes."""
    try:
        tr_x, tr_y, te_x, te_y = image_data.load_digits_split()
    except ImportError:
        print("data: synthetic (sklearn not available)")
        test = vit.synthetic_cifar(torch.Generator().manual_seed(999), 1000,
                                   device=device)
        return (lambda gen, n: vit.synthetic_cifar(gen, n, device=device)), test

    def nhwc(x):
        return image_data.digits_resized(x, 32, 3).permute(0, 2, 3, 1).to(device)
    x, y = nhwc(tr_x), torch.from_numpy(tr_y).long().to(device)
    test = (nhwc(te_x), torch.from_numpy(te_y).long().to(device))

    def batch(gen, n):
        idx = torch.randint(0, len(x), (n,), generator=gen).to(device)
        return x[idx], y[idx]

    print(f"data: real UCI digits ({len(x)} train / {len(test[0])} test)")
    return batch, test


def run(name, make_opt, cfg, device, batch_fn, test_set, epochs, steps, batch):
    """Train a fresh ViT (seed 42) by ``make_opt(model)`` on the batches
    drawn from a generator seeded 0; returns the last epoch's mean train
    loss and test accuracy, the first step's loss, every epoch's mean train
    loss, the median step time (ms, host clock; each step reads its loss)
    and the fit steps taken (None for an optimizer that fits nothing)."""
    model = vit.ViT(cfg, device=device, seed=42)
    opt = make_opt(model)
    gen = torch.Generator().manual_seed(0)
    epoch_losses, step_ms, acc = [], [], 0.0
    for epoch in range(epochs):
        total = 0.0
        for _ in range(steps):
            images, labels = batch_fn(gen, batch)
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss = vit.loss_vit(model, images, labels)
            loss.backward()
            opt.step()
            total += loss.item()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if len(step_ms) == 1:
                first = loss.item()
        with torch.no_grad():
            ti, tl = test_set
            acc = float(torch.mean((torch.argmax(model(ti), dim=1) == tl).float()))
        epoch_losses.append(total / steps)
        print(f"[{name}] epoch {epoch + 1:2d}  train loss {epoch_losses[-1]:.4f}  "
              f"test acc {acc:.3f}")
    return {"train_loss": epoch_losses[-1], "test_acc": acc, "first_loss": first,
            "epoch_losses": epoch_losses,
            "step_ms": sorted(step_ms)[len(step_ms) // 2],
            "fit_steps": getattr(opt, "fit_steps", None)}


def main(argv=None) -> dict:
    """Both arms; returns {arm name: ``run``'s result}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--dq", default="Q0.5EQ1.5",
                    help="Kron dQ geometry (the reference sweeps this)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--steps_per_epoch", type=int, default=STEPS_PER_EPOCH)
    ap.add_argument("--batch", type=int, default=BATCH)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = vit.ViTConfig()
    batch_fn, test_set = load_data(device)
    arms = {
        "adam": lambda m: torch.optim.Adam(m.parameters(), lr=args.lr),
        f"psgd-kron({args.dq})": lambda m: KronWhiten(
            m.named_parameters(), lr=args.lr, momentum=0.9,
            preconditioner_max_skew=2.0, dq=args.dq,
            scanned_layers=vit.scanned_layers_mask(m), device=device),
    }
    return {name: run(name, make, cfg, device, batch_fn, test_set, args.epochs,
                      args.steps_per_epoch, args.batch)
            for name, make in arms.items()}


if __name__ == "__main__":
    main()
