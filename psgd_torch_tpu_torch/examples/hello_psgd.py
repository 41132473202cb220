"""'Hello world': the 100-variable coupled Rosenbrock function minimized by
the dense Newton-type preconditioner.

Counterpart of examples/hello_psgd.py (reference hello_psgd.py):
``optim.dense_newton`` (lr 1.0, lr_preconditioner 0.5, momentum 0.9, the
Q0.5EQ1.5 geometry) from x = 0, where f = 50.  Every step fits Q from an
exact Hessian-vector product: the closure's double backward
(``optim.hvp.hvp_exact``, the product ``optim.hvp.make_hvp_fn`` makes),
where the JAX example takes ``jax.jvp`` over ``jax.grad``.  It prints
every 200th iteration.  Runs on the card unless ``--device`` names
another device:

    python -m psgd_torch_tpu_torch.examples.hello_psgd [--device cpu]
        [--iters 2000]
"""

from __future__ import annotations

import argparse
import time

import torch

from .. import resolve_device
from ..optim import dense_newton

N = 100
ITERS = 2000
PRINT_EVERY = 200
SETTINGS = dict(learning_rate=1.0, lr_preconditioner=0.5, momentum=0.9)


def rosenbrock(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x[0::2], x[1::2]
    return torch.sum(100.0 * (x2 - x1 ** 2) ** 2 + (1.0 - x1) ** 2)


def minimize(iters: int, device, dtype=torch.float32, draw=None,
             every: int = PRINT_EVERY):
    """``iters`` steps of ``dense_newton`` (``SETTINGS``) from x = 0 of
    ``dtype``; ``draw`` replays another package's draws (the CPU tests'
    hook).  Prints every ``every``-th loss and the last (0: none).  Returns
    (x, the loss before each step, the optimizer)."""
    x = torch.zeros(N, dtype=dtype, device=device, requires_grad=True)
    opt = dense_newton([x], device=device, draw=draw, **SETTINGS)
    losses = []
    for i in range(iters):
        losses.append(opt.step(lambda: rosenbrock(x)).detach())
        if every and (i % every == 0 or i == iters - 1):
            print(f"iter {i:5d}  f = {losses[-1].item():.3e}", flush=True)
    return x, losses, opt


def main(argv=None) -> dict:
    """Returns the first, final and least loss, the ms per iteration (host
    clock, the losses read at the end) and the fit steps taken."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--iters", type=int, default=ITERS)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    t0 = time.perf_counter()
    _, losses, opt = minimize(args.iters, device)
    values = torch.stack(losses).tolist()
    ms = (time.perf_counter() - t0) * 1e3 / args.iters
    return {"first": values[0], "final": values[-1], "min": min(values),
            "ms_per_it": ms, "fit_steps": opt.fit_steps}


if __name__ == "__main__":
    main()
