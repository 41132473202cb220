"""Tensor-rank (CP) decomposition: the reference's showcase comparing the
Newton-type preconditioners with SGD and L-BFGS.

Counterpart of examples/tensor_rank_decomposition.py (reference
demo_usage_of_all_preconditioners.py:13-193): decompose a rank-10 target
T[i, j, k] = sum_r x[r, i] y[r, j] z[r, k] with (I, J, K) = (20, 50, 100)
from one random start by five arms: SGD (lr 1e-4), L-BFGS, and
``dense_newton``, ``lra_newton`` (rank 10) and ``kron_newton``, each at
the JAX settings (lr 0.2, lr_preconditioner 0.5, momentum 0.9, a
global-norm clip of 10) and fitted every step from exact Hessian-vector
products (the closure's double backward, ``optim.hvp.hvp_exact``).  Each
arm takes one step outside the clock (the JAX example's compile), then
``--iters`` steps, and reports its final and least loss and its ms per
iteration.

The L-BFGS arm is ``torch.optim.LBFGS`` with its strong-Wolfe line search,
one iteration per step (``max_iter=1``; history 10, optax's
``memory_size``), its closure re-evaluated on the same problem as
``optax.lbfgs``'s ``value_fn`` is.  It is a baseline, not a PSGD module:
its line search is not optax's zoom, so the two baselines differ and
nothing is held between them.

Runs on the card unless ``--device`` names another device:

    python -m psgd_torch_tpu_torch.examples.tensor_rank_decomposition
        [--device cpu] [--iters 2000]
"""

from __future__ import annotations

import argparse
import functools
import time

import torch

from .. import resolve_device
from ..optim import (DenseNewton, KronNewton, LRANewton, dense_newton,
                     kron_newton, lra_newton)

R, I, J, K = 10, 20, 50, 100
NUM_ITERS = 2000
SGD_LR = 1e-4   # SGD diverges easily above it on this problem
LBFGS_HISTORY = 10
NEWTON = dict(learning_rate=0.2, lr_preconditioner=0.5, momentum=0.9,
              grad_clip_max_norm=10.0)
# the PSGD arms: (factory, its arguments besides NEWTON), the JAX names
PSGD_ARMS = {"DenseNewton": (dense_newton, {}),
             "LRANewton": (lra_newton, dict(rank_of_approximation=10)),
             "KronNewton": (kron_newton, {})}


def cp_loss(target: torch.Tensor, xyz) -> torch.Tensor:
    """|T - sum_r x_r (x) y_r (x) z_r|^2."""
    err = target - torch.einsum("ri,rj,rk->ijk", *xyz)
    return torch.sum(err * err)


def make_problem(generator: torch.Generator, rank: int = R, sizes=(I, J, K),
                 device=None):
    """(loss_fn(xyz), init): a target from random factors (rank, s) and
    random starting factors, drawn in float32 on the CPU from
    ``generator`` (the target's factors first), on the card unless
    ``device`` names another device."""
    dev = resolve_device(device)
    truth = [torch.randn((rank, s), generator=generator) for s in sizes]
    target = torch.einsum("ri,rj,rk->ijk", *truth).to(dev)
    init = [torch.randn((rank, s), generator=generator).to(dev) for s in sizes]
    return functools.partial(cp_loss, target), init


def _step(opt, loss_fn, params):
    """One step of ``opt``; returns the loss before it."""
    if isinstance(opt, torch.optim.LBFGS):
        def closure():
            opt.zero_grad()
            loss = loss_fn(params)
            loss.backward()
            return loss
        return opt.step(closure)
    if isinstance(opt, (DenseNewton, KronNewton, LRANewton)):
        return opt.step(lambda: loss_fn(params))
    opt.zero_grad()
    loss = loss_fn(params)
    loss.backward()
    opt.step()
    return loss


def run(name: str, make_opt, loss_fn, init, iters: int = NUM_ITERS):
    """Arm ``name``: ``make_opt(params)`` from a copy of ``init``, one step
    outside the clock, then ``iters`` steps.  Prints and returns its
    summary (the loss at the start, the final and least loss of the timed
    steps, their ms per iteration on the host clock with the losses read
    at the end, the fit steps or None) and the parameters."""
    params = [x.detach().clone().requires_grad_() for x in init]
    opt = make_opt(params)
    start = _step(opt, loss_fn, params).item()
    t0 = time.perf_counter()
    losses = [_step(opt, loss_fn, params).detach() for _ in range(iters)]
    values = torch.stack(losses).tolist()
    dt = time.perf_counter() - t0
    out = {"start": start, "final": values[-1], "min": min(values),
           "ms_per_it": 1e3 * dt / iters, "fit_steps": getattr(opt, "fit_steps", None)}
    print(f"{name:>14s}: final loss {out['final']:.3e}  min {out['min']:.3e}  "
          f"({dt:.1f}s, {out['ms_per_it']:.2f} ms/it)", flush=True)
    return out, params


def arms(device) -> dict:
    """{arm name: make_opt(params)} in the JAX example's order."""
    out = {"SGD": lambda p: torch.optim.SGD(p, lr=SGD_LR),
           "L-BFGS": lambda p: torch.optim.LBFGS(
               p, lr=1.0, max_iter=1, history_size=LBFGS_HISTORY,
               line_search_fn="strong_wolfe")}
    for name, (factory, kw) in PSGD_ARMS.items():
        out[name] = functools.partial(factory, device=device, **NEWTON, **kw)
    return out


def main(argv=None) -> dict:
    """Every arm from the same start; returns {arm name: ``run``'s summary}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--iters", type=int, default=NUM_ITERS)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    loss_fn, init = make_problem(torch.Generator().manual_seed(0), device=device)
    return {name: run(name, make, loss_fn, init, args.iters)[0]
            for name, make in arms(device).items()}


if __name__ == "__main__":
    main()
