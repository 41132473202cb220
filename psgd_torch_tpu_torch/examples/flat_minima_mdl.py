"""Why PSGD generalizes: a description-length (MDL) view.

Counterpart of examples/flat_minima_mdl.py (reference study
misc/how_psgd_generalize.py).  The same LeNet5 (seed 42) is trained on the
same batches by ``torch.optim.Adam(1e-3)`` (optax.adam's defaults) and by
``kron_whiten`` (lr 1e-3, momentum 0.9, max_skew 2); then log det(H) at
each solution is estimated by fitting a dummy LRA preconditioner (rank
10) to exact (v, H v) pairs on a fixed batch of 512: at the fixed point
P = H^-1, so log det(H) = -2 log det(Q) = -2 (sum log d + log det(I +
Vᵀ U)).  A flatter minimum (smaller log det H) needs fewer bits to encode
its parameters.

The fit (``estimate_logdet_hessian``) follows the JAX key tree with the
port's host threefry keys (``ops.fastrand``): the state from fold_in(key,
0), fit i keyed k = fold_in(key, 100 + i), its probe v from k
(``fastrand.unit_noise``: white unit-variance noise where the JAX example
draws a normal; one noise launch on the card), H v by double backward
(``optim.hvp.hvp_exact``) where JAX takes ``jax.jvp`` over ``jax.grad``
(equal to rounding), then ``lra.update_lra_newton`` keyed fold_in(k, 1)
with damping 1e-9 and lr 0.1 * 0.01^(i / steps).

Runs on the card unless ``--device`` names another device:

    python -m psgd_torch_tpu_torch.examples.flat_minima_mdl [--device cpu]
        [--train_steps 400] [--hess_steps 300]
"""

from __future__ import annotations

import argparse
import functools
import time

import torch

from .. import resolve_device
from ..models import lenet5
from ..ops import fastrand
from ..optim import hvp, kron_whiten
from ..precond import lra

TRAIN_STEPS = 400
HESS_STEPS = 300
BATCH = 64
HESS_BATCH = 512
RANK = 10
DAMPING = 1e-9
KRON = dict(learning_rate=1e-3, momentum=0.9, preconditioner_max_skew=2.0)
# the JAX example's key(0), and the fit's fold_in(key, 7)
KEY = fastrand.prng_key(0)
HESS_KEY = fastrand.fold_in(KEY, 7)


def train(name: str, make_opt, generator: torch.Generator,
          steps: int = TRAIN_STEPS, device=None):
    """LeNet5 from seed 42 trained ``steps`` steps by ``make_opt(params)``
    on ``lenet5.synthetic_mnist`` batches of ``BATCH`` drawn from
    ``generator``.
    Returns (the parameters, {the first and the last step's loss, the ms
    per step (host clock, the losses read at the end), the fit steps or
    None})."""
    dev = resolve_device(device)
    params = lenet5.init_lenet5(torch.Generator().manual_seed(42), device=dev)
    opt = make_opt(params)
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        images, labels = lenet5.synthetic_mnist(generator, BATCH, device=dev)
        opt.zero_grad()
        loss = lenet5.loss_lenet5(params, images, labels)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    values = torch.stack(losses).tolist()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    return params, {"first_loss": values[0], "train_loss": values[-1],
                    "ms_per_it": ms, "fit_steps": getattr(opt, "fit_steps", None)}


def _unflatten(vec: torch.Tensor, shapes) -> list:
    """``torch.nn.utils.vector_to_parameters``'s split, kept in the autograd
    graph (that function copies into ``.data``)."""
    sizes = [torch.Size(s).numel() for s in shapes]
    return [x.view(s) for x, s in zip(torch.split(vec, sizes), shapes)]


def estimate_logdet_hessian(params, generator: torch.Generator,
                            steps: int = HESS_STEPS, data=None,
                            draw=None) -> float:
    """-2 log det(Q) of a rank-``RANK`` LRA preconditioner fitted by
    ``steps`` Newton fits (module docstring, keyed by ``HESS_KEY``) at the
    fixed ``params``, the loss taken on ``HESS_BATCH`` images drawn from
    ``generator`` (or on ``data`` = (images, labels)).  The parameters are flattened by
    ``torch.nn.utils.parameters_to_vector`` in their list order, the five
    [W; b] matrices of LeNet5 layer by layer, each row-major: the order
    ``jax.flatten_util.ravel_pytree`` gives the JAX LeNet5's list of the
    same matrices (the CPU tests depend on it).  ``draw`` replays another
    package's draws (the init, the probes as normals, the damping and the
    coin)."""
    vec = torch.nn.utils.parameters_to_vector(params).detach()
    shapes = [p.shape for p in params]
    st = lra.init_lra(vec.numel(), RANK, fastrand.fold_in(HESS_KEY, 0), 1.0,
                      vec.dtype, vec.device, draw)
    images, labels = data if data is not None else lenet5.synthetic_mnist(
        generator, HESS_BATCH, device=vec.device)
    x = vec.clone().requires_grad_()

    def loss():
        return lenet5.loss_lenet5(_unflatten(x, shapes), images, labels)

    for i in range(steps):
        lr = 0.1 * (0.01 ** (i / steps))   # annealed as the reference
        k = fastrand.fold_in(HESS_KEY, 100 + i)
        v = (fastrand.unit_noise(k, vec.shape, vec.dtype, vec.device) if draw is None
             else draw("normal", k[None], vec.shape, vec.dtype)[0].to(vec.device))
        _, (hv,) = hvp.hvp_exact(loss, [x], [v])
        st = lra.update_lra_newton(st, v, hv, fastrand.fold_in(k, 1), lr=lr,
                                   damping=DAMPING, draw=draw)
    return -2.0 * float(lra.log_det(st))


def arms(device) -> dict:
    """{arm name: make_opt(params)} in the JAX example's order."""
    return {"adam": lambda p: torch.optim.Adam(p, lr=1e-3),
            "psgd-kron": functools.partial(kron_whiten, device=device, **KRON)}


def main(argv=None) -> dict:
    """Both arms; returns {arm name: ``train``'s result with ``logdet_h``
    and ``fit_ms`` (the log-det fit's ms per fit)}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--train_steps", type=int, default=TRAIN_STEPS)
    ap.add_argument("--hess_steps", type=int, default=HESS_STEPS)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = {}
    for name, make in arms(device).items():
        params, res = train(name, make, torch.Generator().manual_seed(0),
                            args.train_steps, device=device)
        t0 = time.perf_counter()
        res["logdet_h"] = estimate_logdet_hessian(
            params, torch.Generator().manual_seed(1), args.hess_steps)
        res["fit_ms"] = (time.perf_counter() - t0) * 1e3 / max(args.hess_steps, 1)
        print(f"{name:>10s}: train loss {res['train_loss']:.4f}   "
              f"log det(Hessian) ~ {res['logdet_h']:.1f}   "
              f"(smaller = flatter = shorter description length)", flush=True)
        out[name] = res
    return out


if __name__ == "__main__":
    main()
