"""Hessian-vector products for the Newton fit.

Counterpart of psgd_torch_tpu/optim/hvp.py.  The reference computes Hvps
with double-backward autograd (create_graph=True, psgd.py:917-922) or a
finite-difference perturb-and-restore scheme (psgd.py:923-938); the JAX
package takes the exact product as forward-over-reverse ``jax.jvp`` over
``jax.grad``.  Here the exact product is the reference's double backward
(the two agree in exact arithmetic):

    grads = autograd.grad(loss, params, create_graph=True)
    Hv    = autograd.grad(grads, params, vs)

A loss is a zero-argument closure that reads the parameters (a module's
forward and its loss) and returns a scalar tensor without calling backward.

Attention in the Hvp pass.  The fused attention kernels behind
``scaled_dot_product_attention`` (cuDNN, flash, memory-efficient; on the
CPU the flash kernel) have no derivative of their backward, so the double
backward cannot go through them.  ``hvp_exact`` therefore runs its pass
under ``sdpa_kernel(HVP_ATTENTION)``, PyTorch's math attention (the
softmax written out in differentiable operations), for that pass only:
a named choice of kernel for a differentiable pass, not a fallback.  The
other passes (a plain gradient, the finite-difference gradients) keep the
default backends.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch.nn.attention import SDPBackend, sdpa_kernel

from ..ops import fastrand
from ..ops.linalg import real_dtype_of

# the attention backend of the exact Hvp pass (twice differentiable)
HVP_ATTENTION = SDPBackend.MATH


def rand_like(key, tensors: Sequence[torch.Tensor], draw=None) -> list:
    """White unit-variance probes, one per tensor in the given (pytree)
    order, keyed by ``split(key, len(tensors))`` as JAX ``rand_like_tree``:
    ``fastrand.unit_noise`` per tensor (one noise launch each on CUDA).
    ``draw(kind, keys, shape, dtype)`` replaces the draws (the CPU tests
    replay the JAX probes through it)."""
    keys = fastrand.split(key, len(tensors))
    if draw is not None:
        return [draw("normal", k[None], t.shape, t.dtype)[0].to(t.device)
                for k, t in zip(keys, tensors)]
    return [fastrand.unit_noise(k, t.shape, t.dtype, t.device)
            for k, t in zip(keys, tensors)]


def _filled(grads, params) -> list:
    """Gradients with the unused parameters' None replaced by zeros."""
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(grads, params)]


def gradients(loss: torch.Tensor, params: Sequence[torch.Tensor],
              create_graph: bool = False) -> list:
    """d loss / d params (zeros for parameters the loss does not read),
    without touching ``.grad``."""
    return _filled(torch.autograd.grad(loss, params, create_graph=create_graph,
                                       allow_unused=True), params)


def hvp_exact(loss_fn: Callable[[], torch.Tensor],
              params: Sequence[torch.Tensor], vs: Sequence[torch.Tensor]):
    """(grads, Hvs): the gradient and the exact Hessian-vector products
    H v, by double backward (reference psgd.py:917-922), the pass under
    the math attention ``HVP_ATTENTION``.  Works through
    ``checkpoint(..., use_reentrant=False)`` and through the tensor-parallel
    collectives (``parallel.tensor_parallel``), whose backward is
    differentiable; ``params`` may be DTensors, ``vs`` then DTensors of the
    same placements."""
    params = list(params)
    with torch.enable_grad(), sdpa_kernel(HVP_ATTENTION):
        grads = gradients(loss_fn(), params, create_graph=True)
        # a gradient that does not depend on the parameters adds nothing
        live = [i for i, g in enumerate(grads) if g.requires_grad]
        hv = torch.autograd.grad([grads[i] for i in live], params,
                                 [vs[i] for i in live], allow_unused=True) \
            if live else [None] * len(params)
    return [g.detach() for g in grads], _filled(hv, params)


def hvp_finite_diff(loss_fn: Callable[[], torch.Tensor],
                    params: Sequence[torch.Tensor],
                    vs: Sequence[torch.Tensor], delta: float | None = None):
    """(grads, Hvs) with Hv = (g(p + delta v) - g(p)) / delta, delta =
    eps(real dtype)^(1/2) of the first parameter by default (reference
    psgd.py:923-938).  The parameters are perturbed in place and restored
    to their bits afterwards."""
    params = list(params)
    if delta is None:
        delta = float(torch.finfo(real_dtype_of(params[0].dtype)).eps) ** 0.5
    with torch.enable_grad():
        grads = [g.detach() for g in gradients(loss_fn(), params)]
    saved = [p.detach().clone() for p in params]
    try:
        with torch.no_grad():
            for p, p0, v in zip(params, saved, vs):
                p.copy_(p0 + delta * v)
        with torch.enable_grad():
            grads2 = gradients(loss_fn(), params)
    finally:
        with torch.no_grad():
            for p, p0 in zip(params, saved):
                p.copy_(p0)
    return grads, [(a.detach() - b) / delta for a, b in zip(grads2, grads)]


def make_hvp_fn(loss_fn: Callable[[], torch.Tensor], exact: bool = True):
    """hvp_fn(params, vs) -> (grads, Hvs) over the closure ``loss_fn``."""
    fn = hvp_exact if exact else hvp_finite_diff
    return lambda params, vs: fn(loss_fn, params, vs)
