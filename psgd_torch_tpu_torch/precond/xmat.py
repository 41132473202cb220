"""X-matrix preconditioner: Q = diag(a) + adiag(b).

Counterpart of psgd_torch_tpu/precond/xmat.py (reference
preconditioned_stochastic_gradient_descent.py:947-991): slightly richer
than a diagonal preconditioner at the same O(n) cost, the anti-diagonal
coupling entry i with entry n-1-i.  For odd n the middle anti-diagonal
entry's gradient is zeroed on every update (reference :971-973).
Elementwise passes and flips only.  Complex a and b take the JAX
package's forms: products without conjugates, and the '2nd' normalizer's
complex maximum cast to the real dtype, its real part (the largest real
part).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from ..ops.linalg import real_dtype_of
from .legacy import TINY


class XMatState(NamedTuple):
    a: torch.Tensor   # (n,) diagonal
    b: torch.Tensor   # (n,) anti-diagonal


def init_xmat(n: int, scale: float = 1.0, dtype=torch.float32,
              device=None) -> XMatState:
    device = resolve_device(device)
    return XMatState(a=scale * torch.ones((n,), dtype=dtype, device=device),
                     b=torch.zeros((n,), dtype=dtype, device=device))


def _flip(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(x, (0,))


def update_xmat(state: XMatState, v: torch.Tensor, h: torch.Tensor,
                lr: float = 0.1, step_normalizer: str = "2nd",
                tiny: float = TINY) -> XMatState:
    """One update from a (v, h) pair (reference update_precond_Xmat_math_,
    :957-981)."""
    a, b = state
    v, h = v.reshape(-1), h.reshape(-1)
    qh = a * h + b * _flip(h)
    aflip, bflip = _flip(a), _flip(b)
    inv_qtv = (aflip * v - bflip * _flip(v)) / (a * aflip - b * bflip)

    u_, w_ = qh * qh, inv_qtv * inv_qtv
    nabla_a = u_ - w_
    nabla_b = qh * _flip(qh) - inv_qtv * _flip(inv_qtv)
    n = nabla_b.shape[0]
    if n % 2 == 1:    # zero the central anti-diagonal coupling (odd n)
        nabla_b[n // 2] = 0.0

    rdt = real_dtype_of(a.dtype)
    if step_normalizer == "2nd":
        mu = lr / (torch.max(torch.real(u_ + w_)).to(rdt) + tiny)
    else:
        mu = lr / (torch.maximum(torch.max(torch.abs(nabla_a)),
                                 torch.max(torch.abs(nabla_b))).to(rdt) + tiny)
    return XMatState(a=a - mu * (nabla_a * a + nabla_b * bflip),
                     b=b - mu * (nabla_a * b + nabla_b * aflip))


def update_xmat_whiten(state: XMatState, g: torch.Tensor, lr: float = 0.1,
                       step_normalizer: str = "2nd", damping: float = 1e-9, *,
                       v: torch.Tensor | None = None,
                       generator: torch.Generator | None = None) -> XMatState:
    """The whitening update: the standard normal probe ``v`` (drawn with
    ``generator`` on g's device if not given) and g damped by
    (damping + eps |g|) v."""
    g = g.reshape(-1)
    if v is None:
        v = torch.randn(g.shape, dtype=g.dtype, device=g.device,
                        generator=generator)
    v = v.reshape(-1)
    eps = torch.finfo(real_dtype_of(g.dtype)).eps
    return update_xmat(state, v, g + (damping + eps * torch.abs(g)) * v,
                       lr=lr, step_normalizer=step_normalizer)


def precond_grad_xmat(state: XMatState, g: torch.Tensor) -> torch.Tensor:
    """P g with P = Q^T Q (reference precond_grad_Xmat_math, :984-990)."""
    a, b = state
    x = g.reshape(-1)
    ab = a * b
    out = (a * a + _flip(b * b)) * x + (ab + _flip(ab)) * _flip(x)
    return out.reshape(g.shape)
