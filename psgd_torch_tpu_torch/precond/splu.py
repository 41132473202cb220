"""Sparse-LU preconditioner: P = Q^T Q with Q = L U,
L = [L1 0; L2 diag(l3)], U = [U1 U2; 0 diag(u3)] and rank-r dense corners.

Counterpart of psgd_torch_tpu/precond/splu.py (reference
preconditioned_stochastic_gradient_descent.py:480-617).  Cost is O(r n) per
step, between the diagonal and the dense preconditioners.  The triangular
solves on the r x r corners run in at least float32.  Complex factors take
the JAX package's forms (plain transposes; the balance's maxima in JAX's
order of complex numbers, ``jax_max`` / ``jax_maximum``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from ..ops.linalg import (jax_max, jax_maximum, lift2single, norm_lower_bound,
                          real_dtype_of)
from .legacy import TINY


class SPLUState(NamedTuple):
    l12: torch.Tensor   # (n, r): [L1 (r x r); L2 (n-r x r)]
    l3: torch.Tensor    # (n - r, 1)
    u12: torch.Tensor   # (r, n): [U1 (r x r), U2 (r x n-r)]
    u3: torch.Tensor    # (n - r, 1)


def init_splu(n: int, r: int, scale: float = 1.0, dtype=torch.float32,
              device=None) -> SPLUState:
    """L = U = sqrt(scale) I, on the card unless ``device`` names another
    device."""
    if not 0 < r < n:
        raise ValueError(f"rank r={r} must be in (0, n={n})")
    device = resolve_device(device)
    root = scale ** 0.5
    eye = torch.eye(r, dtype=dtype, device=device)
    zeros = torch.zeros((n - r, r), dtype=dtype, device=device)
    ones = torch.ones((n - r, 1), dtype=dtype, device=device)
    return SPLUState(l12=root * torch.cat([eye, zeros]), l3=root * ones,
                     u12=root * torch.cat([eye, zeros.T], dim=1), u3=root * ones)


def _tri(a, b, lower: bool, trans: bool = False) -> torch.Tensor:
    """a^-1 b, or a^-T b with ``trans``, in at least float32."""
    if trans:
        a, lower = a.T, not lower
    return torch.linalg.solve_triangular(
        lift2single(a), lift2single(b), upper=not lower).to(b.dtype)


def update_splu(state: SPLUState, v: torch.Tensor, h: torch.Tensor,
                lr: float = 0.01, tiny: float = TINY) -> SPLUState:
    """One update from a (v, h) = (dx, dg) pair (reference
    update_precond_splu, :481-572)."""
    l12, l3, u12, u3 = state
    r = u12.shape[0]
    rdt = real_dtype_of(l12.dtype)

    # balance the dynamic ranges of L and U (reference :497-503)
    max_l = jax_maximum(jax_max(torch.diagonal(l12[:r])), jax_max(l3))
    max_u = jax_maximum(jax_max(torch.diagonal(u12[:, :r])), jax_max(u3))
    rho = torch.sqrt(max_l / max_u)
    l12, l3 = l12 / rho, l3 / rho
    u12, u3 = u12 * rho, u3 * rho

    l1, l2 = l12[:r], l12[r:]
    u1, u2 = u12[:, :r], u12[:, r:]
    dx, dg = v.reshape(-1, 1), h.reshape(-1, 1)

    # U dg, Q dg
    ug1 = u1 @ dg[:r] + u2 @ dg[r:]
    ug2 = u3 * dg[r:]
    qg1 = l1 @ ug1
    qg2 = l2 @ ug1 + l3 * ug2
    # inv(U^T) dx, inv(Q^T) dx
    iutx1 = _tri(u1, dx[:r], lower=False, trans=True)
    iutx2 = (dx[r:] - u2.T @ iutx1) / u3
    iqtx2 = iutx2 / l3
    iqtx1 = _tri(l1, iutx1 - l2.T @ iqtx2, lower=True, trans=True)
    # L^T Q dg, P dg
    ltqg1 = l1.T @ qg1 + l2.T @ qg2
    ltqg2 = l3 * qg2
    pg1 = u1.T @ ltqg1
    pg2 = u2.T @ ltqg1 + u3 * ltqg2
    # inv(L) inv(Q^T) dx, inv(P) dx
    iliqtx1 = _tri(l1, iqtx1, lower=True)
    iliqtx2 = (iqtx2 - l2 @ iliqtx1) / l3
    ipx2 = iliqtx2 / u3
    ipx1 = _tri(u1, iliqtx1 - u2 @ ipx2, lower=False)

    # update L (reference :544-556)
    grad1 = torch.tril(qg1 @ qg1.T - iqtx1 @ iqtx1.T)
    grad2 = qg2 @ qg1.T - iqtx2 @ iqtx1.T
    grad3 = qg2 * qg2 - iqtx2 * iqtx2
    step0 = lr / (torch.maximum(
        norm_lower_bound(torch.cat([grad1, grad2], dim=0)),
        torch.max(torch.abs(grad3))).to(rdt) + tiny)
    new_l1 = l1 - step0 * (grad1 @ l1)
    new_l2 = l2 - step0 * (grad2 @ l1) - step0 * grad3 * l2
    new_l3 = l3 - step0 * grad3 * l3

    # update U (reference :558-570)
    grad1u = torch.triu(pg1 @ dg[:r].T - dx[:r] @ ipx1.T)
    grad2u = pg1 @ dg[r:].T - dx[:r] @ ipx2.T
    grad3u = pg2 * dg[r:] - dx[r:] * ipx2
    step0u = lr / (torch.maximum(
        norm_lower_bound(torch.cat([grad1u, grad2u], dim=1)),
        torch.max(torch.abs(grad3u))).to(rdt) + tiny)
    new_u1 = u1 - u1 @ (step0u * grad1u)
    new_u2 = u2 - u1 @ (step0u * grad2u) - step0u * grad3u.T * u2
    new_u3 = u3 - step0u * grad3u * u3

    return SPLUState(l12=torch.cat([new_l1, new_l2], dim=0), l3=new_l3,
                     u12=torch.cat([new_u1, new_u2], dim=1), u3=new_u3)


def precond_grad_splu(state: SPLUState, g: torch.Tensor) -> torch.Tensor:
    """P g (reference precond_grad_splu, :575-609)."""
    l12, l3, u12, u3 = state
    r = u12.shape[0]
    l1, l2 = l12[:r], l12[r:]
    u1, u2 = u12[:, :r], u12[:, r:]
    x = g.reshape(-1, 1)
    ug1 = u1 @ x[:r] + u2 @ x[r:]
    ug2 = u3 * x[r:]
    qg1 = l1 @ ug1
    qg2 = l2 @ ug1 + l3 * ug2
    ltqg1 = l1.T @ qg1 + l2.T @ qg2
    ltqg2 = l3 * qg2
    return torch.cat([u1.T @ ltqg1, u2.T @ ltqg1 + u3 * ltqg2]).reshape(g.shape)
