"""Affine-group preconditioner Q = kron(conj(Q2), Q1) per matrix parameter.

Counterpart of psgd_torch_tpu/precond/affine.py (reference
preconditioned_stochastic_gradient_descent.py:1404-1899):

* ``matrixizer``: the tensor <-> matrix plan, the dim permutation and
  split of least prod(s[:i])^2 + prod(s[i:])^2, the first of least size in
  ``itertools.permutations`` order (reference :1414-1472);
* ``init_affine``: each side triangular, or diagonal when its size is
  below 2, above max_size or above max_skew times the other's (reference
  initQ, :1475-1494);
* ``update_affine``: the (dX, dG) update for all four dense/diagonal side
  combinations, with the '1st' or '2nd' step normalizer (:1507-1610);
* ``update_affine_dropv``: the gradient-whitening update with the probe v
  integrated out where that is cheap (diag/diag, diag/dense-tall,
  dense/diag-short), else the with-v update (:1614-1700);
* ``precond_grad_affine``: P applied (:1704-1720).

The triangular solves run in at least float32.  The 1% balance of the two
sides is a host decision on a pre-drawn uniform (``u_balance``, the JAX
package's uniform(key)); drop-v's fallback takes a pre-drawn standard
normal ``v`` or draws one with ``generator``.  Real and complex
(complex64, complex128) dtypes alike: the products conjugate where the
JAX package's do (the Hermitian form, unlike the other legacy families).
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple, Tuple

import torch

from .. import resolve_device
from ..ops.linalg import (lift2single, lifted_real_dtype, norm_lower_bound,
                          real_dtype_of)
from .legacy import TINY


class MatrixPlan(NamedTuple):
    """The static tensor <-> matrix conversion plan."""
    perm: Tuple[int, ...]       # the permutation applied before the reshape
    inv_perm: Tuple[int, ...]
    tensor_shape: Tuple[int, ...]
    permuted_shape: Tuple[int, ...]
    matrix_shape: Tuple[int, int]


def matrixizer(shape) -> MatrixPlan:
    """The dim permutation and split of least preconditioner size
    prod(s[:i])^2 + prod(s[i:])^2 (reference :1414-1472); a tie keeps the
    first found."""
    shape = tuple(int(s) for s in shape)
    if len(shape) == 2:
        return MatrixPlan((0, 1), (0, 1), shape, shape, shape)
    if len(shape) < 2:
        p = tuple(range(len(shape)))
        return MatrixPlan(p, p, shape, shape, (1, math.prod(shape)))
    best = None
    for p in itertools.permutations(range(len(shape))):
        s = tuple(shape[j] for j in p)
        for i in range(1, len(p)):
            size = math.prod(s[:i]) ** 2 + math.prod(s[i:]) ** 2
            if best is None or size < best[0]:
                best = (size, p, s, i)
    _, p, s, i = best
    inv = tuple(k for k, _ in sorted(enumerate(p), key=lambda t: t[1]))
    return MatrixPlan(p, inv, shape, s, (math.prod(s[:i]), math.prod(s[i:])))


def to_matrix(plan: MatrixPlan, t: torch.Tensor) -> torch.Tensor:
    if len(plan.tensor_shape) == 2:
        return t
    return t.permute(plan.perm).reshape(plan.matrix_shape)


def from_matrix(plan: MatrixPlan, m: torch.Tensor) -> torch.Tensor:
    if len(plan.tensor_shape) == 2:
        return m
    return m.reshape(plan.permuted_shape).permute(plan.inv_perm)


class AffineState(NamedTuple):
    ql: torch.Tensor   # (m, m) upper triangular or (m,) diagonal
    qr: torch.Tensor   # (n, n) upper triangular or (n,) diagonal


def init_affine(matrix_shape, scale: float = 1.0,
                max_size: float = float("inf"), max_skew: float = float("inf"),
                dtype=torch.float32, device=None) -> AffineState:
    """Q1 = Q2 = sqrt(scale) I, each diagonal when its size is below 2,
    above ``max_size`` or above ``max_skew`` times the other side's
    (reference initQ, :1475-1494); on the card unless ``device`` names
    another device."""
    device = resolve_device(device)
    s1, s2 = matrix_shape
    root = scale ** 0.5

    def side(s, other):
        if s < 2 or s > max_size or s > max_skew * other:
            return root * torch.ones((s,), dtype=dtype, device=device)
        return root * torch.eye(s, dtype=dtype, device=device)

    return AffineState(ql=side(s1, s2), qr=side(s2, s1))


def _tri_solve_left(a, b) -> torch.Tensor:
    """inv(A^H) B with A upper triangular, in at least float32."""
    return torch.linalg.solve_triangular(
        lift2single(a.mH), lift2single(b), upper=False).to(b.dtype)


def _tri_solve_right(a, b) -> torch.Tensor:
    """B inv(A) with A upper triangular, in at least float32."""
    return torch.linalg.solve_triangular(
        lift2single(a), lift2single(b), upper=True, left=False).to(b.dtype)


def _maybe_balance(ql, qr, u_balance: float, prob: float = 0.01):
    """The sides' dynamic ranges balanced when ``u_balance`` < ``prob``."""
    if not u_balance < prob:
        return ql, qr
    acc = lifted_real_dtype(ql.dtype)
    rho = torch.sqrt(torch.max(torch.abs(ql)).to(acc)
                     / torch.max(torch.abs(qr)).to(acc))
    return (ql / rho.to(real_dtype_of(ql.dtype)),
            qr * rho.to(real_dtype_of(qr.dtype)))


def _energy(x, dim):
    return torch.sum(x * torch.conj(x), dim=dim)


def _steps(lr, step_normalizer, tiny, rdt, pair1, pair2):
    """(s1, s2) from each side's (sum, difference, dense): the '2nd'
    normalizer bounds the sum, the '1st' the difference; a dense side's
    bound is ``norm_lower_bound``, a diagonal one's the max."""
    out = []
    for total, diff, dense in (pair1, pair2):
        if dense:
            bound = norm_lower_bound(total if step_normalizer == "2nd" else diff)
        elif step_normalizer == "2nd":
            bound = torch.max(torch.real(total))
        else:
            bound = torch.max(torch.abs(diff))
        out.append(lr / (bound.to(rdt) + tiny))
    return out


def update_affine(state: AffineState, dx: torch.Tensor, dg: torch.Tensor, *,
                  u_balance: float, lr: float = 0.01,
                  step_normalizer: str = "2nd",
                  tiny: float = TINY) -> AffineState:
    """One update from a (dX, dG) = (v, H v) or (v, damped g) pair, the
    sides balanced first when ``u_balance`` < 0.01 (reference
    update_precond_affine_math_, :1507-1610; all four side
    combinations)."""
    ql, qr = _maybe_balance(state.ql, state.qr, u_balance)
    l_dense, r_dense = ql.ndim == 2, qr.ndim == 2
    rdt = real_dtype_of(ql.dtype)
    steps = lambda p1, p2: _steps(lr, step_normalizer, tiny, rdt, p1, p2)  # noqa: E731

    if l_dense and r_dense:
        a = ql @ dg @ qr.mH
        bh = _tri_solve_left(ql, _tri_solve_right(qr, dx))
        aha, bhb = a.mH @ a, bh @ bh.mH
        aah, bbh = a @ a.mH, bh.mH @ bh
        grad1, grad2 = torch.triu(aah - bhb), torch.triu(aha - bbh)
        s1, s2 = steps((aah + bhb, grad1, True), (aha + bbh, grad2, True))
        return AffineState(ql - s1 * (grad1 @ ql), qr - s2 * (grad2 @ qr))

    if l_dense:
        a = ql @ (dg * torch.conj(qr))
        bh = _tri_solve_left(ql, dx / qr)
        aah, bhb = a @ a.mH, bh @ bh.mH
        aac, bbc = _energy(a, 0), _energy(bh, 0)
        grad1, grad2 = torch.triu(aah - bhb), aac - bbc
        s1, s2 = steps((aah + bhb, grad1, True), (aac + bbc, grad2, False))
        return AffineState(ql - s1 * (grad1 @ ql), qr - s2 * grad2 * qr)

    if r_dense:
        a = (ql[:, None] * dg) @ qr.mH
        bh = _tri_solve_right(qr, dx) / torch.conj(ql)[:, None]
        aac, bbc = _energy(a, 1), _energy(bh, 1)
        aha, bbh = a.mH @ a, bh.mH @ bh
        grad1, grad2 = aac - bbc, torch.triu(aha - bbh)
        s1, s2 = steps((aac + bbc, grad1, False), (aha + bbh, grad2, True))
        return AffineState(ql - s1 * grad1 * ql, qr - s2 * (grad2 @ qr))

    a = ql[:, None] * dg * torch.conj(qr)
    bh = dx / qr / torch.conj(ql)[:, None]
    aac1, bbc1 = _energy(a, 1), _energy(bh, 1)
    aac2, bbc2 = _energy(a, 0), _energy(bh, 0)
    grad1, grad2 = aac1 - bbc1, aac2 - bbc2
    s1, s2 = steps((aac1 + bbc1, grad1, False), (aac2 + bbc2, grad2, False))
    return AffineState(ql - s1 * grad1 * ql, qr - s2 * grad2 * qr)


def dropv_branch(state: AffineState) -> bool:
    """Whether ``update_affine_dropv`` integrates v out for these sides
    (diag/diag, diag/dense-tall, dense/diag-short), else it draws v."""
    ql, qr = state
    if ql.ndim == 1 and qr.ndim == 1:
        return True
    if ql.ndim == 1:
        return ql.shape[0] >= qr.shape[0]
    return qr.ndim == 1 and qr.shape[0] >= ql.shape[0]


def update_affine_dropv(state: AffineState, dg: torch.Tensor, *,
                        u_balance: float, lr: float = 0.01,
                        step_normalizer: str = "2nd", tiny: float = TINY,
                        v: torch.Tensor | None = None,
                        generator: torch.Generator | None = None) -> AffineState:
    """The whitening update with v integrated out where cheap (reference
    :1614-1700), the sides balanced after it when ``u_balance`` < 0.01;
    otherwise ``update_affine`` from (v, dg), ``v`` the pre-drawn standard
    normal (JAX: normal(kv), (kb, kv) = split(key), uniform(kb) the
    balance's) or one drawn with ``generator``."""
    ql, qr = state
    if not dropv_branch(state):
        if v is None:
            v = torch.randn(dg.shape, dtype=dg.dtype, device=dg.device,
                            generator=generator)
        return update_affine(AffineState(ql, qr), v, dg, u_balance=u_balance,
                             lr=lr, step_normalizer=step_normalizer, tiny=tiny)
    rdt = real_dtype_of(ql.dtype)
    steps = lambda p1, p2: _steps(lr, step_normalizer, tiny, rdt, p1, p2)  # noqa: E731

    if ql.ndim == 1 and qr.ndim == 1:
        a = ql[:, None] * dg * torch.conj(qr)
        inv_qql = 1.0 / (ql * torch.conj(ql))
        inv_qqr = 1.0 / (qr * torch.conj(qr))
        aac1, bbc1 = _energy(a, 1), torch.sum(inv_qqr) * inv_qql
        aac2, bbc2 = _energy(a, 0), torch.sum(inv_qql) * inv_qqr
        grad1, grad2 = aac1 - bbc1, aac2 - bbc2
        s1, s2 = steps((aac1 + bbc1, grad1, False), (aac2 + bbc2, grad2, False))
        ql, qr = ql - s1 * grad1 * ql, qr - s2 * grad2 * qr
    elif ql.ndim == 1:
        a = (ql[:, None] * dg) @ qr.mH
        inv_qql = 1.0 / (ql * torch.conj(ql))
        eye = torch.eye(qr.shape[0], dtype=qr.dtype, device=qr.device)
        inv_qr = _tri_solve_right(qr, eye)
        inv_qqr = inv_qr.mH @ inv_qr
        aac = _energy(a, 1)
        bbc = torch.real(torch.trace(inv_qqr)) * inv_qql
        aha = a.mH @ a
        bbh = torch.sum(inv_qql) * inv_qqr
        grad1, grad2 = aac - bbc, torch.triu(aha - bbh)
        s1, s2 = steps((aac + bbc, grad1, False), (aha + bbh, grad2, True))
        ql, qr = ql - s1 * grad1 * ql, qr - s2 * (grad2 @ qr)
    else:
        a = ql @ (dg * torch.conj(qr))
        eye = torch.eye(ql.shape[0], dtype=ql.dtype, device=ql.device)
        inv_ql = _tri_solve_right(ql, eye)
        inv_qql = inv_ql.mH @ inv_ql
        inv_qqr = 1.0 / (qr * torch.conj(qr))
        aah = a @ a.mH
        bhb = torch.sum(inv_qqr) * inv_qql
        aac = _energy(a, 0)
        bbc = torch.real(torch.trace(inv_qql)) * inv_qqr
        grad1, grad2 = torch.triu(aah - bhb), aac - bbc
        s1, s2 = steps((aah + bhb, grad1, True), (aac + bbc, grad2, False))
        ql, qr = ql - s1 * (grad1 @ ql), qr - s2 * grad2 * qr
    return AffineState(*_maybe_balance(ql, qr, u_balance))


def precond_grad_affine(state: AffineState, grad: torch.Tensor) -> torch.Tensor:
    """P grad = Q1^H Q1 grad (Q2^H Q2)^T (reference :1704-1720)."""
    ql, qr = state
    if ql.ndim == 2:
        out = ql.mH @ (ql @ grad)
    else:
        out = (ql * torch.conj(ql))[:, None] * grad
    if qr.ndim == 2:
        return (out @ qr.mH) @ qr
    return out * (qr * torch.conj(qr))
