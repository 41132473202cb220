"""Legacy functional preconditioners of the reference's original
implementation: the (dx, dg)-pair APIs of the classic demos
(mnist_with_lenet5.py, lstm_with_xor_problem.py).

Counterpart of psgd_torch_tpu/precond/legacy.py:

* the legacy dense P (reference preconditioned...py:122-164);
* the shape-dispatching matrix Kron preconditioner with its four kernels:
  (dense, dense) :243-287, (normalization, dense) :293-356,
  (normalization, scaling) :363-426, (dense, scaling) :431-475;
* the classic Newton preconditioner with a maintained inverse by rank-2
  Woodbury updates (:1171-1213), and its triangular-group twin;
* the legacy UVd/LRA update with the '1st'/'2nd' step normalizers
  (:657-753).

A "normalization" factor is the (2, M) Lie group: row 0 the diagonal, row 1
the last column (feature normalization); a "scaling" factor is a (1, N)
diagonal.  Every function is pure and returns new state.  Triangular
solves (``torch.linalg.solve_triangular``) and UVd's r x r LU
(``torch.linalg.lu_factor_ex`` and ``lu_solve``, which check nothing on the
host) run in at least float32.  The products, solves and elementwise
passes are plain PyTorch, as the JAX package computes them outside any
Pallas kernel.  UVd's two random decisions (the 1% balance and the U-or-V
coin) take pre-drawn uniforms, its init pre-drawn normals.

Complex (complex64, complex128) factors take the JAX package's forms:
every product and solve transposes where a Hermitian preconditioner would
conjugate (P = Q^T Q), UVd's solve with (I + V^T U)^T included (JAX
``lu_solve(..., trans=1)``, ``linalg.lu_solve_t``); the balancing reads the
largest diagonal entry in JAX's order of complex numbers (``jax_max``),
and a complex step size cast to the real dtype keeps its real part (JAX's
``astype``), as do UVd's '2nd' minimum and the Newton '2nd' sums.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from ..ops.linalg import (jax_max, lift2single, lu_solve_t, norm_lower_bound,
                          real_dtype_of, woodbury_identity)

TINY = 1.2e-38


def _solve(a, b, upper: bool, left: bool = True) -> torch.Tensor:
    """a^-1 b (``left``) or b a^-1 with a triangular, in at least float32,
    cast back to b's dtype."""
    return torch.linalg.solve_triangular(
        lift2single(a), lift2single(b), upper=upper, left=left).to(b.dtype)


def _tri_left(a, b, lower: bool, trans: bool = False) -> torch.Tensor:
    """a^-1 b, or a^-T b with ``trans`` (JAX triangular_solve with a
    transposed, its triangle flipped)."""
    return _solve(a.T, b, upper=lower) if trans else _solve(a, b, upper=not lower)


def _tri_right(a, b) -> torch.Tensor:
    """b a^-1, a upper triangular."""
    return _solve(a, b, upper=True, left=False)


def _step(lr: float, bound: torch.Tensor, rdt, tiny: float) -> torch.Tensor:
    return lr / (bound.real.to(rdt) + tiny)


def _rho(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """sqrt(max left / max right), the balance of two sides' dynamic
    ranges (complex: each max in JAX's order, the principal root)."""
    return torch.sqrt(jax_max(left) / jax_max(right))


# ---------------------------------------------------------------------------
# legacy dense preconditioner (:122-164)
# ---------------------------------------------------------------------------


def update_precond_dense(q: torch.Tensor, dx: torch.Tensor, dg: torch.Tensor,
                         lr: float = 0.01, tiny: float = TINY) -> torch.Tensor:
    """P = Q^T Q over the concatenated parameter vector; Q upper
    triangular."""
    dx, dg = dx.reshape(-1, 1), dg.reshape(-1, 1)
    a = q @ dg
    b = _tri_left(q, dx, lower=False, trans=True)
    grad = torch.triu(a @ a.T - b @ b.T)
    return q - _step(lr, norm_lower_bound(grad), real_dtype_of(q.dtype),
                     tiny) * (grad @ q)


def precond_grad_dense(q: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return (q.T @ (q @ g.reshape(-1, 1))).reshape(g.shape)


# ---------------------------------------------------------------------------
# legacy matrix Kron kernels and shape dispatcher (:168-475)
# ---------------------------------------------------------------------------


def init_kron_legacy(shape, kind_l: str = "dense", kind_r: str = "dense",
                     scale: float = 1.0, dtype=torch.float32, device=None):
    """(Ql, Qr) for a matrix parameter, each side's kind 'dense' ((n, n)
    identity), 'norm' ((2, n) [ones; zeros]) or 'scale' ((1, n) ones),
    times ``scale`` (reference demo setups, mnist_with_lenet5.py:53)."""
    device = resolve_device(device)
    m, n = shape

    def side(kind, s):
        if kind == "dense":
            return scale * torch.eye(s, dtype=dtype, device=device)
        if kind == "norm":
            return torch.cat([scale * torch.ones((1, s), dtype=dtype, device=device),
                              torch.zeros((1, s), dtype=dtype, device=device)])
        if kind == "scale":
            return scale * torch.ones((1, s), dtype=dtype, device=device)
        raise ValueError(f"unknown factor kind {kind!r}")

    return side(kind_l, m), side(kind_r, n)


def update_precond_kron(ql, qr, dx, dg, lr: float = 0.01, tiny: float = TINY):
    """The shape-dispatching update (reference :168-203): per side, m == n
    dense, m == 2 normalization, m == 1 scaling; a pair with the richer
    kind on the right runs transposed."""
    m, n = ql.shape
    p, q = qr.shape
    if m == n:
        if p == q:
            return _update_dense_dense(ql, qr, dx, dg, lr, tiny)
        if p == 2:
            out = _update_norm_dense(qr, ql, dx.T, dg.T, lr, tiny)
            return out[1], out[0]
        if p == 1:
            return _update_dense_scale(ql, qr, dx, dg, lr, tiny)
    elif m == 2:
        if p == q:
            return _update_norm_dense(ql, qr, dx, dg, lr, tiny)
        if p == 1:
            return _update_norm_scale(ql, qr, dx, dg, lr, tiny)
    elif m == 1:
        if p == q:
            out = _update_dense_scale(qr, ql, dx.T, dg.T, lr, tiny)
            return out[1], out[0]
        if p == 2:
            out = _update_norm_scale(qr, ql, dx.T, dg.T, lr, tiny)
            return out[1], out[0]
    raise ValueError("Unknown Kronecker product preconditioner shapes")


def precond_grad_kron(ql, qr, grad):
    """The shape-dispatching apply (reference :206-238)."""
    m, n = ql.shape
    p, q = qr.shape
    if m == n:
        if p == q:
            return _grad_dense_dense(ql, qr, grad)
        if p == 2:
            return _grad_norm_dense(qr, ql, grad.T).T
        if p == 1:
            return _grad_dense_scale(ql, qr, grad)
    elif m == 2:
        if p == q:
            return _grad_norm_dense(ql, qr, grad)
        if p == 1:
            return _grad_norm_scale(ql, qr, grad)
    elif m == 1:
        if p == q:
            return _grad_dense_scale(qr, ql, grad.T).T
        if p == 2:
            return _grad_norm_scale(qr, ql, grad.T).T
    raise ValueError("Unknown Kronecker product preconditioner shapes")


def _update_dense_dense(ql, qr, dx, dg, lr, tiny):
    """(dense, dense) with dynamic-range balancing (reference :243-275)."""
    rdt = real_dtype_of(ql.dtype)
    rho = _rho(torch.diagonal(ql), torch.diagonal(qr))
    ql, qr = ql / rho, qr * rho
    a = ql @ dg @ qr.T
    bt = _tri_left(ql, _tri_right(qr, dx), lower=False, trans=True)
    grad1 = torch.triu(a @ a.T - bt @ bt.T)
    grad2 = torch.triu(a.T @ a - bt.T @ bt)
    s1 = _step(lr, norm_lower_bound(grad1), rdt, tiny)
    s2 = _step(lr, norm_lower_bound(grad2), rdt, tiny)
    return ql - s1 * (grad1 @ ql), qr - s2 * (grad2 @ qr)


def _grad_dense_dense(ql, qr, grad):
    return ql.T @ ql @ grad @ qr.T @ qr


def _norm_apply(ql, x):
    """Ql x with the (2, M) normalization factor: diagonal + last column."""
    return ql[0:1].T * x + ql[1:].T @ x[-1:]


def _norm_inv_t_apply(ql, x):
    """inv(Ql)^T x."""
    bt = x / ql[0:1].T
    return torch.cat([bt[:-1],
                      bt[-1:] - (ql[1:] / (ql[0:1] * ql[0, -1])) @ x])


def _norm_side_step(ql, a, bt, lr, rdt, tiny):
    """The (2, M) normalization factor's step from a and bt."""
    grad_diag = torch.sum(a * a, dim=1) - torch.sum(bt * bt, dim=1)
    grad_bias = (a[:-1] @ a[-1:].T - bt[:-1] @ bt[-1:].T)[:, 0]
    grad_bias = torch.cat([grad_bias, grad_bias.new_zeros(1)])
    s = _step(lr, torch.maximum(torch.max(torch.abs(grad_diag)),
                                torch.max(torch.abs(grad_bias))), rdt, tiny)
    return torch.stack([ql[0] - s * grad_diag * ql[0],
                        ql[1] - s * (grad_diag * ql[1] + ql[0, -1] * grad_bias)])


def _update_norm_dense(ql, qr, dx, dg, lr, tiny):
    """(normalization, dense) (reference :293-336)."""
    rdt = real_dtype_of(qr.dtype)
    rho = _rho(ql[0], torch.diagonal(qr))
    ql, qr = ql / rho, qr * rho
    a = _norm_apply(ql, dg) @ qr.T
    bt = _tri_right(qr, _norm_inv_t_apply(ql, dx))
    new_ql = _norm_side_step(ql, a, bt, lr, rdt, tiny)
    grad2 = torch.triu(a.T @ a - bt.T @ bt)
    s2 = _step(lr, norm_lower_bound(grad2), rdt, tiny)
    return new_ql, qr - s2 * (grad2 @ qr)


def _norm_grad(ql, pre):
    """Ql^T applied to Ql x's partial product ``pre``."""
    add_last = ql[1:] @ pre
    pre = pre * ql[0:1].T
    return torch.cat([pre[:-1], pre[-1:] + add_last])


def _grad_norm_dense(ql, qr, grad):
    return _norm_grad(ql, _norm_apply(ql, grad) @ qr.T @ qr)


def _update_norm_scale(ql, qr, dx, dg, lr, tiny):
    """(normalization, scaling): Adafactor-like sublinear memory
    (reference :363-405)."""
    rdt = real_dtype_of(qr.dtype)
    rho = _rho(ql[0], qr)
    ql, qr = ql / rho, qr * rho
    a = _norm_apply(ql, dg) * qr
    bt = _norm_inv_t_apply(ql, dx) / qr
    new_ql = _norm_side_step(ql, a, bt, lr, rdt, tiny)
    grad2 = torch.sum(a * a, dim=0, keepdim=True) \
        - torch.sum(bt * bt, dim=0, keepdim=True)
    s2 = _step(lr, torch.max(torch.abs(grad2)), rdt, tiny)
    return new_ql, qr - s2 * grad2 * qr


def _grad_norm_scale(ql, qr, grad):
    return _norm_grad(ql, _norm_apply(ql, grad) * (qr * qr))


def _update_dense_scale(ql, qr, dx, dg, lr, tiny):
    """(dense, scaling) (reference :431-462)."""
    rdt = real_dtype_of(ql.dtype)
    rho = _rho(torch.diagonal(ql), qr)
    ql, qr = ql / rho, qr * rho
    a = ql @ (dg * qr)
    bt = _tri_left(ql, dx / qr, lower=False, trans=True)
    grad1 = torch.triu(a @ a.T - bt @ bt.T)
    grad2 = torch.sum(a * a, dim=0, keepdim=True) \
        - torch.sum(bt * bt, dim=0, keepdim=True)
    s1 = _step(lr, norm_lower_bound(grad1), rdt, tiny)
    s2 = _step(lr, torch.max(torch.abs(grad2)), rdt, tiny)
    return ql - s1 * (grad1 @ ql), qr - s2 * grad2 * qr


def _grad_dense_scale(ql, qr, grad):
    return ql.T @ ql @ (grad * (qr * qr))


# ---------------------------------------------------------------------------
# classic Newton with a maintained inverse by Woodbury (:1171-1213)
# ---------------------------------------------------------------------------


class NewtonInvState(NamedTuple):
    q: torch.Tensor
    inv_q: torch.Tensor


def init_newton_inv(n: int, scale: float = 1.0, dtype=torch.float32,
                    device=None) -> NewtonInvState:
    eye = torch.eye(n, dtype=dtype, device=resolve_device(device))
    return NewtonInvState(q=scale * eye, inv_q=(1.0 / scale) * eye)


def _newton_mu(a, b, lr, step_normalizer, rdt, tiny):
    if step_normalizer == "2nd":
        return _step(lr, torch.sum(a * a + b * b), rdt, tiny)
    return lr * torch.rsqrt(torch.abs(
        torch.sum(a * a) ** 2 + torch.sum(b * b) ** 2
        - 2 * torch.sum(a * b) ** 2).to(rdt) + tiny)


def update_newton_inv(state: NewtonInvState, v: torch.Tensor, h: torch.Tensor,
                      lr: float = 0.01, step_normalizer: str = "2nd",
                      tiny: float = TINY) -> NewtonInvState:
    """The dense-Q update that also keeps inv(Q) by a rank-2 Woodbury
    update, with no triangular solve (reference keep_invQ path,
    :1178-1202)."""
    q, inv_q = state
    v, h = v.reshape(-1, 1), h.reshape(-1, 1)
    a = q @ h
    b = inv_q.T @ v
    mu = _newton_mu(a, b, lr, step_normalizer, real_dtype_of(q.dtype), tiny)
    u_mat = torch.cat([a, b], dim=1) * mu
    v_mat = torch.cat([-(a.T @ q), v.T], dim=0)
    return NewtonInvState(q=q + u_mat @ v_mat,
                          inv_q=woodbury_identity(inv_q, u_mat, v_mat))


def precond_grad_newton_inv(state: NewtonInvState, g: torch.Tensor) -> torch.Tensor:
    return (state.q.T @ (state.q @ g.reshape(-1, 1))).reshape(g.shape)


def update_newton_tri(q: torch.Tensor, v: torch.Tensor, h: torch.Tensor,
                      lr: float = 0.01, step_normalizer: str = "2nd",
                      tiny: float = TINY) -> torch.Tensor:
    """The classic Newton update on the triangular group (reference
    ``update_precond_newton_math_`` with invQ=None, :1204-1213): a = Q h,
    b = Q^-T v by a triangular solve, Q -= mu triu(a a^T - b b^T) Q."""
    v, h = v.reshape(-1, 1), h.reshape(-1, 1)
    a = q @ h
    b = _tri_left(q, v, lower=False, trans=True)
    grad = torch.triu(a @ a.T - b @ b.T)
    rdt = real_dtype_of(q.dtype)
    if step_normalizer == "2nd":
        mu = _step(lr, torch.sum(a * a + b * b), rdt, tiny)
    else:
        mu = _step(lr, norm_lower_bound(grad), rdt, tiny)
    return q - mu * (grad @ q)


# ---------------------------------------------------------------------------
# legacy UVd (LRA) with '1st'/'2nd' step normalizers (:657-753)
# ---------------------------------------------------------------------------


class UVdState(NamedTuple):
    u: torch.Tensor
    v: torch.Tensor
    d: torch.Tensor


def init_uvd(n: int, rank: int, scale: float = 1.0, dtype=torch.float32,
             device=None, *, u: torch.Tensor | None = None,
             v: torch.Tensor | None = None,
             generator: torch.Generator | None = None) -> UVdState:
    """U, V standard normal (n, rank), scaled to ||.||_F = sqrt(0.1), and
    d = scale (JAX ``init_uvd``, its draws from split(key)).  ``u``, ``v``:
    the pre-drawn normals; without them they are drawn with ``generator``
    on ``device`` (the card unless it names another)."""
    device = resolve_device(device)

    def drawn(x):
        if x is None:
            x = torch.randn((n, rank), dtype=dtype, device=device,
                            generator=generator)
        x = x.to(device=device, dtype=dtype)
        return x * (0.1 ** 0.5 / torch.linalg.vector_norm(x)) if rank > 0 else x

    return UVdState(u=drawn(u), v=drawn(v),
                    d=scale * torch.ones((n, 1), dtype=dtype, device=device))


def update_uvd(state: UVdState, v: torch.Tensor, h: torch.Tensor, *,
               u_balance: float, u_coin: float, lr: float = 0.01,
               step_normalizer: str = "2nd", tiny: float = TINY) -> UVdState:
    """The legacy LRA update (reference update_precond_UVd_math_,
    :657-739): the norm balance of U and V when ``u_balance`` < 0.01, the
    r x r LU solves, the '1st'/'2nd' normalizers, and U updated when
    ``u_coin`` < 0.5, else V.  The two uniforms are the JAX package's
    uniform(kb) and uniform(kc), (kb, kc) = split(key), drawn before the
    call (host decisions: the card never waits)."""
    u, w, d = state
    v, h = v.reshape(-1, 1), h.reshape(-1, 1)
    rank = u.shape[1]
    rdt = real_dtype_of(u.dtype)
    norm = torch.linalg.vector_norm

    if u_balance < 0.01:
        rho = torch.sqrt(norm(u) / norm(w))
        u, w = u / rho, w * rho

    qh = d * h + u @ (w.T @ (d * h))
    ph = d * (qh + w @ (u.T @ qh))

    ip_vtu = w.T @ u + torch.eye(rank, dtype=u.dtype, device=u.device)
    lu, piv, _ = torch.linalg.lu_factor_ex(lift2single(ip_vtu))
    inv_qtv = v / d
    inv_qtv = inv_qtv - w @ lu_solve_t(lu, piv,
                                       lift2single(u.T @ inv_qtv)).to(u.dtype)
    inv_pv = inv_qtv - u @ torch.linalg.lu_solve(
        lu, piv, lift2single(w.T @ inv_qtv)).to(u.dtype)
    inv_pv = inv_pv / d

    nabla_d = ph * h - v * inv_pv
    if step_normalizer == "2nd":
        # of a complex minimum JAX keeps the real part: the least real part
        mu = lr * torch.min(torch.real(
            torch.rsqrt(ph * ph + v * v + tiny)
            * torch.rsqrt(h * h + inv_pv * inv_pv + tiny))).to(rdt)
    else:
        mu = _step(lr, torch.max(torch.abs(nabla_d)), rdt, tiny)
    d = d - mu * d * nabla_d

    a, b = qh, inv_qtv
    if u_coin < 0.5:
        atv, btv = a.T @ w, b.T @ w
        atvvt, btvvt = atv @ w.T, btv @ w.T
        if step_normalizer == "2nd":
            m = lr / (norm(a) * norm(atvvt) + norm(b) * norm(btvvt) + tiny)
        else:
            m = lr / (torch.sqrt(torch.abs(
                (a.T @ a) * (atvvt @ atvvt.T) + (b.T @ b) * (btvvt @ btvvt.T)
                - 2 * (a.T @ b) * (atvvt @ btvvt.T)))[0, 0] + tiny)
        u = u - m.to(rdt) * (a @ (atv @ ip_vtu) - b @ (btv @ ip_vtu))
    else:
        atu, btu = a.T @ u, b.T @ u
        uuta, uutb = u @ atu.T, u @ btu.T
        if step_normalizer == "2nd":
            m = lr / (norm(a) * norm(uuta) + norm(b) * norm(uutb) + tiny)
        else:
            m = lr / (torch.sqrt(torch.abs(
                (uuta.T @ uuta) * (a.T @ a) + (uutb.T @ uutb) * (b.T @ b)
                - 2 * (uuta.T @ uutb) * (a.T @ b)))[0, 0] + tiny)
        w = w - m.to(rdt) * ((a + w @ atu.T) @ atu - (b + w @ btu.T) @ btu)
    return UVdState(u=u, v=w, d=d)


def precond_grad_uvd(state: UVdState, g: torch.Tensor) -> torch.Tensor:
    """P g with Q = (I + U V^T) diag(d) (reference :744-753)."""
    u, w, d = state
    x = g.reshape(-1, 1)
    qg = d * x + u @ (w.T @ (d * x))
    return (d * (qg + w @ (u.T @ qg))).reshape(g.shape)
