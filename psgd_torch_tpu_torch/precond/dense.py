"""Dense-matrix Newton-type PSGD preconditioner, in all seven dQ geometries.

Counterpart of psgd_torch_tpu/precond/dense.py (reference
update_precond_dense_*, psgd.py:1339-1424, class at :1427-1563): one full
(n, n) Q over the concatenated parameter vector.  v and h are column
vectors (n, 1) or (n,); an update is pure and returns a new ``DenseState``.

Per geometry, with a = what Q makes of the damped h and ell = |a|^2 +
|v|^2 (|a|^2 + |b|^2 for EQ and QEP):

* EQ: a = Q h, b = Q^-T v (``solve_triangular``, lifted to float32 for
  half precision), Q -= c triu(a a^T - b b^T) Q;
* QEP: a = Q Q^T Q h, b = Q v, Q -= c (a a^T - b b^T) Q;
* QEQ: a = Q^T Q h, Q -= c Q (a a^T - v v^T);
* Q0.5EQ1.5: a = Q^T Q h, Q -= c (a a^T - v v^T) Q, then one Procrustes
  rotation, ``kernels.procrustes`` on the (1, n, n) stack (row 4 on CUDA;
  for a complex or float64 Q ``kernels.xla_procrustes``, PyTorch
  operations, as the JAX package computes it in XLA);
* PRO4P (Q is P): a = Q h, the same step, then ``linalg.procrustes_loop3``
  (``kernels.tsub`` and the skew ``kernels.norm_bound``, 10 masked steps);
* QUAD (c halved) and QUAD4P (Q is P): a = Q Q h (resp. Q h), two
  half-steps from the left and the right, then (P + P^T) / 2.

Complex (complex64, complex128) Q takes the JAX package's forms: the
products above transpose where a Hermitian preconditioner would
conjugate (P = Q^T Q), ell is the real part of sum(a a) + sum(v v)
(JAX's ``astype`` of a complex ell to L's real dtype), and the Procrustes
rotations conjugate (R = Q^H - Q), as JAX's ``ops.linalg`` does.

Keys: kd, ku = split(key); kd damps h (``kernels.damped_noise``, in its
complex mode for a complex h, keyed by split(kd)), ku keys the Procrustes
rotation or loop.  ``damping=None`` adds no noise (the
whitening wrapper damps its own pair).  An optional ``draw(kind, keys,
shape, dtype)`` hook replaces every draw, as in ``precond.kron``.

Row-sharded QEQ (JAX ``update_dense_qeq_row_sharded`` and
``precond_grad_qeq_row_sharded``): each rank holds a block of Q's rows,
v, h and the gradient whole.  QEQ's fit terms are rank-1 products that
need no transpose of Q, so a fit is one (n,)-sized sum over the ranks
(``reduce.sum``, a ``parallel.mesh.RowReduce``) and so is the apply.  n
is zero-padded to a multiple of the ranks; the damping is masked to the
true rows, so Q's pad rows and columns stay e_i.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..ops import fastrand, kernels
from ..ops.linalg import (lift2single, lifted_real_dtype, procrustes_loop3,
                          real_dtype_of, width_norm_k)
from .kron import (DQ_EQ, DQ_PRO4P, DQ_Q05EQ15, DQ_QEP, DQ_QEQ, DQ_QUAD,
                   _FIT_P, canonical_dq)


class DenseState(NamedTuple):
    """Q (n, n) (P itself for the fit-P geometries) and its Lipschitz
    estimate (() in at least float32)."""
    q: torch.Tensor
    lips: torch.Tensor


def init_dense(n: int, scale: float = 1.0, dq: str = DQ_Q05EQ15,
               dtype=torch.float32, device=None) -> DenseState:
    """Q = scale I, scale squared for the fit-P geometries (psgd.py:
    1457-1459), on the card unless ``device`` names another device."""
    dq = canonical_dq(dq)
    device = resolve_device(device)
    s = torch.tensor(scale, dtype=real_dtype_of(dtype))
    if dq in _FIT_P:
        s = s * s
    return DenseState(q=(s.to(dtype) * torch.eye(n, dtype=dtype)).to(device),
                      lips=torch.zeros((), dtype=lifted_real_dtype(dtype),
                                       device=device))


def dense_state_from_jax(state, device=None) -> DenseState:
    """The JAX package's ``DenseState`` (arrays ``q`` and ``lips``) as the
    port's, through numpy."""
    device = resolve_device(device)
    return DenseState(*(torch.from_numpy(np.array(getattr(state, f))).to(device)
                        for f in DenseState._fields))


def _as_col(x: torch.Tensor) -> torch.Tensor:
    return x[:, None] if x.ndim == 1 else x


def precond_grad(state: DenseState, g: torch.Tensor, dq: str) -> torch.Tensor:
    """P g: Q g for the fit-P geometries, Q (Q g) for QUAD (Q symmetric),
    Q^T (Q g) otherwise (psgd.py:1473-1478); (n,) or (n, 1) in and out."""
    dq = canonical_dq(dq)
    g2 = _as_col(g)
    q = state.q
    if dq in _FIT_P:
        out = q @ g2
    elif dq == DQ_QUAD:
        out = q @ (q @ g2)
    else:
        out = q.T @ (q @ g2)
    return out[:, 0] if g.ndim == 1 else out


def _noise(key, h: torch.Tensor, draw) -> torch.Tensor:
    """The pre-drawn probe for ``key``, or None (the kernels draw it)."""
    if draw is None:
        return None
    return draw("normal", fastrand.as_keys(key)[None], h.shape,
                h.dtype)[0].to(h.device)


def _seed_words(key, dtype, device) -> torch.Tensor:
    """The noise kernel's seed words for one key: (1, 2), or (1, 4) in the
    complex mode (``fastrand.noise_keys``)."""
    return kernels.key_seed_words(
        fastrand.noise_keys(fastrand.as_keys(key)[None], dtype), device)


def _damped(h: torch.Tensor, key, damping: float, v=None) -> torch.Tensor:
    """h + (damping + eps|h|) v, v keyed by ``key``: one fused
    ``kernels.damped_noise`` launch, or from the pre-drawn v."""
    if v is not None:
        eps = torch.finfo(real_dtype_of(h.dtype)).eps
        return h + (damping + eps * torch.abs(h)) * v
    return kernels.damped_noise(h.contiguous()[None],
                                _seed_words(key, h.dtype, h.device), damping)[0]


def _sum_sq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * a) + torch.sum(b * b)


def _lmax(lips: torch.Tensor, ell: torch.Tensor, beta_l: float) -> torch.Tensor:
    ell = ell.real.to(lips.dtype)     # JAX's astype: a complex ell's real part
    return torch.maximum(beta_l * lips + (1.0 - beta_l) * ell, ell)


def _start(key, n: int, norm_k: int, dtype, device, draw):
    """The replayed (1, k, n) start of a bound keyed by ``key``, or None."""
    if draw is None:
        return None
    k = width_norm_k(norm_k, n)
    return draw("normal", fastrand.as_keys(key)[None], (k, n), dtype).to(device)


def update_dense(state: DenseState, v: torch.Tensor, h: torch.Tensor, key,
                 dq: str, lr: float = 0.1, beta_l: float = 0.9,
                 damping: float | None = 1e-9, norm_k: int = 32,
                 draw=None) -> DenseState:
    """One Newton-type dense update in geometry ``dq`` from a probe v and
    its Hessian-vector product h (reference update_precond_dense_*,
    psgd.py:1339-1424; JAX ``update_dense``).  ``damping=None`` adds no
    noise; any float, 0 included, adds the eps|h| floor."""
    dq = canonical_dq(dq)
    v, h = _as_col(v), _as_col(h)
    kd, ku = fastrand.split(key)
    q, lips = state.q, state.lips
    rdt = real_dtype_of(q.dtype)
    hd = h if damping is None else _damped(h, kd, damping, _noise(kd, h, draw))

    if dq == DQ_EQ:
        a = q @ hd
        b = torch.linalg.solve_triangular(lift2single(q.T), lift2single(v),
                                          upper=False).to(v.dtype)
        lips = _lmax(lips, _sum_sq(a, b), beta_l)
        c = (lr / lips).to(rdt)
        return DenseState(q=q - c * (torch.triu(a @ a.T - b @ b.T) @ q),
                          lips=lips)
    if dq == DQ_QEP:
        a = q @ (q.T @ (q @ hd))
        b = q @ v
        lips = _lmax(lips, _sum_sq(a, b), beta_l)
        c = (lr / lips).to(rdt)
        return DenseState(q=q - c * (a @ (a.T @ q) - b @ (b.T @ q)), lips=lips)
    if dq == DQ_QEQ:
        a = q.T @ (q @ hd)
        lips = _lmax(lips, _sum_sq(a, v), beta_l)
        c = (lr / lips).to(rdt)
        return DenseState(q=q - c * ((q @ a) @ a.T - (q @ v) @ v.T), lips=lips)
    if dq in (DQ_Q05EQ15, DQ_PRO4P):
        a = q @ hd if dq == DQ_PRO4P else q.T @ (q @ hd)
        lips = _lmax(lips, _sum_sq(a, v), beta_l)
        c = (lr / lips).to(rdt)
        q = q - c * (a @ (a.T @ q) - v @ (v.T @ q))
        n = q.shape[0]
        if dq == DQ_PRO4P:
            q = procrustes_loop3(q[None], fastrand.as_keys(ku)[None],
                                 norm_k=norm_k, draw=draw)[0]
        else:
            step = (kernels.xla_procrustes if q.dtype in kernels.XLA_DTYPES
                    else kernels.procrustes)
            q = step(q.contiguous()[None],
                     kernels.key_seed_words(fastrand.as_keys(ku)[None], q.device),
                     1 / 8, k=norm_k,
                     start=_start(ku, n, norm_k, q.dtype, q.device, draw))[0]
        return DenseState(q=q, lips=lips)
    # QUAD (Q symmetric, half step) and QUAD4P (Q is P)
    a = q @ (q @ hd) if dq == DQ_QUAD else q @ hd
    lips = _lmax(lips, _sum_sq(a, v), beta_l)
    c = ((lr / 2.0 if dq == DQ_QUAD else lr) / lips).to(rdt)
    p = q - c * (a @ (a.T @ q) - v @ (v.T @ q))
    p = p - c * ((p @ a) @ a.T - (p @ v) @ v.T)
    return DenseState(q=0.5 * (p + p.T), lips=lips)


def update_dense_whiten(state: DenseState, g: torch.Tensor, key, dq: str,
                        lr: float = 0.1, beta_l: float = 0.9,
                        damping: float = 1e-9, norm_k: int = 32,
                        draw=None) -> DenseState:
    """Whitening: kv, ku = split(key); the probe v and (v, g + (damping +
    eps|g|) v), both keyed by kv (``kernels.unit_noise`` and
    ``kernels.damped_noise``, the same v), fed undamped to
    ``update_dense`` keyed by ku."""
    kv, ku = fastrand.split(key)
    g2 = _as_col(g)
    v = _noise(kv, g2, draw)
    if v is None:
        seeds = _seed_words(kv, g2.dtype, g2.device)
        v = kernels.unit_noise(seeds, g2.shape, g2.dtype)[0]
        h = kernels.damped_noise(g2.contiguous()[None], seeds, damping)[0]
    else:
        h = _damped(g2, kv, damping, v)
    return update_dense(state, v, h, ku, dq, lr=lr, beta_l=beta_l,
                        damping=None, norm_k=norm_k, draw=draw)


def update_dense_qeq_row_sharded(q_loc: torch.Tensor, lips: torch.Tensor,
                                 v: torch.Tensor, h: torch.Tensor, key,
                                 reduce, n_true: int, lr: float = 0.1,
                                 beta_l: float = 0.9,
                                 damping: float | None = 1e-9, draw=None):
    """One QEQ update on a block of Q's rows (JAX
    ``update_dense_qeq_row_sharded``, dense.py:185-213): ``q_loc`` (n_loc,
    n), v and h (n, 1) or (n,) whole and equal on every rank.  The damping
    is keyed by ``key`` itself, as JAX's, at the padded n (one
    ``kernels.damped_noise`` launch: every rank draws the same bits) and
    kept on the true rows (< ``n_true``) only.  Returns (q_loc, lips)."""
    v, h = _as_col(v), _as_col(h)
    rdt = real_dtype_of(q_loc.dtype)
    if damping is None:
        hd = h
    else:
        mask = (torch.arange(h.shape[0], device=h.device) < n_true)[:, None]
        hd = torch.where(mask, _damped(h, key, damping, _noise(key, h, draw)), h)
    a = reduce.sum(q_loc.T @ (q_loc @ hd))
    lips = _lmax(lips, _sum_sq(a, v), beta_l)
    c = (lr / lips).to(rdt)
    return q_loc - c * ((q_loc @ a) @ a.T - (q_loc @ v) @ v.T), lips


def precond_grad_qeq_row_sharded(q_loc: torch.Tensor, g: torch.Tensor,
                                 reduce) -> torch.Tensor:
    """P g = Q^T (Q g) from a block of Q's rows: the local products and one
    sum over the ranks; whole on every rank, (n,) or (n, 1) as g."""
    g2 = _as_col(g)
    out = reduce.sum(q_loc.T @ (q_loc @ g2))
    return out[:, 0] if g.ndim == 1 else out
