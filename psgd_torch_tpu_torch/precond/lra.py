"""Low-rank-approximation (LRA) PSGD preconditioner: Q = (I + U V^T) diag(d).

Counterpart of psgd_torch_tpu/precond/lra.py (reference psgd.py:987-1072
and the whitening and Newton wrappers at :1066-1072, :1193-1198).  U and
V are (n, r) with a small rank r (10 in the optimizers), d is (n, 1).  One
update

* approximately balances U and V toward U^T U = V^T V (a trace-matched
  rescaling and a small rotation from E and E^2, psgd.py:1005-1015);
* forms Q h, P h and inv(P^T) v through an r x r LU of I + V^T U in at
  least float32 (``torch.linalg.lu_factor_ex``, which checks nothing on
  the host, and ``lu_solve``; psgd.py:1020-1026);
* updates d with its own Lipschitz estimate;
* updates either U or V, on a coin ``uniform(fold_in(key, 7)) < 0.5``
  decided on the host from the threefry key tree (``ops.fastrand``), as
  the Kron gates are, so the card never waits (psgd.py:1034-1052).

Rank 0 is Q = diag(d): only the d update runs.  The (n, r) updates are
each one product of an (n, 2) block with a (2, r) block, so an update
makes one (n, r) temporary per matrix it changes (5 GB at n = 124.4M,
r = 10, f32).

Randomness: the whitening probe is ``kernels.unit_noise`` and the damping
``kernels.damped_noise`` from the same key (so the same v: uniform on
+-sqrt3, unit variance, where JAX draws a standard normal; the fit needs
only E[v v^T] = I); the Newton damping of h is ``kernels.damped_noise``;
the U/V init is ``kernels.unit_noise``.  A complex draw takes the noise
kernel's complex mode, keyed by split(key) (``fastrand.noise_keys``), each
part scaled by 2^-0.5 (E|v|^2 = 1, as JAX's complex normal).  An optional
``draw(kind, keys, shape, dtype)`` hook replaces every draw (the CPU tests
replay the JAX draws through it).

Complex (complex64, complex128) U, V and d take the JAX package's forms:
every product transposes where a Hermitian preconditioner would conjugate
(so P = Q^T Q for a complex Q), and the solve with (I + V^T U)^T is a
plain transpose (``linalg.lu_solve_t``: JAX ``lu_solve(..., trans=1)``); the init
norms read the real part of U and V (JAX's ``astype(float32)``); the L
estimates stay real.  Row-sharded, the Frobenius norms sum real(x conj x)
over the rows (JAX ``_gnorm``), as ``vector_norm`` does unsharded.

Row sharding (JAX ``axis_name``, ``pad_lra_state``): with U, V, d, v and h
row-sharded over a group of ranks, every reduction over n is an r x r,
r-sized or scalar sum or max over the group, so the update runs on each
rank's rows with r-sized collectives only.  ``ip_uvt_matvec``,
``precond_grad``, ``log_det`` and the updates take ``reduce``: an object
with ``sum(x)`` and ``max(x)`` over the group and this rank's ``index``
(``parallel.mesh.RowReduce``); None is the unsharded code.  The coin stays
a host decision from the replicated key, so every rank takes the same
branch.  n is zero-padded to a multiple of the group's size
(``pad_lra_state``: zero U and V rows, unit d rows, exact no-ops).  The
probes are drawn per shard, keyed by ``fold_in(key, index)``, at the
rank's rows, and zeroed on the pad rows (``pad_mask``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..ops import fastrand, kernels
from ..ops.linalg import (lift2single, lifted_real_dtype, lu_solve_t,
                          real_dtype_of)

# the coin's key: fold_in(key, COIN_FOLD)
COIN_FOLD = 7


class LRAState(NamedTuple):
    """U, V (n, r), d (n, 1) and the Lipschitz estimates of U, V and d
    (() tensors in at least float32)."""
    u: torch.Tensor
    v: torch.Tensor
    d: torch.Tensor
    lu: torch.Tensor
    lv: torch.Tensor
    ld: torch.Tensor

    @property
    def rank(self) -> int:
        return self.u.shape[1]


def _normal(key, shape, dtype, device, draw) -> torch.Tensor:
    """White unit-variance noise from one host key: ``kernels.unit_noise``
    (one launch on CUDA), or the replayed draw."""
    if draw is not None:
        return draw("normal", fastrand.as_keys(key)[None], shape,
                    dtype)[0].to(device)
    return fastrand.unit_noise(key, shape, dtype, device)


def init_lra(n: int, rank: int, key, scale: float = 1.0,
             dtype=torch.float32, device=None, draw=None) -> LRAState:
    """U, V white noise scaled to ||.||_F = sqrt(0.1) (keys split(key)),
    d = scale, L = 0 (reference LRAWhiten.__init__, psgd.py:1114-1122), on
    the card unless ``device`` names another device."""
    if not 0 <= rank < max(n, 1):
        raise ValueError(f"rank {rank} must be in [0, n={n})")
    device = resolve_device(device)
    ku, kv = fastrand.split(key)
    if rank > 0:
        uv = []
        for k in (ku, kv):
            x = _normal(k, (n, rank), dtype, device, draw)
            # JAX's u.astype(float32): of a complex U its real part
            norm = torch.linalg.vector_norm(x.real.to(torch.float32))
            uv.append(x * (0.1 ** 0.5 / norm.to(real_dtype_of(dtype))))
        u, v = uv
    else:
        u = v = torch.zeros((n, 0), dtype=dtype, device=device)
    d = torch.ones((n, 1), dtype=dtype, device=device) * torch.tensor(
        scale, dtype=dtype)
    zero = torch.zeros((), dtype=lifted_real_dtype(dtype), device=device)
    return LRAState(u=u, v=v, d=d, lu=zero, lv=zero.clone(), ld=zero.clone())


def lra_state_from_jax(state, device=None) -> LRAState:
    """The JAX package's ``LRAState`` (any object with arrays ``u``, ``v``,
    ``d``, ``lu``, ``lv``, ``ld``) as the port's, through numpy."""
    device = resolve_device(device)
    return LRAState(*(torch.from_numpy(np.array(getattr(state, f))).to(device)
                      for f in LRAState._fields))


def pad_lra_state(state: LRAState, extra: int) -> LRAState:
    """``extra`` rows appended so that n divides a group's size: zero U and
    V rows, unit d rows (JAX ``pad_lra_state``).  They are exact no-ops of
    the update and of ``precond_grad`` where the probe and h rows are 0."""
    if extra == 0:
        return state
    pad = torch.nn.functional.pad
    return state._replace(u=pad(state.u, (0, 0, 0, extra)),
                          v=pad(state.v, (0, 0, 0, extra)),
                          d=pad(state.d, (0, 0, 0, extra), value=1.0))


def _rsum(x: torch.Tensor, reduce) -> torch.Tensor:
    """x summed over the row shards (r-sized), or x."""
    return x if reduce is None else reduce.sum(x)


def _norm(x: torch.Tensor, reduce) -> torch.Tensor:
    """||x||_F over the row shards (JAX ``_gnorm``: real(x conj x) summed,
    so a complex x counts |x|^2)."""
    if reduce is None:
        return torch.linalg.vector_norm(x)
    return torch.sqrt(reduce.sum(torch.sum(torch.real(x * torch.conj(x)))))


def ip_uvt_matvec(u: torch.Tensor, v: torch.Tensor, x: torch.Tensor,
                  reduce=None) -> torch.Tensor:
    """(I + U V^T) x (psgd.py:987-991)."""
    return x + u @ _rsum(v.T @ x, reduce)


def precond_grad(state: LRAState, g: torch.Tensor,
                 reduce=None) -> torch.Tensor:
    """P g with P = Q^T Q, Q = (I + U V^T) diag(d) (psgd.py:1055-1063);
    takes (n,) or (n, 1) and returns the same shape."""
    g2 = g[:, None] if g.ndim == 1 else g
    out = ip_uvt_matvec(state.u, state.v, state.d * g2, reduce)
    out = state.d * ip_uvt_matvec(state.v, state.u, out, reduce)
    return out[:, 0] if g.ndim == 1 else out


def log_det(state: LRAState, reduce=None) -> torch.Tensor:
    """log |det Q| = sum log|d| + log|det(I + V^T U)| in at least float32
    (the matrix determinant lemma)."""
    d32 = lift2single(state.d)
    out = _rsum(torch.sum(torch.log(torch.abs(d32))), reduce)
    if state.rank > 0:
        small = torch.eye(state.rank, dtype=d32.dtype, device=d32.device) \
            + _rsum(lift2single(state.v).T @ lift2single(state.u), reduce)
        out = out + torch.linalg.slogdet(small)[1]
    return out


def _max_update(lip: torch.Tensor, ell: torch.Tensor,
                beta_l: float) -> torch.Tensor:
    """L <- max(betaL L + (1 - betaL) ell, ell), in L's dtype."""
    ell = ell.to(lip.dtype)
    return torch.maximum(beta_l * lip + (1.0 - beta_l) * ell, ell)


def _max_abs(x: torch.Tensor, reduce=None) -> torch.Tensor:
    out = torch.amax(torch.abs(x))
    return out if reduce is None else reduce.max(out)


def _coin(key, draw) -> bool:
    """True: update U; False: update V (uniform(fold_in(key, 7)) < 0.5)."""
    kc = fastrand.fold_in(key, COIN_FOLD)
    u = (float(fastrand.uniform01(kc)) if draw is None else
         float(draw("uniform", kc[None], (), torch.float64)[0]))
    return u < 0.5


def _update_d(state, d, v, h, ph, inv_pv, lr, beta_l, reduce):
    rdt = real_dtype_of(d.dtype)
    phh, vinvpv = ph * h, v * inv_pv
    ld = _max_update(state.ld, _max_abs(phh, reduce)
                     + _max_abs(vinvpv, reduce), beta_l)
    return d - (lr / ld).to(rdt) * (phh - vinvpv) * d, ld


def update_lra(state: LRAState, v: torch.Tensor, h: torch.Tensor, key,
               lr: float = 0.1, beta_l: float = 0.9,
               draw=None, reduce=None) -> LRAState:
    """One LRA update from a (v, h) pair, already damped (reference
    update_precond_lra, psgd.py:994-1052; JAX ``update_lra``).  ``key``: a
    host threefry key, the coin's; ``draw`` replays the coin; ``reduce``
    sums and maxes over the row shards (module docstring)."""
    v = v[:, None] if v.ndim == 1 else v
    h = h[:, None] if h.ndim == 1 else h
    u, w, d = state.u, state.v, state.d
    rank = u.shape[1]
    rdt = real_dtype_of(u.dtype)

    if rank == 0:
        qh = d * h
        d, ld = _update_d(state, d, v, h, d * qh, (v / d) / d, lr, beta_l,
                          reduce)
        return state._replace(d=d, ld=ld)

    # approximate balancing of U and V toward U^T U = V^T V: with E and
    # E2 as JAX forms them, U <- U/rho (I - E + E2), V <- V rho (I + E + E2)
    utu, vtv = _rsum(u.T @ u, reduce), _rsum(w.T @ w, reduce)
    tr_u, tr_v = torch.trace(utu), torch.trace(vtv)
    rho = (tr_u / tr_v) ** 0.25
    rho2 = rho * rho
    e = 0.1 * (utu / rho2 - vtv * rho2) / (tr_u / rho2 + tr_v * rho2)
    e2 = 0.5 * (e @ e)
    eye = torch.eye(rank, dtype=u.dtype, device=u.device)
    u = u @ ((eye - (e - e2)) / rho)
    w = w @ ((eye + (e + e2)) * rho)

    # P h, and inv(P^T) v through the r x r LU of I + V^T U
    qh = ip_uvt_matvec(u, w, d * h, reduce)
    ph = d * ip_uvt_matvec(w, u, qh, reduce)
    ip_vtu = _rsum(w.T @ u, reduce) + eye
    lu_fac, piv, _ = torch.linalg.lu_factor_ex(lift2single(ip_vtu))
    inv_qtv = v / d
    sol1 = lu_solve_t(lu_fac, piv, lift2single(_rsum(u.T @ inv_qtv, reduce)))
    inv_qtv = inv_qtv - w @ sol1.to(u.dtype)
    sol2 = torch.linalg.lu_solve(lu_fac, piv,
                                 lift2single(_rsum(w.T @ inv_qtv, reduce)))
    inv_pv = (inv_qtv - u @ sol2.to(u.dtype)) / d

    d, ld = _update_d(state, d, v, h, ph, inv_pv, lr, beta_l, reduce)

    # either U or V: each step is [x, y] (n, 2) times a (2, r) block
    a, b = qh, inv_qtv
    na, nb = _norm(a, reduce), _norm(b, reduce)
    lu, lv = state.lu, state.lv
    if _coin(key, draw):
        atv, btv = _rsum(a.T @ w, reduce), _rsum(b.T @ w, reduce)
        ell = (na * _norm(w @ atv.T, reduce)
               + nb * _norm(w @ btv.T, reduce))
        lu = _max_update(lu, ell, beta_l)
        c = (lr / lu).to(rdt)
        blk = torch.cat([atv @ ip_vtu, -(btv @ ip_vtu)]) * c
        u = torch.addmm(u, torch.cat([a, b], dim=1), blk, alpha=-1)
    else:
        atu, btu = _rsum(a.T @ u, reduce), _rsum(b.T @ u, reduce)
        ell = (na * _norm(u @ atu.T, reduce)
               + nb * _norm(u @ btu.T, reduce))
        lv = _max_update(lv, ell, beta_l)
        cols = torch.cat([a + w @ atu.T, b + w @ btu.T], dim=1)
        w = torch.addmm(w, cols, torch.cat([atu, -btu]) * (lr / lv).to(rdt),
                        alpha=-1)
    return LRAState(u=u, v=w, d=d, lu=lu, lv=lv, ld=ld)


def shard_key(key, reduce):
    """A probe's key: ``fold_in(key, index)`` on a row shard (JAX
    ``_shard_noise``), else the key."""
    return key if reduce is None else fastrand.fold_in(key, reduce.index)


def _pad_zero(h: torch.Tensor, pad_mask) -> torch.Tensor:
    """h with its pad rows +0, as JAX's h + (damping + eps|h|) (v * mask)
    makes them where h is 0; the fused ``kernels.damped_noise`` writes
    damping v there."""
    return h if pad_mask is None else torch.where(pad_mask, h, 0.0)


def _masked(v: torch.Tensor, h: torch.Tensor, pad_mask):
    """The probe and h zeroed on the pad rows, as JAX forms them: v times
    the mask (-0 where the draw is negative), h +0 (``_pad_zero``)."""
    if pad_mask is None:
        return v, h
    return v * pad_mask.to(v.dtype), _pad_zero(h, pad_mask)


def update_lra_whiten(state: LRAState, g: torch.Tensor, key,
                      lr: float = 0.1, beta_l: float = 0.9,
                      damping: float = 1e-9, draw=None, reduce=None,
                      pad_mask=None) -> LRAState:
    """Whitening: kv, ku = split(key); the probe v and h = g + (damping +
    eps|g|) v, both keyed by kv (``kernels.unit_noise`` and
    ``kernels.damped_noise``, the same v), then ``update_lra`` keyed by ku
    (psgd.py:1066-1072).  On a row shard (``reduce``) the probe is keyed
    by ``shard_key(kv)`` at this rank's rows and v and h are zeroed where
    ``pad_mask`` ((n_loc, 1) bool, True on the true rows) is False."""
    kv, ku = fastrand.split(key)
    kv = shard_key(kv, reduce)
    g2 = g[:, None] if g.ndim == 1 else g
    if draw is not None:
        v = draw("normal", kv[None], g2.shape, g2.dtype)[0].to(g2.device)
        if pad_mask is not None:
            v = v * pad_mask.to(v.dtype)
        eps = torch.finfo(real_dtype_of(g2.dtype)).eps
        h = g2 + (damping + eps * torch.abs(g2)) * v
    else:
        seeds = kernels.key_seed_words(fastrand.noise_keys(kv[None], g2.dtype),
                                       g2.device)
        v = kernels.unit_noise(seeds, g2.shape, g2.dtype)[0]
        h = kernels.damped_noise(g2.contiguous()[None], seeds, damping)[0]
        v, h = _masked(v, h, pad_mask)
    return update_lra(state, v, h, ku, lr=lr, beta_l=beta_l, draw=draw,
                      reduce=reduce)


def update_lra_newton(state: LRAState, v: torch.Tensor, h: torch.Tensor, key,
                      lr: float = 0.1, beta_l: float = 0.9,
                      damping: float = 1e-9, draw=None, reduce=None,
                      pad_mask=None) -> LRAState:
    """Newton: kd, ku = split(key); h damped by noise keyed kd
    (``kernels.damped_noise``), then ``update_lra`` keyed by ku
    (psgd.py:1193-1198).  On a row shard the damping is keyed by
    ``shard_key(kd)`` and zero on the pad rows, as ``update_lra_whiten``'s
    probe."""
    kd, ku = fastrand.split(key)
    kd = shard_key(kd, reduce)
    v2 = v[:, None] if v.ndim == 1 else v
    h2 = h[:, None] if h.ndim == 1 else h
    if draw is not None:
        noise = draw("normal", kd[None], h2.shape, h2.dtype)[0].to(h2.device)
        if pad_mask is not None:
            noise = noise * pad_mask.to(noise.dtype)
        eps = torch.finfo(real_dtype_of(h2.dtype)).eps
        hd = h2 + (damping + eps * torch.abs(h2)) * noise
    else:
        hd = _pad_zero(kernels.damped_noise(
            h2.contiguous()[None],
            kernels.key_seed_words(fastrand.noise_keys(kd[None], h2.dtype),
                                   h2.device), damping)[0], pad_mask)
    return update_lra(state, v2, hd, ku, lr=lr, beta_l=beta_l, draw=draw,
                      reduce=reduce)
