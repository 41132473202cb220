"""Kronecker-factored PSGD preconditioner: the Q0.5EQ1.5 fits.

Counterpart of psgd_torch_tpu/precond/kron.py for what ``kron_whiten`` and
``kron_newton`` run by default: plans and state, balancing, the
L-constants, the apply P g = Q^T Q g and its cached form (P_i = Q_i^T Q_i
per factor, then one product per dim), the damping, and the Q0.5EQ1.5
whitening fit (from a gradient g, optionally returning its P damped(g))
and Newton fit (from a probe v and its Hessian-vector product h), per
tensor and for a layer stack.  The other
geometries raise ``NotImplementedError`` (ROADMAP A4), and so do complex
tensors (ROADMAP A3).

Contractions are explicit per-dimension products (one ``matmul`` along one
axis at a time, Q^T after Q), never a multi-operand einsum: the card's
PyTorch has no opt_einsum, and contracting left to right would start the
exprP chain of a (768, 2304) leaf with a 768*768*2304-element outer
product.  Plans therefore carry no subscripts.

Randomness: every function that draws takes host-side threefry keys
(``ops.fastrand``) and derives the JAX package's key tree from them, so
a draw is a pure function of (seed, step, leaf, layer, purpose).  An
optional ``draw(kind, keys, shape, dtype)`` hook replaces the draws with
pre-drawn tensors (the CPU tests replay the JAX draws through it).
On CUDA every dense factor goes through the NS kernel and the damping
through the fused noise kernel; on the CPU through their plain versions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .. import resolve_device
from ..ops import fastrand, kernels
from ..ops.linalg import lifted_real_dtype, real_dtype_of, width_norm_k

DQ_EQ = "EQ"
DQ_QEP = "QEP"
DQ_QEQ = "QEQ"
DQ_QUAD = "QUAD"
DQ_Q05EQ15 = "Q0.5EQ1.5"
DQ_QUAD4P = "QUAD4P"
DQ_PRO4P = "PRO4P"
ALL_DQ = (DQ_EQ, DQ_QEP, DQ_QEQ, DQ_QUAD, DQ_Q05EQ15, DQ_QUAD4P, DQ_PRO4P)
_FIT_P = frozenset({DQ_QUAD4P, DQ_PRO4P})
MAX_ORDER = 26
BALANCE_PROB = 0.01


def canonical_dq(dq: str) -> str:
    dq = {"Q0p5EQ1p5": DQ_Q05EQ15}.get(dq, dq)
    if dq not in ALL_DQ:
        raise ValueError(f"Invalid dQ {dq!r}; valid choices: {ALL_DQ}")
    return dq


def _require_main_path_dq(dq: str) -> None:
    if dq != DQ_Q05EQ15:
        raise NotImplementedError(
            f"dQ {dq!r} is not ported yet (ROADMAP A4); the port fits "
            f"{DQ_Q05EQ15!r} only")


def require_real(*dtypes: torch.dtype) -> None:
    """Refuse complex dtypes: the port's noise, damping and clipping are
    real-only until ROADMAP A3 lands."""
    for dt in dtypes:
        if dt.is_complex:
            raise NotImplementedError(
                f"complex dtype {dt} is not ported yet (ROADMAP A3)")


class KronPlan(NamedTuple):
    """Static per-tensor plan: which dims get a dense factor."""
    shape: Tuple[int, ...]
    is_diag: Tuple[bool, ...]
    dq: str
    numel: int

    @property
    def order(self) -> int:
        return len(self.shape)

    @property
    def fits_p(self) -> bool:
        return self.dq in _FIT_P


class KronState(NamedTuple):
    """Factors Q (a (n, n) matrix or (n,) diagonal per dim, one () factor for
    a scalar) and their L-constants (>= float32).  A layer stack carries a
    leading layer axis on every tensor."""
    q: Tuple[torch.Tensor, ...]
    lips: Tuple[torch.Tensor, ...]


def make_kron_plan(shape, max_size: float = float("inf"),
                   max_skew: float = 1.0, dq: str = DQ_Q05EQ15,
                   force_diag: Optional[Tuple[bool, ...]] = None) -> KronPlan:
    """Dim i is diagonal when size <= 1, size > max_size or
    size**2 > max_skew * numel (reference psgd.py:208-210)."""
    dq = canonical_dq(dq)
    shape = tuple(int(s) for s in shape)
    if force_diag is not None and len(force_diag) != len(shape):
        raise ValueError(f"force_diag {force_diag} does not match {shape}")
    if len(shape) > MAX_ORDER:
        raise ValueError(f"Tensors of order {len(shape)} > {MAX_ORDER} are "
                         "not supported")
    numel = 1
    for s in shape:
        numel *= s
    if not shape:
        return KronPlan(shape=(), is_diag=(True,), dq=dq, numel=1)
    is_diag = tuple(
        (s <= 1) or (s > max_size) or (s * s > max_skew * numel)
        or (force_diag is not None and bool(force_diag[i]))
        for i, s in enumerate(shape))
    return KronPlan(shape=shape, is_diag=is_diag, dq=dq, numel=numel)


def init_kron_from_plan(plan: KronPlan, scale: float = 1.0,
                        dtype=torch.float32, device=None) -> KronState:
    """Q = scale * I (factored, scale**(1/order) per factor) and L = 0, on
    the card unless ``device`` names another device (``resolve_device``:
    without a card and without ``device="cpu"`` it raises)."""
    device = resolve_device(device)
    rd = real_dtype_of(dtype)
    scale = torch.tensor(scale, dtype=rd)
    if plan.fits_p:
        scale = scale * scale
    l_dtype = lifted_real_dtype(dtype)
    if plan.order == 0:
        return KronState(q=(scale.to(dtype).to(device),),
                         lips=(torch.zeros((), dtype=l_dtype, device=device),))
    fs = (scale ** (1.0 / plan.order)).to(dtype)
    qs, lips = [], []
    for size, diag in zip(plan.shape, plan.is_diag):
        base = (torch.ones(size, dtype=dtype) if diag
                else torch.eye(size, dtype=dtype))
        qs.append((fs * base).to(device))
        lips.append(torch.zeros((), dtype=l_dtype, device=device))
    return KronState(q=tuple(qs), lips=tuple(lips))


def init_kron(shape, scale: float = 1.0, max_size: float = float("inf"),
              max_skew: float = 1.0, dq: str = DQ_Q05EQ15,
              dtype=torch.float32, device=None) -> Tuple[KronState, KronPlan]:
    plan = make_kron_plan(shape, max_size=max_size, max_skew=max_skew, dq=dq)
    return init_kron_from_plan(plan, scale, dtype, device), plan


def balance_kron(q: Tuple[torch.Tensor, ...],
                 batched: bool = False) -> Tuple[torch.Tensor, ...]:
    """Rescale the factors to a common max-abs (their geometric mean),
    preventing over/underflow (reference psgd.py:266-275).  ``batched``:
    every factor carries a leading layer axis, balanced per layer."""
    if len(q) <= 1:
        return q
    acc = lifted_real_dtype(q[0].dtype)
    dims = [tuple(range(1, f.ndim)) if batched else tuple(range(f.ndim))
            for f in q]
    norms = [torch.amax(torch.abs(f), dim=d).to(acc) if d else
             torch.abs(f).to(acc) for f, d in zip(q, dims)]
    gmean = torch.prod(torch.stack(norms), dim=0) ** (1.0 / len(q))
    out = []
    for f, n in zip(q, norms):
        mult = (gmean / n).to(real_dtype_of(f.dtype))
        if batched:
            mult = mult.reshape((-1,) + (1,) * (f.ndim - 1))
        out.append(f * mult)
    return tuple(out)


def _maybe_balance(q: Tuple[torch.Tensor, ...], u, prob: float = BALANCE_PROB):
    """Balance layer i of a stack when u[i] < prob (the host-decided analogue
    of the reference's torch.rand gate, psgd.py:318).  u: (B,) host
    uniforms in [0, 1)."""
    if len(q) <= 1:
        return q
    mask = [float(x) < prob for x in u]
    if not any(mask):
        return q
    bal = balance_kron(q, batched=True)
    if all(mask):
        return bal
    sel = [i for i, m in enumerate(mask) if m]
    out = []
    for f, fb in zip(q, bal):
        f = f.clone()
        f[sel] = fb[sel]
        out.append(f)
    return tuple(out)


def _update_lips(lip: torch.Tensor, ell: torch.Tensor,
                 beta_l: float) -> torch.Tensor:
    """L <- max(betaL L + (1 - betaL) ell, ell), in L's (>= f32) dtype."""
    ell = torch.real(ell).to(lip.dtype)
    return torch.maximum(beta_l * lip + (1.0 - beta_l) * ell, ell)


def _coeff(lr: float, lip: torch.Tensor, dtype) -> torch.Tensor:
    """lr / L, castable onto factors of ``dtype``."""
    return (lr / lip).to(real_dtype_of(dtype))


# ---------------------------------------------------------------------------
# explicit per-dimension contractions; x carries a leading batch axis
# ---------------------------------------------------------------------------


def _apply_factor(f: torch.Tensor, x: torch.Tensor, dim: int,
                  transpose: bool) -> torch.Tensor:
    """Apply factor f (B, n, n) or diagonal (B, n) along axis ``dim`` of a
    batched tensor x (B, ...): f @ x along that axis, or f^T @ x."""
    ax = dim + 1
    if f.ndim == 2:
        view = [f.shape[0]] + [1] * (x.ndim - 1)
        view[ax] = f.shape[1]
        return x * f.reshape(view)
    xm = x.movedim(ax, -1)
    sh = xm.shape
    y = torch.bmm(xm.reshape(sh[0], -1, sh[-1]),
                  f if transpose else f.transpose(1, 2))
    return y.reshape(sh).movedim(-1, ax)


def _work_view(plan: KronPlan, x: torch.Tensor) -> torch.Tensor:
    """Batched tensor in the plan's shape; a scalar plan works as (1,)."""
    return x.reshape((x.shape[0],) + (plan.shape or (1,)))


def _batched_factors(q):
    """Factors with a leading batch axis; a scalar factor (B,) works as a
    (B, 1) diagonal."""
    return [f.reshape(f.shape[0], 1) if f.ndim == 1 else f for f in q]


def _factor_pass(qs, x: torch.Tensor, transpose: bool) -> torch.Tensor:
    """Every factor applied once along its dim (f^T with ``transpose``)."""
    for i, f in enumerate(qs):
        x = _apply_factor(f, x, i, transpose)
    return x


def _precond_batched(q, plan: KronPlan, g: torch.Tensor) -> torch.Tensor:
    """P g per batch element: Q applied along every dim, then Q^T (for the
    fit-P geometries, Q alone).  q factors and g carry the batch axis."""
    qs = _batched_factors(q)
    x = _factor_pass(qs, _work_view(plan, g), transpose=False)
    if not plan.fits_p:
        x = _factor_pass(qs, x, transpose=True)
    return x.reshape(g.shape)


def _single_pass(factors, plan: KronPlan, g: torch.Tensor) -> torch.Tensor:
    """Each factor applied once along its dim; factors and g carry the
    batch axis."""
    x = _factor_pass(_batched_factors(factors), _work_view(plan, g),
                     transpose=False)
    return x.reshape(g.shape)


def precond_grad(state: KronState, plan: KronPlan,
                 g: torch.Tensor) -> torch.Tensor:
    """P g for one tensor: P = Q^T Q (or P = Q for the fit-P geometries)."""
    q = tuple(f[None] for f in state.q)
    return _precond_batched(q, plan, g[None])[0]


def precond_grad_stacked(state: KronState, plan: KronPlan,
                         g: torch.Tensor) -> torch.Tensor:
    """P g for a layer stack (leading layer axis on state and g)."""
    return _precond_batched(state.q, plan, g)


def apply_all_factors(state: KronState, plan: KronPlan,
                      g: torch.Tensor) -> torch.Tensor:
    """A = Q g: every factor applied once (JAX ``apply_all_factors``)."""
    return _single_pass(tuple(f[None] for f in state.q), plan, g[None])[0]


def apply_all_factors_stacked(state: KronState, plan: KronPlan,
                              g: torch.Tensor) -> torch.Tensor:
    """``apply_all_factors`` per layer of a stack."""
    return _single_pass(state.q, plan, g)


def compute_p_factors(state: KronState,
                      plan: KronPlan) -> Tuple[torch.Tensor, ...]:
    """The cached form of P = Q^T Q: P_i = Q_i^T Q_i for a dense factor (one
    ``matmul``, batched over a stack's layer axis), q_i^2 for a diagonal
    or scalar one, in Q's dtype (JAX ``compute_p_factors``).  Takes a
    per-tensor state or a stack's.  The fit-P geometries have no such
    form: Q already is P."""
    if plan.fits_p:
        raise ValueError("compute_p_factors: the *4P geometries fit P "
                         "directly; their apply is already a single pass")
    require_real(*(f.dtype for f in state.q))
    return tuple(f * f if diag else f.mT @ f
                 for f, diag in zip(state.q, plan.is_diag))


def precond_grad_cached(p_factors: Tuple[torch.Tensor, ...], plan: KronPlan,
                        g: torch.Tensor) -> torch.Tensor:
    """P g from the cached P_i (``compute_p_factors``): one product per
    dim, where ``precond_grad`` takes two (JAX ``precond_grad_cached``)."""
    return _single_pass(tuple(f[None] for f in p_factors), plan, g[None])[0]


def precond_grad_cached_stacked(p_factors: Tuple[torch.Tensor, ...],
                                plan: KronPlan,
                                g: torch.Tensor) -> torch.Tensor:
    """``precond_grad_cached`` per layer of a stack."""
    return _single_pass(p_factors, plan, g)


def _gram(pg: torch.Tensor, i: int, diag: bool) -> torch.Tensor:
    """term1 = contraction of pg with itself over every dim but i: (B, n, n),
    or its diagonal (B, n) for a diagonal factor."""
    x = pg.movedim(i + 1, 1)
    x = x.reshape(x.shape[0], x.shape[1], -1)
    if diag:
        return torch.sum(x * x, dim=-1)
    return torch.bmm(x, x.transpose(1, 2))


# ---------------------------------------------------------------------------
# damping and the whitening fit
# ---------------------------------------------------------------------------


def _damped_stacked(g: torch.Tensor, keys, damping: float,
                    v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """g + (damping + eps(dtype)|g|) v per layer, v keyed per layer by keys
    (reference psgd.py:334-336).  Without a pre-drawn v, one fused noise
    launch (the noise never reaches memory on CUDA).  Real dtypes only."""
    require_real(g.dtype)
    if v is not None:
        eps = torch.finfo(real_dtype_of(g.dtype)).eps
        return g + (damping + eps * torch.abs(g)) * v
    seeds = kernels.key_seed_words(keys, g.device)
    return kernels.damped_noise(g.contiguous(), seeds, damping)


def _damped(g: torch.Tensor, key, damping: float,
            v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-tensor ``_damped_stacked``."""
    return _damped_stacked(g[None], fastrand.as_keys(key)[None], damping,
                           None if v is None else v[None])[0]


def _fit_stacked(state: KronState, plan: KronPlan, src: torch.Tensor, keys,
                 lr: float, beta_l: float, damping: float, norm_k: int, draw,
                 terms) -> Tuple[KronState, torch.Tensor]:
    """The Q0.5EQ1.5 fit of a layer stack, shared by the whitening and the
    Newton fit: pg = P damped(src) with the key tree kd, krest = split(key)
    per layer, then each factor i from ``terms(pg, i, diag)`` ->
    (bound_mat, t2, step): ell = bound(bound_mat) + t2 (the spd bound, or
    the largest diagonal entry), L' from ell, and the step q1 = q - lr/L'
    (S q - t2 q) with S = ``step`` (term1 itself where it is None), then
    Procrustes for a dense factor; a diagonal factor steps
    f (1 - lr/L' step).  Then the balance gate.  Returns the new state and
    pg (pre-update Q, src's shape)."""
    _require_main_path_dq(plan.dq)
    require_real(src.dtype, *(f.dtype for f in state.q))
    b = src.shape[0]
    keys = fastrand.as_keys(keys).reshape(b, 2)
    ks = fastrand.split(keys)
    kd, krest = ks[:, 0], ks[:, 1]
    wshape = plan.shape or (1,)
    q = (state.q[0].reshape(b, 1),) if plan.order == 0 else state.q
    v = None if draw is None else draw("normal", kd, wshape, src.dtype)
    pg = _precond_batched(q, plan, _damped_stacked(_work_view(plan, src), kd,
                                                   damping, v))
    new_q, new_l = [], []
    for i, f in enumerate(q):
        keys_i = fastrand.fold_in(krest, i)
        bound_mat, t2, step = terms(pg, i, plan.is_diag[i])
        if plan.is_diag[i]:
            ell = torch.amax(torch.real(bound_mat), dim=1) + t2
            lip = _update_lips(state.lips[i], ell, beta_l)
            coeff = _coeff(lr, lip, f.dtype)[:, None]
            fq = f * (1.0 - coeff * step)
        else:
            n = f.shape[-1]
            starts = None
            if draw is not None:
                kk = width_norm_k(norm_k, n)
                starts = (draw("normal", keys_i, (kk, n), bound_mat.dtype),
                          draw("normal", fastrand.fold_in(krest, i + 200),
                               (kk, n), bound_mat.dtype))
            t2v = torch.full((b,), t2, dtype=state.lips[i].dtype,
                             device=f.device)
            fq, lip = kernels.fused_ns_update(
                bound_mat.contiguous(), f.contiguous(), state.lips[i], t2v,
                kernels.key_seed_words(keys_i, f.device), lr, beta_l,
                k=norm_k, starts=starts,
                step_mat=None if step is None else step.contiguous())
        new_q.append(fq)
        new_l.append(lip)
    if len(new_q) > 1:
        kb = fastrand.fold_in(krest, 101)
        u = (fastrand.uniform01(kb) if draw is None
             else draw("uniform", kb, (), torch.float64).tolist())
        new_q = _maybe_balance(tuple(new_q), u)
    if plan.order == 0:
        new_q = [new_q[0].reshape(b)]
    return KronState(q=tuple(new_q), lips=tuple(new_l)), pg.reshape(src.shape)


def _single_layer(state: KronState, plan: KronPlan, src: torch.Tensor, key,
                  **kw) -> Tuple[KronState, torch.Tensor]:
    """A per-tensor fit as the stacked fit of one layer keyed by ``key``
    itself (the JAX per-tensor update's key tree)."""
    st = KronState(q=tuple(f[None] for f in state.q),
                   lips=tuple(l[None] for l in state.lips))
    out, pg = _fit_stacked(st, plan, src[None], fastrand.as_keys(key)[None],
                           **kw)
    return KronState(q=tuple(f[0] for f in out.q),
                     lips=tuple(l[0] for l in out.lips)), pg[0]


def _whiten_terms(plan: KronPlan):
    """The whitening fit's terms: term1 = exprGs(Pg, Pg), term2 = numel / n."""
    wshape = plan.shape or (1,)

    def terms(pg, i, diag):
        term1, term2 = _gram(pg, i, diag), plan.numel / wshape[i]
        return term1, term2, (term1 - term2) if diag else None
    return terms


def _newton_terms(plan: KronPlan, v: torch.Tensor):
    """The Newton fit's terms from the stacked probe v: term1 =
    exprGs(P damped(h), same), term2 = exprGs(v, v); the bound's matrix
    term1 + term2, no scalar term2, the step matrix term1 - term2."""
    require_real(v.dtype)
    vw = _work_view(plan, v)

    def terms(ph, i, diag):
        term1, term2 = _gram(ph, i, diag), _gram(vw, i, diag)
        return term1 + term2, 0.0, term1 - term2
    return terms


def update_kron_whiten_stacked(state: KronState, plan: KronPlan,
                               g: torch.Tensor, keys, lr: float = 0.1,
                               beta_l: float = 0.9, damping: float = 1e-9,
                               norm_k: int = 32, draw=None,
                               return_pg: bool = False):
    """Q0.5EQ1.5 whitening fit of a layer stack (reference psgd.py:394-419,
    JAX update_kron_whiten_stacked).

    ``state`` tensors and ``g`` carry a leading layer axis B; ``keys`` is a
    (B, 2) host key array, one key per layer.  Layer i's result depends on
    state[i], g[i] and keys[i] only.  Every dense factor of the stack is
    one NS update (one kernel chain on CUDA); the damping is one launch.
    ``draw(kind, keys, shape, dtype)`` -> (B,)+shape tensor replaces the
    draws ("normal" for the probe and the bound starts, "uniform" for the
    balance gate).  term1 = exprGs(Pg, Pg) and term2 = numel / n.
    ``return_pg``: also return the fit's P damped(g), formed with the
    pre-update Q (the apply that ``share_fit_apply`` reuses)."""
    st, pg = _fit_stacked(state, plan, g, keys, lr, beta_l, damping, norm_k,
                          draw, _whiten_terms(plan))
    return (st, pg) if return_pg else st


def update_kron_whiten(state: KronState, plan: KronPlan, g: torch.Tensor,
                       key, lr: float = 0.1, beta_l: float = 0.9,
                       damping: float = 1e-9, norm_k: int = 32,
                       draw=None, return_pg: bool = False):
    """Q0.5EQ1.5 whitening fit of one tensor: the stacked fit with one layer
    keyed by ``key`` itself (the JAX per-tensor update's key tree).
    ``return_pg`` as ``update_kron_whiten_stacked``."""
    st, pg = _single_layer(state, plan, g, key, lr=lr, beta_l=beta_l,
                           damping=damping, norm_k=norm_k, draw=draw,
                           terms=_whiten_terms(plan))
    return (st, pg) if return_pg else st


def update_kron_newton_stacked(state: KronState, plan: KronPlan,
                               v: torch.Tensor, h: torch.Tensor, keys,
                               lr: float = 0.1, beta_l: float = 0.9,
                               damping: float = 1e-9, norm_k: int = 32,
                               draw=None) -> KronState:
    """Q0.5EQ1.5 Newton fit of a layer stack from a probe v and its
    Hessian-vector product h (reference psgd.py:777-829, JAX
    update_kron_newton_stacked).

    As the whitening fit, with the damping on h and both terms from the
    pair: term1 = exprGs(P damped(h), same), term2 = exprGs(v, v), formed
    in their dtype (Q's, in the optimizer).  A diagonal factor takes
    ell = max(term1 + term2) and steps f (1 - lr/L' (term1 - term2)); a
    dense factor is one NS update with term1 + term2 as its bound's matrix,
    no scalar term2 and the step matrix term1 - term2.  Keys and ``draw``
    as ``update_kron_whiten_stacked``."""
    return _fit_stacked(state, plan, h, keys, lr, beta_l, damping, norm_k,
                        draw, _newton_terms(plan, v))[0]


def update_kron_newton(state: KronState, plan: KronPlan, v: torch.Tensor,
                       h: torch.Tensor, key, lr: float = 0.1,
                       beta_l: float = 0.9, damping: float = 1e-9,
                       norm_k: int = 32, draw=None) -> KronState:
    """Q0.5EQ1.5 Newton fit of one tensor from (v, h): the stacked fit with
    one layer keyed by ``key`` itself (the JAX per-tensor update's key
    tree)."""
    return _single_layer(state, plan, h, key, lr=lr, beta_l=beta_l,
                         damping=damping, norm_k=norm_k, draw=draw,
                         terms=_newton_terms(plan, v[None]))[0]
