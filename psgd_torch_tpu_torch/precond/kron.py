"""Kronecker-factored PSGD preconditioner: the seven dQ geometries' fits.

Counterpart of psgd_torch_tpu/precond/kron.py: plans and state, balancing,
the L-constants, the apply P g = Q^H Q g (P g = Q g for the fit-P
geometries QUAD4P and PRO4P) and its cached form (P_i = Q_i^H Q_i per
factor, then one product per dim), the damping, and the whitening fit
(from a gradient g, optionally returning its P damped(g)) and Newton fit
(from a probe v and its Hessian-vector product h) of every geometry, per
tensor and for a layer stack, plus the exact EQ whitening
(``update_kron_whiten_eq_exact``), and the dim-sharded fit of one global
preconditioner from a rank's blocks of a leaf whose dims are sharded
(``update_kron_whiten_dim_sharded`` / ``_newton_``, Q0.5EQ1.5, QUAD and
QEQ: ``dim_shard_reshard_plan``'s compute layout, the terms summed over
the mesh through the one fit core's ``reduce`` hook).  Real (bf16, f32, f64) and complex
(complex64, complex128) tensors alike: every contraction conjugates where
the JAX package's does (Q^H, x x^H, (p + p^H) / 2), so a complex Q stays
a Hermitian preconditioner's factor.  f64 and complex factors take the
XLA tail (``kernels.ns_route`` "xla"; the bounds and the Procrustes loop
in PyTorch operations), as the JAX package does.

Geometries (``_GEOMETRIES``): Q0.5EQ1.5 (the default) steps each dense
factor through the NS update, ``kernels.fused_ns_update``; QEP, QEQ,
PRO4P, QUAD and QUAD4P form P damped(src) and step each dense factor with
``matmul`` products, its L from ``kernels.norm_bound`` (spd), PRO4P then
running ``linalg.procrustes_loop3`` (``kernels.tsub`` and the skew
``kernels.norm_bound`` per step); EQ forms A = Q h and v Q^-1
(``torch.linalg.solve_triangular``) and steps triu(term1 - term2) Q.  On
CUDA the damping is ``kernels.damped_noise`` and EQ whitening's probe
``kernels.unit_noise`` (both one launch per stack, in the complex mode
for a complex tensor); on the CPU their plain versions.

Contractions are explicit per-dimension products (one ``matmul`` along one
axis at a time, Q^H after Q), never a multi-operand einsum: the card's
PyTorch has no opt_einsum, and contracting left to right would start the
exprP chain of a (768, 2304) leaf with a 768*768*2304-element outer
product.  Plans therefore carry no subscripts.

Randomness: every function that draws takes host-side threefry keys
(``ops.fastrand``) and derives the JAX package's key tree from them, so
a draw is a pure function of (seed, step, leaf, layer, purpose).  An
optional ``draw(kind, keys, shape, dtype)`` hook replaces the draws with
pre-drawn tensors (the CPU tests replay the JAX draws through it).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .. import resolve_device
from ..ops import fastrand, kernels
from ..ops.linalg import (lift2single, lifted_real_dtype, norm_lower_bound,
                          procrustes_loop3, real_dtype_of, stack_norm_bound,
                          width_norm_k)

DQ_EQ = "EQ"
DQ_QEP = "QEP"
DQ_QEQ = "QEQ"
DQ_QUAD = "QUAD"
DQ_Q05EQ15 = "Q0.5EQ1.5"
DQ_QUAD4P = "QUAD4P"
DQ_PRO4P = "PRO4P"
ALL_DQ = (DQ_EQ, DQ_QEP, DQ_QEQ, DQ_QUAD, DQ_Q05EQ15, DQ_QUAD4P, DQ_PRO4P)
_FIT_P = frozenset({DQ_QUAD4P, DQ_PRO4P})
# the geometries the dim-sharded (factor_sharding) fit implements
DIM_SHARDABLE_DQS = frozenset({DQ_Q05EQ15, DQ_QUAD, DQ_QEQ})
MAX_ORDER = 26
BALANCE_PROB = 0.01


def canonical_dq(dq: str) -> str:
    dq = {"Q0p5EQ1p5": DQ_Q05EQ15}.get(dq, dq)
    if dq not in ALL_DQ:
        raise ValueError(f"Invalid dQ {dq!r}; valid choices: {ALL_DQ}")
    return dq


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


def balance_kron(q: Tuple[torch.Tensor, ...], batched: bool = False,
                 reduce=None) -> Tuple[torch.Tensor, ...]:
    """Rescale the factors to a common max-abs (their geometric mean),
    preventing over/underflow (reference psgd.py:266-275).  ``batched``:
    every factor carries a leading layer axis, balanced per layer.
    ``reduce``: a dim-sharded fit's ``_DimReduce``, whose ``max`` takes a
    sharded diagonal factor's max-abs over its shards."""
    if len(q) <= 1:
        return q
    acc = lifted_real_dtype(q[0].dtype)
    dims = [tuple(range(1, f.ndim)) if batched else tuple(range(f.ndim))
            for f in q]
    norms = [torch.amax(torch.abs(f), dim=d).to(acc) if d else
             torch.abs(f).to(acc) for f, d in zip(q, dims)]
    if reduce is not None:
        norms = [reduce.max(i, n) for i, n in enumerate(norms)]
    gmean = torch.prod(torch.stack(norms), dim=0) ** (1.0 / len(q))
    out = []
    for f, n in zip(q, norms):
        mult = (gmean / n).to(real_dtype_of(f.dtype))
        if batched:
            mult = mult.reshape((-1,) + (1,) * (f.ndim - 1))
        out.append(f * mult)
    return tuple(out)


def _maybe_balance(q: Tuple[torch.Tensor, ...], u, prob: float = BALANCE_PROB,
                   reduce=None):
    """Balance layer i of a stack when u[i] < prob (the host-decided analogue
    of the reference's torch.rand gate, psgd.py:318).  u: (B,) host
    uniforms in [0, 1).  ``reduce`` as ``balance_kron``."""
    if len(q) <= 1:
        return q
    mask = [float(x) < prob for x in u]
    if not any(mask):
        return q
    bal = balance_kron(q, batched=True, reduce=reduce)
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
    batched tensor x (B, ...): f @ x along that axis, or f^H @ x."""
    ax = dim + 1
    if transpose:
        f = f.conj()
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
    """Every factor applied once along its dim (f^H with ``transpose``)."""
    for i, f in enumerate(qs):
        x = _apply_factor(f, x, i, transpose)
    return x


def _p_work(q, plan: KronPlan, x: torch.Tensor) -> torch.Tensor:
    """P x for x already in its work view (batch axis first)."""
    qs = _batched_factors(q)
    x = _factor_pass(qs, x, transpose=False)
    if not plan.fits_p:
        x = _factor_pass(qs, x, transpose=True)
    return x


def _precond_batched(q, plan: KronPlan, g: torch.Tensor) -> torch.Tensor:
    """P g per batch element: Q applied along every dim, then Q^H (for the
    fit-P geometries, Q alone).  q factors and g carry the batch axis."""
    return _p_work(q, plan, _work_view(plan, g)).reshape(g.shape)


def _single_pass(factors, plan: KronPlan, g: torch.Tensor) -> torch.Tensor:
    """Each factor applied once along its dim; factors and g carry the
    batch axis."""
    x = _factor_pass(_batched_factors(factors), _work_view(plan, g),
                     transpose=False)
    return x.reshape(g.shape)


def precond_grad(state: KronState, plan: KronPlan,
                 g: torch.Tensor) -> torch.Tensor:
    """P g for one tensor: P = Q^H Q (or P = Q for the fit-P geometries)."""
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
    """The cached form of P = Q^H Q: P_i = Q_i^H Q_i for a dense factor (one
    ``matmul``, batched over a stack's layer axis), |q_i|^2 for a diagonal
    or scalar one, in Q's dtype (JAX ``compute_p_factors``).  Takes a
    per-tensor state or a stack's.  The fit-P geometries have no such
    form: Q already is P."""
    if plan.fits_p:
        raise ValueError("compute_p_factors: the *4P geometries fit P "
                         "directly; their apply is already a single pass")
    return tuple(f.conj() * f if diag else f.mH @ f
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
    """term1 = contraction of pg with its conjugate over every dim but i:
    X X^H (B, n, n) with X pg's dim i against the rest, or its diagonal
    (B, n) for a diagonal factor."""
    x = pg.movedim(i + 1, 1)
    x = x.reshape(x.shape[0], x.shape[1], -1)
    if diag:
        return torch.sum(x * x.conj(), dim=-1)
    return torch.bmm(x, x.mH)


# ---------------------------------------------------------------------------
# damping and the whitening fit
# ---------------------------------------------------------------------------


def _damped_stacked(g: torch.Tensor, keys, damping: float,
                    v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """g + (damping + eps(dtype)|g|) v per layer, v keyed per layer by keys
    (reference psgd.py:334-336).  Without a pre-drawn v, one fused noise
    launch (the noise never reaches memory on CUDA); a complex g takes the
    complex mode, its v keyed per layer by split(keys[i])."""
    if v is not None:
        eps = torch.finfo(real_dtype_of(g.dtype)).eps
        return g + (damping + eps * torch.abs(g)) * v
    seeds = kernels.key_seed_words(fastrand.noise_keys(keys, g.dtype), g.device)
    return kernels.damped_noise(g.contiguous(), seeds, damping)


def _damped(g: torch.Tensor, key, damping: float,
            v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-tensor ``_damped_stacked``."""
    return _damped_stacked(g[None], fastrand.as_keys(key)[None], damping,
                           None if v is None else v[None])[0]


class _Geometry(NamedTuple):
    """How a geometry fits a factor (JAX ``_WHITEN_UPDATES``,
    kron.py:568-576, and ``_NEWTON_UPDATES``, :732-740).

    What it forms: P damped(src) with Q^T after Q (Q0.5EQ1.5, QEP, QEQ,
    QUAD), or one pass of the factors (PRO4P, QUAD4P: Q already is P;
    ``plan.fits_p``); EQ forms A = Q h and v Q^-1 instead.  Its key tree:
    kd, krest = split(key) (EQ whitening kv, kd, krest = split(key, 3), its
    own probe from kv); factor i's bound keyed fold_in(krest, i).  Its
    dense step, with E = S - shift (whitening S = term1, shift = numel / n;
    Newton and QEP whitening S = term1 - term2, no shift):

    * ``"ns"``: the NS update, one ``kernels.fused_ns_update`` per stack:
      the bound of term1 (whitening) or term1 + term2 (Newton, with S as
      its step matrix), q - c E q and one Procrustes rotation keyed
      fold_in(krest, i + 200) (Q0.5EQ1.5);
    * ``"left"``: q - c E q (QEP, PRO4P; PRO4P then ``procrustes_loop3``
      keyed fold_in(krest, i + 200));
    * ``"right"``: q - c q E (QEQ);
    * ``"quad"``: p = q - c E q, p = p - c p E, then (p + p^H) / 2, at
      c = lr / (2 L) (QUAD) or lr / L (QUAD4P); a diagonal factor is
      q (1 - c E)^2;
    * ``"triu"``: q - c triu(E) q (EQ).

    Its balance: every geometry gates at fold_in(krest, 101) after the fit
    but QEP (``qep``), which balances before the fit, every time and with
    no gate, and whose terms contract Q_i applied to pg (and to v)."""
    side: str
    loop3: bool = False
    qep: bool = False
    step_div: float = 1.0


_GEOMETRIES = {
    DQ_Q05EQ15: _Geometry("ns"),
    DQ_EQ: _Geometry("triu"),
    DQ_QEP: _Geometry("left", qep=True),
    DQ_QEQ: _Geometry("right"),
    DQ_PRO4P: _Geometry("left", loop3=True),
    DQ_QUAD: _Geometry("quad", step_div=2.0),
    DQ_QUAD4P: _Geometry("quad"),
}


def _spd_bound(mat: torch.Tensor, keys, norm_k: int, draw) -> torch.Tensor:
    """The spd norm bound of each matrix of a stack (B, n, n), keyed per
    layer: ``linalg.stack_norm_bound`` (``kernels.norm_bound``, row 5 on
    CUDA, for f32 and bf16; the XLA tail's bound for the other dtypes)."""
    n = mat.shape[-1]
    start = (None if draw is None else
             draw("normal", keys, (width_norm_k(norm_k, n), n), mat.dtype))
    return stack_norm_bound(mat, kernels.key_seed_words(keys, mat.device),
                            "spd", k=norm_k, v0=start)


def _probe(keys, wshape, dtype, device, draw) -> torch.Tensor:
    """EQ whitening's probe v per layer: ``kernels.unit_noise`` (uniform on
    +-sqrt3, unit variance, where JAX draws a standard normal; the fit
    needs only E[v v^T] = I), or the replayed draw."""
    if draw is not None:
        return draw("normal", keys, wshape, dtype)
    return fastrand.unit_noise_stacked(keys, wshape, dtype, device)


def _solve_factors(q, plan: KronPlan, v: torch.Tensor) -> torch.Tensor:
    """v Q^-1 along every dim of a batched v (EQ passes conj(v)): a
    diagonal factor divides, a
    dense (upper triangular) factor is one right-hand triangular solve
    along its axis, lifted to f32 for bf16 (JAX ``_update_eq_core``'s
    conj_b; XLA's ``triangular_solve`` there)."""
    for i, f in enumerate(_batched_factors(q)):
        ax = i + 1
        if f.ndim == 2:
            view = [f.shape[0]] + [1] * (v.ndim - 1)
            view[ax] = f.shape[1]
            v = v / f.reshape(view)
            continue
        m = v.movedim(ax, -1)
        sh = m.shape
        sol = torch.linalg.solve_triangular(
            lift2single(f), lift2single(m.reshape(sh[0], -1, sh[-1])),
            upper=True, left=False)
        v = sol.to(v.dtype).reshape(sh).movedim(-1, ax)
    return v


def _ns_update(f, bound_mat, s_mat, shift, lip, krest, i, lr, beta_l, norm_k,
               draw):
    """Q0.5EQ1.5's dense step: one NS update of the stack, term2 = shift
    (whitening) or 0 with S = ``s_mat`` as the step matrix (Newton)."""
    n = f.shape[-1]
    keys_i = fastrand.fold_in(krest, i)
    starts = None
    if draw is not None:
        kk = width_norm_k(norm_k, n)
        starts = (draw("normal", keys_i, (kk, n), bound_mat.dtype),
                  draw("normal", fastrand.fold_in(krest, i + 200), (kk, n),
                       bound_mat.dtype))
    t2v = torch.full((f.shape[0],), 0.0 if shift is None else shift,
                     dtype=lip.dtype, device=f.device)
    return kernels.fused_ns_update(
        bound_mat.contiguous(), f.contiguous(), lip, t2v,
        kernels.key_seed_words(keys_i, f.device), lr, beta_l, k=norm_k,
        starts=starts, step_mat=None if shift is not None else s_mat.contiguous())


def _dense_step(geo: _Geometry, f, s_mat, shift, c):
    """A dense factor's step (see ``_Geometry``) at coefficient c."""
    def left(x):
        y = s_mat @ x
        return y if shift is None else y - shift * x

    def right(x):
        y = x @ s_mat
        return y if shift is None else y - x * shift

    if geo.side == "left":
        return f - c * left(f)
    if geo.side == "right":
        return f - c * right(f)
    if geo.side == "quad":
        p = f - c * left(f)
        p = p - c * right(p)
        return 0.5 * (p + p.mH)
    return f - c * (torch.triu(s_mat) @ f)


def _diag_step(geo: _Geometry, f, e, c):
    """A diagonal factor's step: f (1 - c E), f - c E f (EQ) or
    f (1 - c E)^2 (QUAD, QUAD4P)."""
    if geo.side == "triu":
        return f - c * e * f
    if geo.side == "quad":
        gain = 1.0 - c * e
        return f * gain * gain
    return f * (1.0 - c * e)


class _DimReduce(NamedTuple):
    """What a dim-sharded fit reduces over the mesh (JAX
    ``_update_kron_dim_sharded``, kron.py:1101-1117 and :1181-1191):
    ``term(i, t)`` sums factor i's term over the axes of the other
    diagonal dims (the contraction's sharded dims; a dense dim is whole in
    the compute layout); ``max(i, x)`` takes the max over factor i's own
    axes (a sharded diagonal factor's ell and max-abs).  ``comm``: a
    ``parallel.mesh.MeshAxes``; ``diag_axes``: per dim, its axes in the
    compute layout for a diagonal dim, () for a dense one."""
    comm: object
    diag_axes: tuple

    def term(self, i: int, t: torch.Tensor) -> torch.Tensor:
        red = tuple(ax for d, axes in enumerate(self.diag_axes) if d != i
                    for ax in axes)
        return self.comm.sum(t, red) if red else t

    def max(self, i: int, x: torch.Tensor) -> torch.Tensor:
        axes = self.diag_axes[i]
        return self.comm.max(x, axes) if axes else x


def _fit_stacked(state: KronState, plan: KronPlan, src: torch.Tensor, keys,
                 lr: float, beta_l: float, damping: float, norm_k: int, draw,
                 v: Optional[torch.Tensor] = None, *, noise_keys=None,
                 reduce: Optional[_DimReduce] = None
                 ) -> Tuple[KronState, Optional[torch.Tensor]]:
    """The fit of a layer stack in the plan's geometry (``_GEOMETRIES``):
    whitening from src = g (``v`` None), Newton from (v, src = h).  Layer
    i depends on state[i], src[i] (v[i]) and keys[i] only, with the
    per-tensor key tree (what JAX's vmap of the per-tensor update computes,
    kron.py:874-877 and :1282-1285); each dense factor is one batched chain
    over the stack.  Per factor i: term1 (and term2) as ``_Geometry``
    says, ell = bound(term1) + numel / n (whitening Q0.5EQ1.5, QEQ, PRO4P,
    QUAD, QUAD4P) or bound(term1 + term2) (QEP whitening, EQ and every
    Newton form), the largest diagonal entry for a diagonal factor, then
    L' and the step.  Returns the new state and P damped(src) in src's
    shape, formed with the pre-update (QEP: balanced) Q; None for EQ,
    which never forms it.

    The dim-sharded fit's two hooks: ``reduce`` (a ``_DimReduce``; src
    and v are then a rank's blocks in the compute layout, the diagonal
    factors its blocks of theirs) reduces the terms, a diagonal ell and
    the balance's max-abs over the mesh; ``noise_keys`` keys the damping
    (kd = split(noise_keys)[0]) apart from krest = split(keys)[1], which
    keys every replicated decision."""
    geo = _GEOMETRIES[plan.dq]
    b = src.shape[0]
    keys = fastrand.as_keys(keys).reshape(b, 2)
    gshape = plan.shape or (1,)
    wshape = gshape if reduce is None else tuple(src.shape[1:])
    q = (state.q[0].reshape(b, 1),) if plan.order == 0 else state.q
    x = src.reshape((b,) + wshape)
    vw = None if v is None else v.reshape((b,) + wshape)
    whiten = vw is None
    pg = None
    if plan.dq == DQ_EQ:
        if whiten:
            ks = fastrand.split(keys, 3)
            kv, krest = ks[:, 0], ks[:, 2]
            vw = _probe(kv, wshape, src.dtype, src.device, draw)
            eps = torch.finfo(real_dtype_of(src.dtype)).eps
            h = x + (damping + eps * torch.abs(x)) * vw
        else:
            ks = fastrand.split(keys)
            kd, krest = ks[:, 0], ks[:, 1]
            dv = None if draw is None else draw("normal", kd, wshape, src.dtype)
            h = _damped_stacked(x, kd, damping, dv)
        a = _single_pass(q, plan, h)
        conj_b = _solve_factors(q, plan, vw.conj())
    else:
        krest = fastrand.split(keys)[:, 1]
        kd = fastrand.split(keys if noise_keys is None else
                            fastrand.as_keys(noise_keys).reshape(b, 2))[:, 0]
        if geo.qep:
            q = balance_kron(q, batched=True)
        dv = None if draw is None else draw("normal", kd, wshape, src.dtype)
        pg = _p_work(q, plan, _damped_stacked(x, kd, damping, dv))
    new_q, new_l = [], []
    for i, f in enumerate(q):
        diag = plan.is_diag[i]
        if plan.dq == DQ_EQ:
            term1, term2 = _gram(a, i, diag), _gram(conj_b.conj(), i, diag)
        else:
            y = _apply_factor(f, pg, i, False) if geo.qep else pg
            term1 = _gram(y, i, diag)
            if reduce is not None:
                term1 = reduce.term(i, term1)
            if not whiten:
                vy = _apply_factor(f, vw, i, False) if geo.qep else vw
                term2 = _gram(vy, i, diag)
                if reduce is not None:
                    term2 = reduce.term(i, term2)
            elif geo.qep:
                term2 = (plan.numel / gshape[i]) * (f * f.conj() if diag
                                                    else f @ f.mH)
            else:
                term2 = plan.numel / gshape[i]
        if isinstance(term2, float):
            bound_mat, extra, s_mat, shift = term1, term2, term1, term2
        else:
            bound_mat, extra, s_mat, shift = term1 + term2, 0.0, term1 - term2, None
        if diag:
            ell = torch.amax(torch.real(bound_mat), dim=1) + extra
            if reduce is not None:
                ell = reduce.max(i, ell)
            lip = _update_lips(state.lips[i], ell, beta_l)
            c = _coeff(lr / geo.step_div, lip, f.dtype)[:, None]
            fq = _diag_step(geo, f, s_mat if shift is None else s_mat - shift, c)
        elif geo.side == "ns":
            fq, lip = _ns_update(f, bound_mat, s_mat, shift, state.lips[i],
                                 krest, i, lr, beta_l, norm_k, draw)
        else:
            ell = _spd_bound(bound_mat, fastrand.fold_in(krest, i), norm_k, draw)
            lip = _update_lips(state.lips[i], ell + extra, beta_l)
            c = _coeff(lr / geo.step_div, lip, f.dtype)[:, None, None]
            fq = _dense_step(geo, f, s_mat, shift, c)
            if geo.loop3:
                fq = procrustes_loop3(fq, fastrand.fold_in(krest, i + 200),
                                      norm_k=norm_k, draw=draw)
        new_q.append(fq)
        new_l.append(lip)
    if len(new_q) > 1 and not geo.qep:
        kb = fastrand.fold_in(krest, 101)
        u = (fastrand.uniform01(kb) if draw is None
             else draw("uniform", kb, (), torch.float64).tolist())
        new_q = _maybe_balance(tuple(new_q), u, reduce=reduce)
    if plan.order == 0:
        new_q = [new_q[0].reshape(b)]
    return (KronState(q=tuple(new_q), lips=tuple(new_l)),
            None if pg is None else pg.reshape(src.shape))


def _single_layer(state: KronState, plan: KronPlan, src: torch.Tensor, key,
                  v: Optional[torch.Tensor] = None,
                  **kw) -> Tuple[KronState, Optional[torch.Tensor]]:
    """A per-tensor fit as the stacked fit of one layer keyed by ``key``
    itself (the JAX per-tensor update's key tree)."""
    st = KronState(q=tuple(f[None] for f in state.q),
                   lips=tuple(l[None] for l in state.lips))
    out, pg = _fit_stacked(st, plan, src[None], fastrand.as_keys(key)[None],
                   v=None if v is None else v[None], **kw)
    return (KronState(q=tuple(f[0] for f in out.q),
                      lips=tuple(l[0] for l in out.lips)),
            None if pg is None else pg[0])


def _refuse_eq_pg(plan: KronPlan, return_pg: bool) -> None:
    if return_pg and plan.dq == DQ_EQ:
        raise ValueError("EQ geometry does not compute Pg during the fit; "
                         "share_fit_apply is unsupported for dq='EQ'")


def update_kron_whiten_stacked(state: KronState, plan: KronPlan,
                               g: torch.Tensor, keys, lr: float = 0.1,
                               beta_l: float = 0.9, damping: float = 1e-9,
                               norm_k: int = 32, draw=None,
                               return_pg: bool = False):
    """Whitening fit of a layer stack in the plan's geometry (reference
    psgd.py:330-513, JAX update_kron_whiten_stacked).

    ``state`` tensors and ``g`` carry a leading layer axis B; ``keys`` is a
    (B, 2) host key array, one key per layer.  Layer i's result depends on
    state[i], g[i] and keys[i] only.  Q0.5EQ1.5: every dense factor of the
    stack is one NS update (one kernel chain on CUDA), term1 =
    exprGs(Pg, Pg) and term2 = numel / n; the other geometries as
    ``_GEOMETRIES`` says.  The damping is one launch (EQ: the probe is).
    ``draw(kind, keys, shape, dtype)`` -> (B,)+shape tensor replaces the
    draws ("normal" for the probe and the bound starts, "uniform" for the
    balance gate).  ``return_pg``: also return the fit's P damped(g),
    formed with the pre-update Q (the apply that ``share_fit_apply``
    reuses); EQ never forms it and raises ``ValueError``."""
    _refuse_eq_pg(plan, return_pg)
    st, pg = _fit_stacked(state, plan, g, keys, lr, beta_l, damping, norm_k,
                          draw)
    return (st, pg) if return_pg else st


def update_kron_whiten(state: KronState, plan: KronPlan, g: torch.Tensor,
                       key, lr: float = 0.1, beta_l: float = 0.9,
                       damping: float = 1e-9, norm_k: int = 32,
                       draw=None, return_pg: bool = False):
    """Whitening fit of one tensor: the stacked fit with one layer keyed by
    ``key`` itself (the JAX per-tensor update's key tree).  ``return_pg``
    as ``update_kron_whiten_stacked``."""
    _refuse_eq_pg(plan, return_pg)
    st, pg = _single_layer(state, plan, g, key, lr=lr, beta_l=beta_l,
                           damping=damping, norm_k=norm_k, draw=draw)
    return (st, pg) if return_pg else st


def update_kron_newton_stacked(state: KronState, plan: KronPlan,
                               v: torch.Tensor, h: torch.Tensor, keys,
                               lr: float = 0.1, beta_l: float = 0.9,
                               damping: float = 1e-9, norm_k: int = 32,
                               draw=None) -> KronState:
    """Newton fit of a layer stack from a probe v and its Hessian-vector
    product h in the plan's geometry (reference psgd.py:657-829, JAX
    update_kron_newton_stacked).

    As the whitening fit, with the damping on h and both terms from the
    pair, formed in their dtype (Q's, in the optimizer).  Q0.5EQ1.5:
    term1 = exprGs(P damped(h), same), term2 = exprGs(v, v); a diagonal
    factor takes ell = max(term1 + term2) and steps f (1 - lr/L' (term1 -
    term2)); a dense factor is one NS update with term1 + term2 as its
    bound's matrix, no scalar term2 and the step matrix term1 - term2.
    The other geometries as ``_GEOMETRIES`` says.  Keys and ``draw`` as
    ``update_kron_whiten_stacked``."""
    return _fit_stacked(state, plan, h, keys, lr, beta_l, damping, norm_k,
                        draw, v)[0]


def update_kron_newton(state: KronState, plan: KronPlan, v: torch.Tensor,
                       h: torch.Tensor, key, lr: float = 0.1,
                       beta_l: float = 0.9, damping: float = 1e-9,
                       norm_k: int = 32, draw=None) -> KronState:
    """Newton fit of one tensor from (v, h): the stacked fit with one layer
    keyed by ``key`` itself (the JAX per-tensor update's key tree)."""
    return _single_layer(state, plan, h, key, v, lr=lr, beta_l=beta_l,
                         damping=damping, norm_k=norm_k, draw=draw)[0]


# ---------------------------------------------------------------------------
# the dim-sharded fit (factor_sharding): one global preconditioner for a leaf
# whose dims are sharded over mesh dims, from each rank's local blocks
# ---------------------------------------------------------------------------


def dim_shard_reshard_plan(plan: KronPlan, dim_axes, axis_sizes):
    """The compute layout of a dim-sharded leaf (JAX kron.py:943-995): each
    mesh axis that shards a DENSE dim moves onto the largest diagonal dim
    whose local size it divides (an ``all_to_all`` in the fit), so the
    contractions split over every shard; a dense dim whose axes find no
    such target is all-gathered instead (a partial placement is undone).

    ``dim_axes``: per plan dim, the tuple of mesh axis names sharding it
    (major to minor); ``axis_sizes``: axis name -> size.  Returns
    (eff_axes, moves, gather_dims): per dim its axes in the compute layout
    (a diagonal dim gains the moved axes, appended minor to its own); the
    ordered (dense_dim, axis, target_dim) moves; the dense dims to
    gather."""
    eff = [tuple(a) for a in dim_axes]
    local = [plan.shape[d] for d in range(len(plan.shape))]
    for d, axes in enumerate(dim_axes):
        for ax in axes:
            local[d] //= axis_sizes[ax]
    moves, gather_set = [], set()
    for d in range(len(plan.shape)):
        if plan.is_diag[d] or not dim_axes[d]:
            continue
        dim_moves = []
        ok = True
        # minor axis first: the moves in list order then reassemble dim d in
        # global order, and eff[t]'s append order is t's ownership order
        for ax in reversed(dim_axes[d]):
            k = axis_sizes[ax]
            targets = sorted((t for t in range(len(plan.shape))
                              if plan.is_diag[t] and local[t] % k == 0),
                             key=lambda t: -local[t])
            if not targets:
                ok = False
                break
            t = targets[0]
            dim_moves.append((d, ax, t))
            local[t] //= k
            eff[t] = tuple(eff[t]) + (ax,)
        if ok:
            moves.extend(dim_moves)
            eff[d] = ()
        else:
            for (_, ax, t) in dim_moves:      # undo the partial placement
                local[t] *= axis_sizes[ax]
                eff[t] = tuple(eff[t][:-1])
            gather_set.add(d)
    return tuple(eff), moves, tuple(sorted(gather_set))


def update_kron_whiten_dim_sharded(state: KronState, plan: KronPlan,
                                   g: torch.Tensor, key, dim_axes,
                                   reshard_plan, apply_src: torch.Tensor,
                                   do_update: bool, comm, lr: float = 0.1,
                                   beta_l: float = 0.9, damping: float = 1e-9,
                                   norm_k: int = 32, fit_first: bool = True,
                                   share: bool = False, pcache=None,
                                   draw=None):
    """Whitening fit and apply of one dim-sharded leaf on this rank (JAX
    ``update_kron_whiten_dim_sharded``, kron.py:998-1040).

    ``state``: dense factors whole (replicated), diagonal factors this
    rank's blocks in the compute layout (``reshard_plan``'s eff axes);
    ``g`` and ``apply_src``: this rank's blocks in the leaf's layout, in
    the plan's (squeezed) order of dims; ``dim_axes`` and ``reshard_plan``
    as ``dim_shard_reshard_plan``; ``comm``: the mesh's
    ``parallel.mesh.MeshAxes``.  ``do_update``: the fit gate (a host
    bool).  ``share``: a fit step's apply is the fit's own P damped(g) (g and
    ``apply_src`` must be one source, ``fit_first`` False); ``pcache``: the
    cached P_i in the compute layout, through which the apply runs and
    which a fit refreshes (factor-local: no collective).  ``draw`` as
    ``update_kron_whiten_stacked``, at this rank's block shape.

    Returns (new state, P apply_src as this rank's block in the leaf's
    layout), with the refreshed cache second when ``pcache`` is given."""
    return _update_kron_dim_sharded(
        state, plan, (g,), key, dim_axes, reshard_plan, apply_src, do_update,
        comm, lr, beta_l, damping, norm_k, fit_first, share, pcache, draw)


def update_kron_newton_dim_sharded(state: KronState, plan: KronPlan,
                                   v: torch.Tensor, h: torch.Tensor, key,
                                   dim_axes, reshard_plan,
                                   apply_src: torch.Tensor, do_update: bool,
                                   comm, lr: float = 0.1, beta_l: float = 0.9,
                                   damping: float = 1e-9, norm_k: int = 32,
                                   fit_first: bool = True, pcache=None,
                                   draw=None):
    """Newton fit (from a probe v and h = H v, this rank's blocks) and
    apply of one dim-sharded leaf (JAX ``update_kron_newton_dim_sharded``):
    as the whitening variant, term2 = exprGs(v, v) summed like term1."""
    return _update_kron_dim_sharded(
        state, plan, (v, h), key, dim_axes, reshard_plan, apply_src,
        do_update, comm, lr, beta_l, damping, norm_k, fit_first, False,
        pcache, draw)


def _update_kron_dim_sharded(state, plan, fit_src, key, dim_axes, reshard_plan,
                             apply_src, do_update, comm, lr, beta_l, damping,
                             norm_k, fit_first, share, pcache, draw):
    if plan.dq not in DIM_SHARDABLE_DQS:
        raise NotImplementedError(
            "the dim-sharded fit takes Q0.5EQ1.5, QUAD and QEQ")
    eff_axes, moves, gather_dims = reshard_plan

    def to_compute(x):
        for d in gather_dims:
            for ax in reversed(dim_axes[d]):
                x = comm.all_gather(x, ax, d)
        for d, ax, t in moves:
            x = comm.all_to_all(x, ax, split_dim=t, concat_dim=d)
        return x

    diag_axes = tuple(eff_axes[d] if plan.is_diag[d] else ()
                      for d in range(plan.order))
    # the damping's key folds in this rank's block along each still-sharded
    # (diagonal) dim, so each block draws its own noise; the bound,
    # Procrustes and balance keys stay unfolded, so every replicated
    # decision is bitwise equal on every rank
    key = fastrand.as_keys(key)
    k_noise = key
    for axes in diag_axes:
        if axes:
            k_noise = fastrand.fold_in(k_noise, comm.index(axes))
    reduce = _DimReduce(comm, diag_axes)

    def batched(st):
        return KronState(q=tuple(f[None] for f in st.q),
                         lips=tuple(l[None] for l in st.lips))

    def fit_core(st):
        src = [to_compute(x)[None] for x in fit_src]
        out, pg = _fit_stacked(
            batched(st), plan, src[-1], key[None], lr, beta_l, damping,
            norm_k, draw, src[0] if len(src) == 2 else None,
            noise_keys=k_noise[None], reduce=reduce)
        return (KronState(q=tuple(f[0] for f in out.q),
                          lips=tuple(l[0] for l in out.lips)), pg[0])

    def apply(st, pc=None):
        x = to_compute(apply_src)[None]
        if pc is not None:
            return _factor_pass(_batched_factors(tuple(f[None] for f in pc)),
                                x, transpose=False)[0]
        return _p_work(tuple(f[None] for f in st.q), plan, x)[0]

    cached = pcache is not None
    fit = bool(do_update)
    pc_new = pcache
    if share:
        if fit:       # the fit's P damped(g), pre-update Q, is the apply
            st_new, out = fit_core(state)
            if cached:
                pc_new = compute_p_factors(st_new, plan)
        else:
            st_new, out = state, apply(state, pcache)
    elif cached:
        st_new = fit_core(state)[0] if fit else state
        if fit:
            pc_new = compute_p_factors(st_new, plan)
        out = apply(None, pc_new if fit_first else pcache)
    else:
        st_new = fit_core(state)[0] if fit else state
        out = apply(st_new if fit_first else state)
    # back to the leaf's layout: the inverse moves, then this rank's block
    # of each gathered dim
    for d, ax, t in reversed(moves):
        out = comm.all_to_all(out, ax, split_dim=d, concat_dim=t)
    for d in gather_dims:
        loc = plan.shape[d] // comm.size(dim_axes[d])
        out = out.narrow(d, comm.index(dim_axes[d]) * loc, loc)
    return (st_new, pc_new, out) if cached else (st_new, out)


def update_kron_whiten_eq_exact(state: KronState, plan: KronPlan,
                                g: torch.Tensor, key, lr: float = 0.1,
                                beta_l: float = 0.9,
                                step_normalizer: str = "2nd",
                                draw=None) -> KronState:
    """EQ whitening of one tensor with v integrated out through explicit
    triangular inverses (the old Kron class's V=None path, reference
    preconditioned...py:2040-2070; JAX update_kron_whiten_eq_exact):
    term2_i = prod_{j != i} tr(Q_j^-H Q_j^-1) Q_i^-H Q_i^-1.  No probe: the
    only draw is the balance gate, keyed by ``key`` itself and taken
    before the fit.  ``step_normalizer`` "2nd" steps at lr / L' with
    L' from the legacy bound (``linalg.norm_lower_bound``) of term1 + term2
    (a diagonal factor: max |term1 + term2|); any other value normalizes
    the gradient by its own bound and leaves L as it is."""
    key = fastrand.as_keys(key)[None]
    q = ((state.q[0].reshape(1, 1),) if plan.order == 0 else
         tuple(f[None] for f in state.q))
    u = (fastrand.uniform01(key) if draw is None
         else draw("uniform", key, (), torch.float64).tolist())
    q = _maybe_balance(q, u)
    a = _single_pass(q, plan, _work_view(plan, g[None]))
    ihih, traces = [], []
    for f, diag in zip(q, plan.is_diag):
        if diag:
            inv = 1.0 / f
            ihih.append(inv.conj() * inv)
            traces.append(torch.sum(ihih[-1], dim=-1))
        else:
            eye = torch.eye(f.shape[-1], dtype=lift2single(f).dtype,
                            device=f.device)
            inv = torch.linalg.solve_triangular(lift2single(f), eye,
                                                upper=True).to(f.dtype)
            ihih.append(inv.mH @ inv)
            traces.append(torch.diagonal(ihih[-1], dim1=-2, dim2=-1).sum(-1))
    new_q, new_l = [], []
    for i, (f, diag) in enumerate(zip(q, plan.is_diag)):
        rd = real_dtype_of(f.dtype)
        view = (slice(None),) + (None,) * (f.ndim - 1)
        term1 = _gram(a, i, diag)
        term2 = ihih[i]
        for j, tr in enumerate(traces):
            if j != i:
                term2 = term2 * tr[view]
        if step_normalizer == "2nd":
            grad = term1 - term2
            if diag:
                ell = torch.amax(torch.abs(term1 + term2), dim=1)
            else:
                ell = norm_lower_bound(term1 + term2)
                grad = torch.triu(grad)
            lip = _update_lips(state.lips[i][None], ell, beta_l)
            scale = _coeff(lr, lip, f.dtype)[view]
        else:
            grad = term1 - term2
            if diag:
                den = torch.amax(torch.abs(grad), dim=1).to(rd)
            else:
                grad = torch.triu(grad)
                den = norm_lower_bound(grad).to(rd)
            lip = state.lips[i][None]
            scale = (lr / (den + 1e-38)).to(rd)[view]
        new_q.append(f - scale * grad * f if diag else f - scale * (grad @ f))
        new_l.append(lip[0])
    if plan.order == 0:
        return KronState(q=(new_q[0].reshape(()),), lips=tuple(new_l))
    return KronState(q=tuple(fq[0] for fq in new_q), lips=tuple(new_l))
