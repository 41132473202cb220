"""L0 numerical utilities for PSGD, in PyTorch.

Counterpart of psgd_torch_tpu/ops/linalg.py for what the Kron fits call:
the dtype policy, the subspace-iteration spectral-norm lower bounds, the
second- and third-order Procrustes rotations (the third in the loop the
fit-P geometry PRO4P runs), the legacy row/column-energy bound of the
exact EQ whitening, and the legacy families' helpers (``triu01``,
``damped_pair_vg``, ``woodbury_identity``; ``jax_max`` and
``jax_maximum``, JAX's order of complex numbers, which the legacy
families' balancing reads; ``lu_solve_t``, JAX's transposed LU solve,
which LRA and UVd take).  Every function works on a single matrix
(..., n, n) with any number of leading batch dims, so a layer stack is
one call.

Randomness is explicit.  A function that draws takes either ``v0``, the
pre-drawn (..., k, n) subspace start (tests replay the JAX draws through
it), or ``seeds``, (B, 2) Philox seed words, from which it draws
uniform(-1, 1) with ``ops.philox`` -- the same bits the CUDA kernel draws.
``procrustes_loop3`` keys its steps itself and so takes host threefry keys
(``ops.fastrand``) and the ``draw`` replay hook of ``precond.kron``.
"""

from __future__ import annotations

import torch

from . import fastrand
from .philox import uniform_pm1


def real_dtype_of(dtype: torch.dtype) -> torch.dtype:
    """Real counterpart of a (possibly complex) dtype."""
    return {torch.complex64: torch.float32,
            torch.complex128: torch.float64}.get(dtype, dtype)


def lifted_real_dtype(dtype: torch.dtype) -> torch.dtype:
    """Real dtype with at least single precision (for L-constants etc.):
    half and bfloat16 lift to float32, float32/float64 pass through."""
    rd = real_dtype_of(dtype)
    return torch.float32 if torch.finfo(rd).eps > 1e-6 else rd


def lift2single(x: torch.Tensor) -> torch.Tensor:
    """Lift half/bfloat16 to single precision; others pass through."""
    if x.dtype.is_complex:
        return x
    return x.float() if torch.finfo(x.dtype).eps > 1e-6 else x


def resolve_norm_k(norm_k, dtype: torch.dtype) -> int:
    """Subspace dimension of the norm bounds: explicit k as given, else 128
    for half/bf16 Q and 32 for single/double (reference psgd.py:48-49).
    The bounds additionally floor k at 128 above width 1024
    (``width_norm_k``)."""
    if norm_k is not None:
        return int(norm_k)
    return 128 if torch.finfo(real_dtype_of(dtype)).eps > 1e-6 else 32


def width_norm_k(k: int, n: int) -> int:
    """Floor the subspace dim at 128 for factors wider than 1024 (a fixed
    small k loosens the bound as n grows; the kernels apply the same rule)."""
    return max(k, 128) if n > 1024 else k


def sgn(x: torch.Tensor) -> torch.Tensor:
    """Complex-safe sign: x/|x| with sgn(0) = 0."""
    return torch.sgn(x)


def lu_solve_t(lu, piv, b: torch.Tensor) -> torch.Tensor:
    """x with A^T x = b from A's LU (``torch.linalg.lu_factor``): JAX's
    ``lu_solve(..., trans=1)``, a plain transpose.  torch's ``adjoint=True``
    solves with A^H, so a complex b is conjugated around it."""
    if not b.is_complex():
        return torch.linalg.lu_solve(lu, piv, b, adjoint=True)
    return torch.linalg.lu_solve(lu, piv, b.conj(), adjoint=True).conj()


def jax_max(x: torch.Tensor) -> torch.Tensor:
    """The largest entry of x; of a complex x in JAX's order, which
    ``jnp.max`` uses: by the real part, then the imaginary part."""
    if not x.is_complex():
        return torch.max(x)
    re = torch.max(x.real)
    im = torch.max(torch.where(x.real == re, x.imag, -torch.inf))
    return torch.complex(re, im)


def jax_maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The elementwise larger of a and b, complex in JAX's order (as
    ``jnp.maximum``)."""
    if not (a.is_complex() or b.is_complex()):
        return torch.maximum(a, b)
    take_a = (a.real > b.real) | ((a.real == b.real) & (a.imag >= b.imag))
    return torch.where(take_a, a, b)


def _row_norms(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.real(v * torch.conj(v)), dim=-1,
                                keepdim=True))


def _tiny(dtype: torch.dtype) -> float:
    return torch.finfo(real_dtype_of(dtype)).tiny


def _start(a: torch.Tensor, k: int, v0, seeds) -> torch.Tensor:
    if v0 is not None:
        return v0.to(a.dtype)
    if seeds is None:
        raise ValueError("pass either v0 (a pre-drawn start) or seeds")
    return uniform_pm1(seeds, (k, a.shape[-1])).reshape(
        a.shape[:-2] + (k, a.shape[-1])).to(a.dtype)


def _subspace_norm_bound(a: torch.Tensor, normalizer: torch.Tensor, k: int,
                         half_iters: int, v0=None, seeds=None) -> torch.Tensor:
    """Shared subspace-iteration core of the two norm lower bounds: the k x n
    start is rotated toward the largest row of ``a`` (reference
    psgd.py:52-56); rows are renormalized between half-iterations."""
    tiny = _tiny(a.dtype)
    a = a / normalizer[..., None, None]
    j = torch.argmax(torch.sum(torch.real(a * torch.conj(a)), dim=-1), dim=-1)
    aj = torch.take_along_dim(a, j[..., None, None], dim=-2)   # (..., 1, n)
    v = _start(a, k, v0, seeds)
    v = aj + sgn(torch.sum(aj * torch.conj(v), dim=-1, keepdim=True)) * v
    for _ in range(half_iters):
        v = v @ a
        v = v / (_row_norms(v) + tiny)
        v = v @ a
    return normalizer * torch.amax(_row_norms(v)[..., 0], dim=-1)


def norm_lower_bound_spd(a: torch.Tensor, seeds=None, k: int = 32,
                         half_iters: int = 2, v0=None) -> torch.Tensor:
    """Cheap lower bound of the spectral norm of an SPD matrix, normalized by
    the max diagonal entry (reference psgd.py:46-68)."""
    tiny = _tiny(a.dtype)
    k = width_norm_k(k, a.shape[-1])
    normalizer = torch.amax(torch.real(torch.diagonal(a, dim1=-2, dim2=-1)),
                            dim=-1) + tiny
    return torch.real(_subspace_norm_bound(a, normalizer, k, half_iters,
                                           v0, seeds))


def norm_lower_bound_skh(a: torch.Tensor, seeds=None, k: int = 32,
                         half_iters: int = 2, v0=None) -> torch.Tensor:
    """Same bound for a skew-Hermitian matrix, normalized by max |a|
    (reference psgd.py:71-93)."""
    tiny = _tiny(a.dtype)
    k = width_norm_k(k, a.shape[-1])
    normalizer = torch.amax(torch.abs(a), dim=(-2, -1)) + tiny
    return torch.real(_subspace_norm_bound(a, normalizer, k, half_iters,
                                           v0, seeds))


def compute_dtype_of(dtype: torch.dtype) -> torch.dtype:
    """Where a plain version computes for factors of ``dtype``: float32 for
    float32 and bfloat16 (the kernels' f32 accumulation); float64,
    complex64 and complex128 in their own dtype."""
    if dtype in (torch.float64, torch.complex64, torch.complex128):
        return dtype
    return torch.float32


def _toward_zero_f32(t: torch.Tensor) -> torch.Tensor:
    """f64 values rounded toward zero to f32 (returned in f64)."""
    r = t.float()
    r = torch.where(r.double().abs() > t.abs(), torch.nextafter(r, torch.zeros_like(r)), r)
    return r.double()


def tensor_core_matmul(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """x @ a in f32 for bf16 x (..., m, K) and a (..., K, n), summed as the
    Hopper tensor cores sum a bf16 ``wgmma`` into an f32 accumulator.  A
    model, fitted on an H100 against the port's tensor-core GEMM: K in
    groups of 16; in each group the 16 exact products and the accumulator
    are aligned to the largest exponent among them and truncated 2 bits
    below that exponent's f32 unit in the last place, summed, and the sum
    is rounded toward zero to f32 (tools/tc_sum_model.py measures how
    often it meets the GEMM's sums to the bit and their bf16 roundings)."""
    xd, ad = x.double(), a.double()
    acc = torch.zeros(xd.shape[:-1] + ad.shape[-1:], dtype=torch.float64,
                      device=x.device)
    for j in range(0, a.shape[-2], 16):
        terms = torch.cat([acc.unsqueeze(-2),
                           xd[..., j:j + 16, None] * ad[..., None, j:j + 16, :]], dim=-2)
        _, e = torch.frexp(terms.abs().amax(dim=-2, keepdim=True))
        quantum = torch.ldexp(torch.ones_like(terms[..., :1, :]), e - 26)
        acc = _toward_zero_f32(torch.sum(torch.trunc(terms / quantum) * quantum, dim=-2))
    return acc.float()


def norm_bound_stored(a: torch.Tensor, mode: str, seeds=None, k: int = 32,
                      half_iters: int = 2, v0=None,
                      tensor_core_sums: bool = False) -> torch.Tensor:
    """The norm lower bound of ``a`` (..., n, n) read in its storage dtype,
    as the tiled NS route takes it (pallas_kernels._tiled_bound_kernel):

    * the normalizer s (max diagonal for ``mode="spd"``, max |a| for
      ``"skh"``) divides each thin product instead of the matrix, so no
      (n, n) copy is made (row normalization is scale-invariant: the same
      bound as normalizing first);
    * the start row j has the largest row energy computed in a's dtype
      (each square rounded, the f32 sum rounded), first index on ties;
    * the thin iterate is rounded to a's dtype before each product (the
      TPU ``_dot``), products accumulate in f32 (f64 for f64 a); with
      ``tensor_core_sums`` (bf16 a) each product is summed in the order and
      rounding of the Hopper tensor cores (``tensor_core_matmul``).

    Returns the bound in f32 (f64 for f64 a)."""
    cd = compute_dtype_of(a.dtype)
    tiny = _tiny(cd)
    k = width_norm_k(k, a.shape[-1])
    if mode == "spd":
        s = torch.amax(torch.diagonal(a, dim1=-2, dim2=-1), dim=-1).to(cd)
    elif mode == "skh":
        s = torch.amax(torch.abs(a), dim=(-2, -1)).to(cd)
    else:
        raise ValueError(f"unknown bound mode {mode!r}")
    s = (s + tiny)[..., None, None]
    energy = torch.sum((a * a).to(cd), dim=-1).to(a.dtype)
    j = torch.argmax(energy, dim=-1)
    am = a.to(cd)
    aj = torch.take_along_dim(am, j[..., None, None], dim=-2) / s
    v = _start(am, k, v0, seeds)
    v = aj + sgn(torch.sum(aj * v, dim=-1, keepdim=True)) * v

    def thin(x):
        if tensor_core_sums:
            return tensor_core_matmul(x.to(a.dtype), a) / s
        return (x.to(a.dtype).to(cd) @ am) / s

    for _ in range(half_iters):
        v = thin(v)
        v = v / (_row_norms(v) + tiny)
        v = thin(v)
    return s[..., 0, 0] * torch.amax(_row_norms(v)[..., 0], dim=-1)


def stack_norm_bound(mat: torch.Tensor, seeds, mode: str = "spd",
                     k: int = 32, v0=None) -> torch.Tensor:
    """The norm lower bound of each matrix of a stack (B, n, n), ``mode``
    "spd" or "skh": ``kernels.norm_bound`` (row 5 on CUDA) for f32 and
    bf16, and for the dtypes of the XLA tail (``kernels.XLA_DTYPES``:
    f64, complex64, complex128) ``norm_lower_bound_spd`` / ``_skh``, what
    the JAX package runs there, its start a ``kernels.philox_start`` draw
    from ``seeds`` unless ``v0`` gives it.  Chosen by dtype alone."""
    from . import kernels
    if mat.dtype in kernels.XLA_DTYPES:
        fn = norm_lower_bound_spd if mode == "spd" else norm_lower_bound_skh
        if v0 is None:
            v0 = kernels.philox_start(seeds, (width_norm_k(k, mat.shape[-1]),
                                              mat.shape[-1]))
        return fn(mat, k=k, v0=v0)
    return kernels.norm_bound(mat.contiguous(), seeds, mode, 0, k=k, start=v0)


def skew_part(q: torch.Tensor) -> torch.Tensor:
    """R = Q^H - Q of each matrix of a stack: ``kernels.tsub`` (row 7 on
    CUDA) for f32 and bf16, PyTorch operations for the dtypes of the XLA
    tail (a complex Q conjugates)."""
    from . import kernels
    if q.dtype in kernels.XLA_DTYPES:
        return q.mH - q
    return kernels.tsub(q.contiguous())


def _real_trace_f32(m: torch.Tensor) -> torch.Tensor:
    """Real part of the trace, accumulated in at least float32."""
    d = torch.real(torch.diagonal(m, dim1=-2, dim2=-1))
    return torch.sum(d.to(lifted_real_dtype(d.dtype)), dim=-1)


def procrustes_step2(q: torch.Tensor, max_step_size: float = 1 / 8,
                     norm_k: int = 32, seeds=None, v0=None) -> torch.Tensor:
    """One online Procrustes rotation Q <- (I + aR + (aR)^2/2) Q with
    R = Q^H - Q and a clamped line search (reference psgd.py:101-124)."""
    rd = real_dtype_of(q.dtype)
    tiny = _tiny(q.dtype)
    r = torch.conj(q.transpose(-2, -1)) - q
    r = r / (norm_lower_bound_skh(r, seeds, k=norm_k, v0=v0)
             + tiny)[..., None, None]
    rq = r @ q
    rrq = r @ rq
    tr_rq = _real_trace_f32(rq)
    tr_rrq = _real_trace_f32(rrq)
    neg = tr_rrq < 0
    safe_den = torch.where(neg, tr_rrq, -torch.ones_like(tr_rrq))
    a = torch.where(neg, torch.clamp(-tr_rq / safe_den, max=max_step_size),
                    torch.full_like(tr_rq, max_step_size))
    a = a.to(rd)[..., None, None]
    return q + a * (rq + (0.5 * a) * rrq)


def procrustes_step3(q: torch.Tensor, seeds: torch.Tensor,
                     max_step_size: float = 1 / 3, norm_k: int = 32,
                     v0=None) -> torch.Tensor:
    """One online Procrustes rotation of each Q of a stack (B, n, n), the
    third-order expansion Q <- (I + aR + (aR)^2/2 + (aR)^3/8) Q of exp(aR)
    with R = Q^H - Q and a the larger root of the step-size quadratic,
    clamped at ``max_step_size`` and 0 where tr(RQ) <= 0 or tr(RRRQ) >= 0;
    traces in at least float32 (reference psgd.py:127-155, JAX
    ``procrustes_step3``).  R is ``skew_part`` and its norm bound
    ``stack_norm_bound(..., "skh")`` keyed by ``seeds`` (B, 2) (or
    started at ``v0``): for f32 and bf16 kernels on CUDA, their plain
    versions on the CPU.  The three products stay ``matmul``."""
    q = q.contiguous()
    return _step3(q, skew_part(q), seeds, max_step_size, norm_k, v0)


def _step3(q, r, seeds, max_step_size, norm_k, v0):
    """``procrustes_step3`` given R = Q^H - Q."""
    rd = real_dtype_of(q.dtype)
    tiny = _tiny(q.dtype)
    rnorm = stack_norm_bound(r, seeds, "skh", k=norm_k, v0=v0)
    r = r / (rnorm.to(rd) + tiny)[..., None, None]
    rq = r @ q
    rrq = r @ rq
    rrrq = r @ rrq
    tr_rq = _real_trace_f32(rq)
    tr_rrq = _real_trace_f32(rrq)
    tr_rrrq = _real_trace_f32(rrrq)
    active = (tr_rq > 0) & (tr_rrrq < 0)
    radicand = torch.clamp(tr_rrq * tr_rrq - 1.5 * tr_rq * tr_rrrq, min=0.0)
    safe_den = torch.where(active, 0.75 * tr_rrrq, -torch.ones_like(tr_rrrq))
    a = torch.clamp((-tr_rrq - torch.sqrt(radicand)) / safe_den,
                    max=max_step_size)
    a = torch.where(active, a, torch.zeros_like(a)).to(rd)[..., None, None]
    return q + a * (rq + (0.5 * a) * (rrq + (0.25 * a) * rrrq))


def procrustes_loop3(q: torch.Tensor, keys, max_iters: int = 10,
                     rel_tol: float = 1e-3, norm_k: int = 32,
                     draw=None) -> torch.Tensor:
    """Up to ``max_iters`` third-order Procrustes steps on each Q of a stack
    (B, n, n), a layer leaving once max|Q^H - Q| < rel_tol max|Q| and not
    changed after that: what JAX's vmapped ``procrustes_loop3`` (a
    ``while_loop``) computes per layer (reference psgd.py:446-449).

    Step s of layer b is keyed by ``fold_in(keys[b], s)`` (``keys``: (B, 2)
    host threefry keys); ``draw(kind, keys, shape, dtype)`` replaces the
    steps' bound starts.  The loop runs all ``max_iters`` steps, each
    masked per layer, so the card never waits on the host for the exit
    test: 10 ``tsub`` and 10 skew ``norm_bound`` launches per call (f32,
    bf16; the XLA dtypes run both in PyTorch operations).
    ``procrustes_loop3.layer_steps`` sums, on the device, the steps that
    changed a layer (reset it to 0 to count afresh)."""
    from . import kernels
    keys = fastrand.as_keys(keys).reshape(q.shape[0], 2)
    active = torch.ones(q.shape[0], dtype=torch.bool, device=q.device)
    taken = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    q = q.contiguous()
    for step in range(max_iters):
        r = skew_part(q)
        asym = torch.amax(torch.abs(r), dim=(-2, -1))
        active = active & (asym >= rel_tol * torch.amax(torch.abs(q),
                                                        dim=(-2, -1)))
        ks = fastrand.fold_in(keys, step)
        v0 = None
        if draw is not None:
            n = q.shape[-1]
            v0 = draw("normal", ks, (width_norm_k(norm_k, n), n), q.dtype)
        stepped = _step3(q, r, kernels.key_seed_words(ks, q.device), 1 / 3,
                         norm_k, v0)
        q = torch.where(active[:, None, None], stepped, q)
        taken += active
    procrustes_loop3.layer_steps = procrustes_loop3.layer_steps + taken.sum()
    return q


procrustes_loop3.layer_steps = 0


def norm_lower_bound(a: torch.Tensor) -> torch.Tensor:
    """Legacy spectral-norm lower bound of each matrix (..., n, n) from its
    largest row or column energy, ||A|| <= sqrt(2) bound; 0 for A = 0
    (reference preconditioned...py:70-98, JAX ``norm_lower_bound``), real
    or complex; the exact EQ whitening's bound."""
    max_abs = torch.amax(torch.abs(a), dim=(-2, -1))
    scale = torch.where(max_abs > 0, max_abs, torch.ones_like(max_abs))
    s = a / scale[..., None, None]
    aa = torch.real(s * torch.conj(s))
    col, row = torch.sum(aa, dim=-2), torch.sum(aa, dim=-1)
    use_rows = torch.amax(col, dim=-1) > torch.amax(row, dim=-1)

    def unit(x):
        xn = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return x / torch.where(xn > 0, xn, torch.ones_like(xn))

    j0 = torch.argmax(col, dim=-1)[..., None, None]
    c0 = torch.take_along_dim(s, j0, dim=-1).mT           # column j0 (..., 1, n)
    b0 = torch.linalg.vector_norm(unit(c0.conj() @ s) @ s.mH, dim=(-2, -1))
    j1 = torch.argmax(row, dim=-1)[..., None, None]
    r1 = torch.take_along_dim(s, j1, dim=-2)              # row j1 (..., 1, n)
    b1 = torch.linalg.vector_norm(unit(r1.conj() @ s.mT) @ s.conj(),
                                  dim=(-2, -1))
    bound = torch.where(use_rows, b0, b1)
    return torch.where(max_abs > 0, max_abs * bound, max_abs)


def triu01(a: torch.Tensor) -> torch.Tensor:
    """triu(A, 0) + triu(A, 1): the cheap approximation of the R factor of
    qr(I + A) for small A (reference preconditioned...py:115-117, JAX
    ``triu01``)."""
    return torch.triu(a) + torch.triu(a, 1)


def damped_pair_vg(g: torch.Tensor, damp: float = 2 ** -13,
                   v: torch.Tensor | None = None,
                   generator: torch.Generator | None = None):
    """(v, g + damp mean|g| v): the damped pair of the legacy whitening
    fits, which lower-bounds E[g g^T] (reference preconditioned...py:50-67,
    JAX ``damped_pair_vg``).  ``v`` is the pre-drawn standard normal probe;
    without it one is drawn with ``generator`` on g's device."""
    if v is None:
        v = torch.randn(g.shape, dtype=g.dtype, device=g.device,
                        generator=generator)
    return v, g + (damp * torch.mean(torch.abs(g))) * v


def woodbury_identity(inv_a: torch.Tensor, u: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """inv(A + U V) from inv(A) by the Woodbury identity, inv(A) - inv(A) U
    (I + V inv(A) U)^-1 V inv(A), the k x k solve in at least float32
    (reference preconditioned...py:101-112, JAX ``woodbury_identity``)."""
    iau = inv_a @ u
    via = v @ inv_a
    eye = torch.eye(u.shape[1], dtype=inv_a.dtype, device=inv_a.device)
    sol = torch.linalg.solve(lift2single(eye + v @ iau), lift2single(via))
    return inv_a - iau @ sol.to(inv_a.dtype)
