"""The hand-written Hopper kernels of the PSGD hot path, their plain PyTorch
versions, and the build that makes them.

Counterpart of psgd_torch_tpu/ops/pallas_kernels.py, all nine of its
kernels:

* ``fused_ns_update`` -- the Q0.5EQ1.5 dense-factor update (spd norm bound,
  L and lr/L, the q1 step, the Procrustes rotation), batched over a layer
  stack.  The step's matrix is term1 (the whitening fit) or a separate
  ``step_mat`` S (the Newton fit: term1 = A + B, S = A - B), on every
  route, as the TPU kernels' ``has_step_mat`` variant.  It routes by factor width and dtype as the JAX package does
  (``ns_route``), because the routes store their intermediates
  differently in bf16:

  - ``"single"`` (csrc/ns_update.cu): one chain with q1, R, RQ and RRQ in
    f32.  Replaces ``_ns_kernel``.
  - ``"split"``: ``ns_step`` then ``procrustes`` (csrc/ns_update.cu), q1
    stored in Q's dtype between them.  Replaces ``_ns_step_kernel`` and
    ``_procrustes_kernel`` of ``_split_ns_update``.
  - ``"tiled"``: ``norm_bound``, ``tiled_step``, ``tsub``,
    ``scaled_matmul_trace`` (twice) and ``combine`` (csrc/ns_tiled.cu), q1,
    R, RQ and RRQ stored in Q's dtype.  Replaces the five kernels of
    ``_tiled_ns_update``.  ``norm_bound`` also bounds every dense factor
    of the six other geometries' fits (precond/kron.py), and with ``tsub``
    runs each step of PRO4P's Procrustes loop (``linalg.procrustes_loop3``).
* ``damped_noise`` and ``unit_noise`` (csrc/noise.cu) -- per-batch-seeded
  Philox4x32-10 uniform(-sqrt3, sqrt3) noise, alone or fused into the
  whitening damping g + (damping + eps|g|) v, in f32, bf16 and f64, and
  in a complex mode (complex64, complex128: the real part from one stream,
  the imaginary part from another, each scaled by 2^-0.5).  Replaces
  ``unit_noise``/``_noise_kernel`` and the damping around it.

The XLA tail.  For the dtypes the JAX package's kernels refuse (float64,
complex64, complex128: ``ns_update_supported``, ``unit_noise_supported``)
the JAX package runs its XLA tail (``kron._ns_tail_stacked_xla``), and
``ns_route`` sends them to ``"xla"``, its counterpart in PyTorch
operations (``xla_ns_update``: the bound and the Procrustes step of
``ops.linalg``, their products ``torch.matmul``, cuBLAS on the card; the
dense preconditioner's Procrustes step alone, ``xla_procrustes``).  The
route is chosen by dtype alone; f32 and bf16 never take it.  The noise
kernel takes those dtypes itself.

Products: every bf16 product at a width n % 8 == 0 runs on the Hopper
tensor cores (csrc/ns_gemm_sm90.cuh: TMA loads, ``wgmma``, f32
accumulation): those of the single route, ``ns_step``, ``procrustes``,
``norm_bound``, ``tiled_step`` and ``scaled_matmul_trace``.  TMA needs
16-byte rows, so a bf16 width n % 8 != 0 is refused by every wrapper but
the single route's and ``norm_bound``'s, which take it on the FFMA GEMM of
csrc/ns_common.cuh (a rule on shape: the route for "anything else", and
the bound every geometry's fit calls, may be sent such a width).  Every
f32 product runs on the FFMA GEMM (f32 operands, no TF32).

Dispatch: a wrapper takes its plain version only for tensors on the CPU.
For a CUDA tensor it launches the kernel or raises; nothing falls back.
Each wrapper counts its launches in a plain integer attribute
(``ns_step.launches`` and so on), and the three that take a step matrix
(``fused_ns_update``, ``ns_step``, ``tiled_step``) also count the launches
given one (``.step_mat_launches``); a route counts nothing itself.

Build: at first use, nvcc compiles every ``csrc/*.cu`` for sm_90a (one
process per source, all started together) and links them into one shared
library with a plain C interface under ``build/kernels/`` at the repository
root, named by a hash of the sources; ctypes binds it.  Every C entry point
launches on PyTorch's current stream, allocates nothing, does not
synchronize, and returns a failed tensor-map encoding of the tensor-core
GEMM if there was one, else ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from .linalg import (compute_dtype_of, lifted_real_dtype, norm_bound_stored,
                     norm_lower_bound_spd, procrustes_step2, real_dtype_of,
                     width_norm_k)
from .philox import UNIT_SCALE, seed_words_u32, uniform_pm1, unit_uniform

NORM_K = 32
SKH_TAG = 0x5BD1E995  # xored into seed word 1 for the skew bound's stream

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the noise kernel's dtypes; a complex dtype takes four seed words per
# batch element (its two streams), the others two
_NOISE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2,
               torch.complex64: 3, torch.complex128: 4}
_MODE_CODE = {"spd": 0, "skh": 1}
_TENSOR_MAP_ERROR = 10000  # + a CUresult: the tensor-core GEMM's host side
# TMA moves 16-byte rows: the tensor-core GEMM's bf16 widths are multiples of 8
_TC_WIDTH_MULTIPLE = 8

# Width caps of the JAX package's NS routes (pallas_kernels.py:215-218 and
# :552-553): the single route up to the first, the split up to the second,
# the tiled up to the third; n a multiple of 128.
NS_CAPS = {torch.bfloat16: (1536, 2048, 4096), torch.float32: (1280, 1536, 3072)}
NS_ROUTES = ("single", "split", "tiled")
# the dtypes of the XLA tail (``ns_route`` -> "xla"): those the JAX
# package's NS and noise kernels refuse
XLA_DTYPES = (torch.float64, torch.complex64, torch.complex128)


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine with the card")


def build() -> tuple[Path, str]:
    """Compile csrc/*.cu into one shared library (if not already built for
    these sources).  Returns (library path, nvcc's -Xptxas -v report, which
    is kept beside the library)."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        digest.update(f.name.encode() + f.read_bytes())
    lib = BUILD_DIR / f"libpsgd_kernels_{digest.hexdigest()[:16]}.so"
    report_file = lib.with_suffix(".ptxas.txt")
    if lib.exists():
        return lib, report_file.read_text() if report_file.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC)]
    procs = []
    for src in sources:
        obj = BUILD_DIR / f"{src.stem}_{digest.hexdigest()[:16]}.o"
        procs.append((obj, subprocess.Popen(
            [nvcc, *flags, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    report, objs = [], []
    for obj, p in procs:
        out, _ = p.communicate()
        report.append(out)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {obj.name}:\n{out}")
        objs.append(str(obj))
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    report_file.write_text("".join(report))
    os.replace(tmp, lib)
    return lib, report_file.read_text()


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The bound kernel library (built on first call)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    vp, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    signatures = {
        "psgd_noise": ([vp, vp, vp, i32, i64, i32, i32, f32, ctypes.c_double,
                        ctypes.c_double, vp], i32),
        "psgd_ns_workspace_bytes": ([i32] * 4, i64),
        "psgd_ns_update": ([vp] * 9 + [i32, i32, i32, i32, f32, f32, f32, f32, vp],
                           i32),
        "psgd_ns_step_workspace_bytes": ([i32] * 4, i64),
        "psgd_ns_step": ([vp] * 9 + [i32, i32, i32, i32, f32, f32, f32, vp], i32),
        "psgd_procrustes_workspace_bytes": ([i32] * 4, i64),
        "psgd_procrustes": ([vp] * 4 + [i32, i32, i32, i32, f32, vp], i32),
        "psgd_bound_workspace_bytes": ([i32] * 4, i64),
        "psgd_norm_bound": ([vp] * 4 + [i32, i32, i32, i32, i32, ctypes.c_uint,
                                        vp], i32),
        "psgd_tiled_step": ([vp] * 5 + [i32, i32, i32, vp], i32),
        "psgd_tsub": ([vp, vp, vp, i32, i32, i32, i32, vp], i32),
        "psgd_smm_workspace_bytes": ([i32, i32, i32], i64),
        "psgd_tc_gemm_smem_bytes": ([], i32),
        "psgd_scaled_matmul_trace": ([vp] * 6 + [i32, i32, i32, vp], i32),
        "psgd_tiled_combine": ([vp] * 5 + [i32, i32, i32, vp], i32),
    }
    for name, (args, res) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def _check(err: int, what: str) -> None:
    if err >= _TENSOR_MAP_ERROR:
        raise RuntimeError(f"{what}: TMA tensor-map encoding failed, CUresult "
                           f"{err - _TENSOR_MAP_ERROR}")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _require(t: torch.Tensor, name: str, device, dtypes, shape=None) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                        f"{sorted(str(d) for d in dtypes)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _require_stack(x: torch.Tensor, name: str):
    """Check a (B, n, n) f32/bf16 CUDA stack; returns (device, B, n)."""
    if x.ndim != 3 or x.shape[1] != x.shape[2]:
        raise ValueError(f"{name} must be a (B, n, n) stack, not {tuple(x.shape)}")
    b, n = x.shape[0], x.shape[-1]
    _require(x, name, x.device, _DTYPE_CODE, (b, n, n))
    return x.device, b, n


def _require_tc_width(x: torch.Tensor, what: str) -> None:
    """The tensor-core GEMM (bf16) takes n % 8 == 0; refuse other widths."""
    n = x.shape[-1]
    if x.dtype == torch.bfloat16 and n % _TC_WIDTH_MULTIPLE:
        raise ValueError(f"{what} runs bf16 products on the tensor cores, which "
                         f"take widths that are multiples of {_TC_WIDTH_MULTIPLE} "
                         f"(TMA needs 16-byte rows); n = {n}")


def _require_scalars(dev, b, **named) -> None:
    """Check (B,) float32 per-batch scalars."""
    for name, t in named.items():
        _require(t, name, dev, (torch.float32,), (b,))


def _no_start(start) -> None:
    if start is not None:
        raise ValueError("pre-drawn starts are taken by the plain version "
                         "only; the kernel draws its own from seeds")


def _workspace(nbytes: int, dev) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


def _counted(fn):
    """Give a wrapper its launch counter."""
    fn.launches = 0
    return fn


def _counted_step_mat(fn):
    """Give a wrapper that takes a step matrix its launch counter and the
    count of its launches given one."""
    fn.step_mat_launches = 0
    return _counted(fn)


def _require_step_mat(step_mat, q, dev, b, n) -> None:
    """A step matrix S is a (B, n, n) stack in Q's dtype on Q's device."""
    if step_mat is not None:
        _require(step_mat, "step_mat", dev, (q.dtype,), (b, n, n))


def _ptr(t) -> int | None:
    """A tensor's device pointer, or null for None."""
    return None if t is None else t.data_ptr()


def key_seed_words(keys, device) -> torch.Tensor:
    """(B, 2) int32 device tensor of Philox seed words: the raw threefry key
    data (as ``key_seed_words`` in the JAX package), so a stream is keyed by
    the full 64-bit key; a complex noise's (B, 4) keys (``fastrand.noise_keys``)
    give (B, 4).  A CUDA copy goes through pinned memory without blocking,
    so the host never waits on the card."""
    words = np.asarray(keys, np.uint32)
    words = np.ascontiguousarray(words.reshape(-1, words.shape[-1]))
    t = torch.from_numpy(words.view(np.int32).copy())
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


# ---------------------------------------------------------------------------
# noise (replaces pallas_kernels.unit_noise / _noise_kernel)
# ---------------------------------------------------------------------------


def _eps(dtype: torch.dtype) -> float:
    return float(torch.finfo(dtype).eps)


def seed_width(dtype: torch.dtype) -> int:
    """Seed words per batch element of the noise: 4 for a complex dtype
    (the real and the imaginary part's streams), else 2."""
    return 4 if dtype.is_complex else 2


# each part of a complex noise element is a real unit draw times this
COMPLEX_PART = 2.0 ** -0.5


def unit_noise_plain(seeds: torch.Tensor, shape, dtype) -> torch.Tensor:
    """(B,)+shape uniform(-sqrt3, sqrt3) in ``dtype``; the kernel's bits.
    float64 widens the float32 draw.  A complex dtype (``seeds`` (B, 4)):
    the real part is the real draw in the part's dtype from ``seeds[:, :2]``,
    the imaginary part that from ``seeds[:, 2:]``, each times 2^-0.5 (one
    rounding): the composition of two real draws."""
    if dtype.is_complex:
        rd = real_dtype_of(dtype)
        part = torch.tensor(COMPLEX_PART, dtype=rd)
        return torch.complex(unit_noise_plain(seeds[:, :2], shape, rd) * part,
                             unit_noise_plain(seeds[:, 2:], shape, rd) * part)
    return unit_uniform(seeds, tuple(shape)).to(dtype)


def damped_noise_plain(g: torch.Tensor, seeds: torch.Tensor,
                       damping: float) -> torch.Tensor:
    """g + (damping + eps(dtype)|g|) v with v the unit noise in g's dtype,
    one rounding per operation, as the kernel: in float32 for f32 and bf16
    (v rounded to g's dtype first), in float64 for f64, and per part in
    the part's dtype for a complex g, |g| = hypot(re g, im g)."""
    rd = real_dtype_of(g.dtype)
    v = unit_noise_plain(seeds, g.shape[1:], g.dtype)
    if g.dtype.is_complex:
        d = (torch.tensor(damping, dtype=rd)
             + _eps(rd) * torch.hypot(g.real, g.imag))
        return torch.complex(g.real + d * v.real, g.imag + d * v.imag)
    cd = compute_dtype_of(g.dtype)
    gc = g.to(cd)
    d = torch.tensor(damping, dtype=cd) + _eps(g.dtype) * gc.abs()
    return (gc + d * v.to(cd)).to(g.dtype)


# the noise kernel indexes a batch element with 32-bit integers
MAX_NOISE_PER_BATCH = 2 ** 31 - 1


def _noise_launch(g, out, seeds, fused, damping, eps, scale=UNIT_SCALE):
    dev = out.device
    b = out.shape[0]
    per_batch = out.numel() // b if b else 0
    if per_batch > MAX_NOISE_PER_BATCH:
        raise ValueError(f"the noise kernel takes at most {MAX_NOISE_PER_BATCH} "
                         f"elements per batch element, not {per_batch}")
    with torch.cuda.device(dev):
        err = library().psgd_noise(
            g.data_ptr() if g is not None else None, out.data_ptr(),
            seeds.data_ptr(), b, per_batch, _NOISE_CODE[out.dtype], int(fused),
            scale, damping, eps, _stream(dev))
    _check(err, "psgd_noise")


def _counted_noise(fn):
    """A noise wrapper's launch counter and the count of its launches in
    the complex mode."""
    fn.complex_launches = 0
    return _counted(fn)


def _require_noise(dtype, seeds, b, dev) -> None:
    if dtype not in _NOISE_CODE:
        raise TypeError(f"the noise kernel takes "
                        f"{sorted(str(d) for d in _NOISE_CODE)}, not {dtype}")
    _require(seeds, "seeds", dev, (torch.int32,), (b, seed_width(dtype)))


def _count_noise(fn, dtype) -> None:
    fn.launches += 1
    fn.complex_launches += dtype.is_complex


@_counted_noise
def unit_noise(seeds: torch.Tensor, shape, dtype) -> torch.Tensor:
    """(B,)+shape white noise; element i's stream is a pure function of
    seeds[i] (two 32-bit words, four for a complex dtype: ``seed_width``).
    CUDA: one kernel launch (f32, bf16, f64, complex64, complex128)."""
    out_shape = (seeds.shape[0],) + tuple(shape)
    if seeds.device.type == "cpu":
        return unit_noise_plain(seeds, shape, dtype)
    _require_noise(dtype, seeds, seeds.shape[0], seeds.device)
    out = torch.empty(out_shape, dtype=dtype, device=seeds.device)
    _noise_launch(None, out, seeds, False, 0.0, 0.0)
    _count_noise(unit_noise, dtype)
    return out


@_counted_noise
def damped_noise(g: torch.Tensor, seeds: torch.Tensor,
                 damping: float) -> torch.Tensor:
    """g + (damping + eps(dtype)|g|) v for a stack g (B, ...), v white noise
    keyed per batch element by seeds (B, ``seed_width``).  CUDA: one launch,
    v made in registers (never written to memory)."""
    if g.device.type == "cpu":
        return damped_noise_plain(g, seeds, damping)
    _require(g, "g", g.device, _NOISE_CODE)
    _require_noise(g.dtype, seeds, g.shape[0], g.device)
    out = torch.empty_like(g)
    _noise_launch(g, out, seeds, True, float(damping), _eps(real_dtype_of(g.dtype)))
    _count_noise(damped_noise, g.dtype)
    return out


def _int32_words(words: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 as the int32 bit patterns."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


@_counted
def philox_start(seeds: torch.Tensor, shape) -> torch.Tensor:
    """(B,)+shape float32 uniform(-1, 1), ``philox.uniform_pm1``'s bits: the
    norm bounds' subspace starts of the XLA tail.  CUDA: one launch of the
    noise kernel in unit mode at scale 2 (where the plain version's Philox
    in integer operations is some 270 launches); counted in its own
    ``.launches``."""
    if seeds.device.type == "cpu":
        return uniform_pm1(seeds, tuple(shape))
    if seeds.dtype != torch.int32:
        seeds = _int32_words(seed_words_u32(seeds))
    _require(seeds, "seeds", seeds.device, (torch.int32,), (seeds.shape[0], 2))
    out = torch.empty((seeds.shape[0],) + tuple(shape), dtype=torch.float32,
                      device=seeds.device)
    _noise_launch(None, out, seeds, False, 0.0, 0.0, scale=2.0)
    philox_start.launches += 1
    return out


# ---------------------------------------------------------------------------
# NS update: routing
# ---------------------------------------------------------------------------


def ns_route(n: int, dtype: torch.dtype) -> str:
    """The NS route the JAX package takes for a factor of width n and
    ``dtype`` (``fused_ns_update`` :164-176 with ``ns_update_supported``):
    "xla" for float64, complex64 and complex128 (``XLA_DTYPES``), which the
    JAX package sends to its XLA tail; in f32 and bf16 "single" up to the
    first cap of ``NS_CAPS``, "split" up to the second, "tiled" up to the
    third.  Above the caps and for n not a multiple of 128 it is "single",
    whose plain version is exactly the XLA tail (``kron._ns_tail_stacked_xla``)
    the JAX package runs there.

    The routes are not only memory layouts: in bf16 they store q1 (split)
    or q1, R, RQ and RRQ (tiled) in Q's dtype where the single route keeps
    them in f32, so each width computes what the JAX package computes for
    it."""
    if dtype in XLA_DTYPES:
        return "xla"
    caps = NS_CAPS.get(dtype)
    if caps is None or n % 128 or not caps[0] < n <= caps[2]:
        return "single"
    return "split" if n <= caps[1] else "tiled"


def _tagged(seeds: torch.Tensor, tag: int = SKH_TAG) -> torch.Tensor:
    s = seed_words_u32(seeds)
    return torch.stack([s[:, 0], s[:, 1] ^ tag], dim=1)


def _lips_update(bound, lips, term2, lr, beta_l):
    """ell = bound + term2, L' = max(betaL L + (1 - betaL) ell, ell) in L's
    dtype, and coeff = lr / L'."""
    ell = (bound + term2).to(lips.dtype)
    lip = torch.maximum(beta_l * lips + (1.0 - beta_l) * ell, ell)
    return lip, lr / lip


def _step_plain(term1, q, lips, term2, seeds, lr, beta_l, k, start,
                step_mat=None):
    """ell, L' and q1 = q - lr/L' (S q - term2 q), S = step_mat or term1
    (ell from term1 either way), computed in ``compute_dtype_of(q.dtype)``
    (f32 for f32 and bf16 Q) and not yet stored."""
    cd = compute_dtype_of(q.dtype)
    rd = real_dtype_of(cd)
    n = q.shape[-1]
    t1, f, t2 = term1.to(cd), q.to(cd), term2.to(rd)
    s = t1 if step_mat is None else step_mat.to(cd)
    bound = norm_lower_bound_spd(t1, seeds, k=width_norm_k(k, n), v0=start)
    lip, coeff = _lips_update(bound, lips, t2, lr, beta_l)
    q1 = f - coeff.to(rd)[:, None, None] * (s @ f - t2[:, None, None] * f)
    return q1, lip


def _procrustes_plain(q1, seeds, max_step, k, start):
    return procrustes_step2(q1, max_step, norm_k=width_norm_k(k, q1.shape[-1]),
                            seeds=_tagged(seeds), v0=start)


# ---------------------------------------------------------------------------
# the XLA tail (float64, complex64, complex128)
# ---------------------------------------------------------------------------


@_counted_step_mat
def xla_ns_update(term1, q, lips, term2, seeds, lr, beta_l, max_step=1 / 8,
                  k=NORM_K, starts=None, step_mat=None):
    """The NS update as the JAX package's XLA tail computes it
    (``kron._ns_tail_stacked_xla``, batched): ``_single_plain`` in Q's
    dtype, PyTorch operations on any device (their products cuBLAS on the
    card); the route of ``XLA_DTYPES``, which refuses the others.  Its two
    starts are ``philox_start`` draws from ``seeds`` (the skew bound's from
    seeds ^ ``SKH_TAG``) unless ``starts`` gives them.  Counts its calls in
    ``.launches`` (and ``.step_mat_launches``)."""
    if q.dtype not in XLA_DTYPES:
        raise TypeError(f"the XLA tail takes {[str(d) for d in XLA_DTYPES]}; "
                        f"{q.dtype} runs the NS kernels")
    if starts is None:
        shape = (width_norm_k(k, q.shape[-1]), q.shape[-1])
        starts = (philox_start(seeds, shape), philox_start(_tagged(seeds), shape))
    out = _single_plain(term1, q, lips, term2, seeds, lr, beta_l, max_step, k,
                        starts, step_mat)
    xla_ns_update.launches += 1
    xla_ns_update.step_mat_launches += step_mat is not None
    return out


@_counted
def xla_procrustes(q1, seeds, max_step=1 / 8, k=NORM_K, start=None):
    """``procrustes`` as the JAX package's XLA computes it for the dtypes
    of the XLA tail (``XLA_DTYPES``, which refuses the others): one
    procrustes_step2 of each q1 (B, n, n) in Q's dtype, PyTorch operations
    on any device (R = Q^H - Q conjugates), its start a ``philox_start``
    draw from ``seeds`` ^ ``SKH_TAG`` unless ``start`` gives it.  The
    dense preconditioner's Q0.5EQ1.5 rotation of a complex or float64 Q.
    Counts its calls in ``.launches``."""
    if q1.dtype not in XLA_DTYPES:
        raise TypeError(f"the XLA Procrustes step takes "
                        f"{[str(d) for d in XLA_DTYPES]}; {q1.dtype} runs "
                        "``procrustes``")
    if start is None:
        start = philox_start(_tagged(seeds), (width_norm_k(k, q1.shape[-1]),
                                              q1.shape[-1]))
    out = _procrustes_plain(q1, seeds, max_step, k, start)
    xla_procrustes.launches += 1
    return out


# ---------------------------------------------------------------------------
# the single route (replaces pallas_kernels._ns_kernel)
# ---------------------------------------------------------------------------


def _single_plain(term1, q, lips, term2, seeds, lr, beta_l, max_step=1 / 8,
                  k=NORM_K, starts=None, step_mat=None):
    """The ``_ns_tail_stacked_xla`` math (psgd_torch_tpu/precond/kron.py),
    batched, in ``compute_dtype_of(q.dtype)`` (float32 for f32 and bf16 Q,
    Q's own dtype otherwise), q1 kept unrounded."""
    v_spd, v_skh = starts if starts is not None else (None, None)
    q1, lip = _step_plain(term1, q, lips, term2, seeds, lr, beta_l, k, v_spd,
                          step_mat)
    return _procrustes_plain(q1, seeds, max_step, k, v_skh).to(q.dtype), lip


def _single(term1, q, lips, term2, seeds, lr, beta_l, max_step=1 / 8, k=NORM_K,
            starts=None, step_mat=None):
    """The single route on CUDA: one chain of launches (counted as
    ``fused_ns_update.launches``, and ``.step_mat_launches`` given a step
    matrix).  In bf16 its products run on the tensor cores at n % 8 == 0
    and on the FFMA GEMM at other widths, by shape."""
    if q.device.type == "cpu":
        return _single_plain(term1, q, lips, term2, seeds, lr, beta_l, max_step,
                             k, starts, step_mat)
    _no_start(starts)
    dev, b, n = _require_stack(q, "q")
    _require(term1, "term1", dev, (q.dtype,), (b, n, n))
    _require_step_mat(step_mat, q, dev, b, n)
    _require_scalars(dev, b, lips=lips, term2=term2)
    _require(seeds, "seeds", dev, (torch.int32,), (b, 2))
    kk = width_norm_k(k, n)
    lib = library()
    ws = _workspace(lib.psgd_ns_workspace_bytes(b, n, kk, _DTYPE_CODE[q.dtype]), dev)
    q_out = torch.empty_like(q)
    lips_out = torch.empty_like(lips)
    with torch.cuda.device(dev):
        err = lib.psgd_ns_update(
            term1.data_ptr(), _ptr(step_mat), q.data_ptr(), lips.data_ptr(),
            term2.data_ptr(),
            seeds.data_ptr(), q_out.data_ptr(), lips_out.data_ptr(),
            ws.data_ptr(), b, n, kk, _DTYPE_CODE[q.dtype], float(lr),
            float(beta_l), 1.0 - float(beta_l), float(max_step), _stream(dev))
    _check(err, "psgd_ns_update")
    fused_ns_update.launches += 1
    fused_ns_update.step_mat_launches += step_mat is not None
    return q_out, lips_out


# ---------------------------------------------------------------------------
# the split route (replaces pallas_kernels._split_ns_update)
# ---------------------------------------------------------------------------


def ns_step_plain(term1, q, lips, term2, seeds, lr, beta_l, k=NORM_K,
                  start=None, step_mat=None):
    """Split stage 1: (q1 stored in Q's dtype, L')."""
    q1, lip = _step_plain(term1, q, lips, term2, seeds, lr, beta_l, k, start,
                          step_mat)
    return q1.to(q.dtype), lip


@_counted_step_mat
def ns_step(term1, q, lips, term2, seeds, lr, beta_l, k=NORM_K, start=None,
            step_mat=None):
    """Split stage 1 (replaces ``_ns_step_kernel``): the spd bound of term1,
    L' = max(betaL L + (1 - betaL) ell, ell) with ell = bound + term2, and
    q1 = q - lr/L' (S q - term2 q) stored in Q's dtype, S = ``step_mat``
    when given, else term1.

    term1, q, step_mat: (B, n, n); lips, term2: (B,) float32; seeds: (B, 2)
    int32.  Returns (q1 (B, n, n), L' (B,)).  CUDA: one chain of launches;
    in bf16 its products run on the tensor cores and n must be a multiple
    of 8."""
    if q.device.type == "cpu":
        return ns_step_plain(term1, q, lips, term2, seeds, lr, beta_l, k, start,
                             step_mat)
    _no_start(start)
    dev, b, n = _require_stack(q, "q")
    _require_tc_width(q, "ns_step")
    _require(term1, "term1", dev, (q.dtype,), (b, n, n))
    _require_step_mat(step_mat, q, dev, b, n)
    _require_scalars(dev, b, lips=lips, term2=term2)
    _require(seeds, "seeds", dev, (torch.int32,), (b, 2))
    kk = width_norm_k(k, n)
    lib = library()
    ws = _workspace(lib.psgd_ns_step_workspace_bytes(b, n, kk, _DTYPE_CODE[q.dtype]),
                    dev)
    q1 = torch.empty_like(q)
    lips_out = torch.empty_like(lips)
    with torch.cuda.device(dev):
        err = lib.psgd_ns_step(
            term1.data_ptr(), _ptr(step_mat), q.data_ptr(), lips.data_ptr(),
            term2.data_ptr(),
            seeds.data_ptr(), q1.data_ptr(), lips_out.data_ptr(), ws.data_ptr(),
            b, n, kk, _DTYPE_CODE[q.dtype], float(lr), float(beta_l),
            1.0 - float(beta_l), _stream(dev))
    _check(err, "psgd_ns_step")
    ns_step.launches += 1
    ns_step.step_mat_launches += step_mat is not None
    return q1, lips_out


def procrustes_plain(q1, seeds, max_step=1 / 8, k=NORM_K, start=None):
    """Split stage 2: procrustes_step2 of the stored q1, in f32 (f64)."""
    f = q1.to(compute_dtype_of(q1.dtype))
    return _procrustes_plain(f, seeds, max_step, k, start).to(q1.dtype)


@_counted
def procrustes(q1, seeds, max_step=1 / 8, k=NORM_K, start=None):
    """Split stage 2 (replaces ``_procrustes_kernel``): procrustes_step2 of
    q1 (B, n, n), its skew bound keyed by seed word 1 ^ 0x5BD1E995; R, RQ
    and RRQ in f32, q' in q1's dtype.  CUDA: one chain of launches; in bf16
    its products read bf16 copies of R and RQ on the tensor cores and n must
    be a multiple of 8."""
    if q1.device.type == "cpu":
        return procrustes_plain(q1, seeds, max_step, k, start)
    _no_start(start)
    dev, b, n = _require_stack(q1, "q1")
    _require_tc_width(q1, "procrustes")
    _require(seeds, "seeds", dev, (torch.int32,), (b, 2))
    kk = width_norm_k(k, n)
    lib = library()
    ws = _workspace(lib.psgd_procrustes_workspace_bytes(b, n, kk, _DTYPE_CODE[q1.dtype]),
                    dev)
    out = torch.empty_like(q1)
    with torch.cuda.device(dev):
        err = lib.psgd_procrustes(
            q1.data_ptr(), seeds.data_ptr(), out.data_ptr(), ws.data_ptr(), b,
            n, kk, _DTYPE_CODE[q1.dtype], float(max_step), _stream(dev))
    _check(err, "psgd_procrustes")
    procrustes.launches += 1
    return out


def _split_route(ops, term1, q, lips, term2, seeds, lr, beta_l, max_step, k,
                 starts, step_mat):
    v_spd, v_skh = starts if starts is not None else (None, None)
    q1, lip = ops.ns_step(term1, q, lips, term2, seeds, lr, beta_l, k, v_spd,
                          step_mat)
    return ops.procrustes(q1, seeds, max_step, k, v_skh), lip


# ---------------------------------------------------------------------------
# the tiled route (replaces pallas_kernels._tiled_ns_update)
# ---------------------------------------------------------------------------


def norm_bound_plain(mat, seeds, mode="spd", tag=0, k=NORM_K, start=None):
    """The bound on a matrix stack in its storage dtype
    (``linalg.norm_bound_stored``), start keyed by seed word 1 ^ tag."""
    return norm_bound_stored(mat, mode, seeds=_tagged(seeds, tag), k=k,
                             v0=start).to(lifted_real_dtype(mat.dtype))


@_counted
def norm_bound(mat, seeds, mode="spd", tag=0, k=NORM_K, start=None):
    """Spectral-norm lower bound of each matrix of ``mat`` (B, n, n) read in
    its storage dtype (replaces ``_tiled_bound_kernel``): normalizer max
    diagonal (``mode="spd"``) or max |a| (``"skh"``), the subspace start
    keyed by ``seeds`` (B, 2) with word 1 ^ ``tag``.  Returns (B,) float32.
    CUDA: one chain of launches; in bf16 its thin products run on the tensor
    cores at n % 8 == 0 and on the FFMA GEMM at other widths (its iterates
    rounded to bf16 as they are loaded, the plain version's sums), by
    shape, as the single route's."""
    if mat.device.type == "cpu":
        return norm_bound_plain(mat, seeds, mode, tag, k, start)
    _no_start(start)
    dev, b, n = _require_stack(mat, "mat")
    _require(seeds, "seeds", dev, (torch.int32,), (b, 2))
    kk = width_norm_k(k, n)
    lib = library()
    ws = _workspace(lib.psgd_bound_workspace_bytes(b, n, kk, _DTYPE_CODE[mat.dtype]),
                    dev)
    out = torch.empty(b, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.psgd_norm_bound(
            mat.data_ptr(), seeds.data_ptr(), out.data_ptr(), ws.data_ptr(), b,
            n, kk, _DTYPE_CODE[mat.dtype], _MODE_CODE[mode], tag, _stream(dev))
    _check(err, "psgd_norm_bound")
    norm_bound.launches += 1
    return out


def tiled_step_plain(step, q, coeff, term2, is_step_mat=False):
    """q - coeff (S q - term2 q), S = ``step``, products of the stored
    operands accumulated in f32 (f64), stored in Q's dtype."""
    cd = compute_dtype_of(q.dtype)
    f = q.to(cd)
    prod = step.to(cd) @ f
    c, t2 = coeff.to(cd)[:, None, None], term2.to(cd)[:, None, None]
    return (f - c * (prod - t2 * f)).to(q.dtype)


@_counted_step_mat
def tiled_step(step, q, coeff, term2, is_step_mat=False):
    """q1 = q - coeff (S q - term2 q) for stacks q, S = ``step`` (B, n, n)
    and per-batch coeff, term2 (B,) float32, stored in Q's dtype (replaces
    ``_tiled_step_kernel``; S is its ``step_in``).  S is term1, the matrix
    whose bound gave coeff, or a step matrix (``is_step_mat``, which only
    picks the counter).  CUDA: one GEMM launch (tensor cores in bf16, n a
    multiple of 8)."""
    if q.device.type == "cpu":
        return tiled_step_plain(step, q, coeff, term2, is_step_mat)
    dev, b, n = _require_stack(q, "q")
    _require(step, "step", dev, (q.dtype,), (b, n, n))
    _require_scalars(dev, b, coeff=coeff, term2=term2)
    _require_tc_width(q, "tiled_step")
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        err = library().psgd_tiled_step(
            step.data_ptr(), q.data_ptr(), coeff.data_ptr(), term2.data_ptr(),
            out.data_ptr(), b, n, _DTYPE_CODE[q.dtype], _stream(dev))
    _check(err, "psgd_tiled_step")
    tiled_step.launches += 1
    tiled_step.step_mat_launches += is_step_mat
    return out


def tsub_plain(x):
    """x^T - x: one subtraction in f32 (f64), one rounding to x's dtype."""
    return transpose_sub_plain(x, x.dtype)[0]


@_counted
def tsub(x):
    """R = x^T - x for a stack x (B, n, n), in x's dtype (replaces
    ``_tiled_tsub_kernel``).  CUDA: one launch."""
    if x.device.type == "cpu":
        return tsub_plain(x)
    dev, b, n = _require_stack(x, "x")
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        err = library().psgd_tsub(x.data_ptr(), out.data_ptr(), None, b, n,
                                  _DTYPE_CODE[x.dtype], _DTYPE_CODE[x.dtype],
                                  _stream(dev))
    _check(err, "psgd_tsub")
    tsub.launches += 1
    return out


# the transpose-subtract's (input, output) dtypes as the NS chains use it
TRANSPOSE_SUB_DTYPES = ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                        (torch.bfloat16, torch.bfloat16))


def transpose_sub_plain(x, out_dtype, copy16=False):
    """(x^T - x in f32 (f64) rounded once to ``out_dtype``, and with
    ``copy16`` the same difference rounded once to bf16, else None)."""
    d = x.mT.to(compute_dtype_of(x.dtype)) - x.to(compute_dtype_of(x.dtype))
    return d.to(out_dtype), d.to(torch.bfloat16) if copy16 else None


@_counted
def transpose_sub(x, out_dtype, copy16=False):
    """The transpose-subtract of the NS chains with its own output dtype and
    optional bf16 copy R16, as ``procrustes`` and the single route run it
    inside their chains (``psgd_tsub``); ``tsub`` is its (x's
    dtype, no copy) case.  Used by chip_smoke.py and the card's tests to
    hold every instantiation (``TRANSPOSE_SUB_DTYPES``) against
    ``transpose_sub_plain``.  Returns (R, R16 or None)."""
    if x.device.type == "cpu":
        return transpose_sub_plain(x, out_dtype, copy16)
    dev, b, n = _require_stack(x, "x")
    if (x.dtype, out_dtype) not in TRANSPOSE_SUB_DTYPES:
        raise TypeError(f"the transpose-subtract takes (input, output) dtypes "
                        f"{TRANSPOSE_SUB_DTYPES}, not {(x.dtype, out_dtype)}")
    r = torch.empty(x.shape, dtype=out_dtype, device=dev)
    r16 = torch.empty(x.shape, dtype=torch.bfloat16, device=dev) if copy16 else None
    with torch.cuda.device(dev):
        err = library().psgd_tsub(
            x.data_ptr(), r.data_ptr(), _ptr(r16), b, n, _DTYPE_CODE[x.dtype],
            _DTYPE_CODE[out_dtype], _stream(dev))
    _check(err, "psgd_tsub")
    transpose_sub.launches += 1
    return r, r16


def scaled_matmul_trace_plain(a, b, inv):
    """((a b) inv stored in a's dtype, its trace from the unrounded values)."""
    cd = compute_dtype_of(a.dtype)
    prod = (a.to(cd) @ b.to(cd)) * inv.to(cd)[:, None, None]
    trace = torch.diagonal(prod, dim1=-2, dim2=-1).sum(-1)
    return prod.to(a.dtype), trace.to(lifted_real_dtype(a.dtype))


@_counted
def scaled_matmul_trace(a, b, inv):
    """(a b) * inv for stacks a, b (B, n, n) and inv (B,) float32, stored in
    a's dtype, with its trace (B,) float32 summed from the f32 product
    before rounding (replaces ``_tiled_smm_kernel``).  CUDA: one GEMM launch
    (tensor cores in bf16, n a multiple of 8) and one fixed-order sum of the
    diagonal tiles' partials."""
    if a.device.type == "cpu":
        return scaled_matmul_trace_plain(a, b, inv)
    dev, bb, n = _require_stack(a, "a")
    _require(b, "b", dev, (a.dtype,), (bb, n, n))
    _require_scalars(dev, bb, inv=inv)
    _require_tc_width(a, "scaled_matmul_trace")
    lib = library()
    ws = _workspace(lib.psgd_smm_workspace_bytes(bb, n, _DTYPE_CODE[a.dtype]), dev)
    out = torch.empty_like(a)
    trace = torch.empty(bb, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.psgd_scaled_matmul_trace(
            a.data_ptr(), b.data_ptr(), inv.data_ptr(), out.data_ptr(),
            trace.data_ptr(), ws.data_ptr(), bb, n, _DTYPE_CODE[a.dtype],
            _stream(dev))
    _check(err, "psgd_scaled_matmul_trace")
    scaled_matmul_trace.launches += 1
    return out, trace


def combine_plain(q1, rq, rrq, a):
    """q1 + a rq + (a^2 / 2) rrq, left to right, one rounding per f32 (f64)
    operation, stored in q1's dtype."""
    cd = compute_dtype_of(q1.dtype)
    a = a.to(cd)
    c = ((0.5 * a) * a)[:, None, None]
    a = a[:, None, None]
    return (q1.to(cd) + a * rq.to(cd) + c * rrq.to(cd)).to(q1.dtype)


@_counted
def combine(q1, rq, rrq, a):
    """q' = q1 + a rq + (a^2 / 2) rrq for stacks (B, n, n) in one dtype and
    the step a (B,) float32 (replaces ``_tiled_combine_kernel``).  CUDA: one
    launch."""
    if q1.device.type == "cpu":
        return combine_plain(q1, rq, rrq, a)
    dev, b, n = _require_stack(q1, "q1")
    _require(rq, "rq", dev, (q1.dtype,), (b, n, n))
    _require(rrq, "rrq", dev, (q1.dtype,), (b, n, n))
    _require_scalars(dev, b, a=a)
    out = torch.empty_like(q1)
    with torch.cuda.device(dev):
        err = library().psgd_tiled_combine(
            q1.data_ptr(), rq.data_ptr(), rrq.data_ptr(), a.data_ptr(),
            out.data_ptr(), b, n, _DTYPE_CODE[q1.dtype], _stream(dev))
    _check(err, "psgd_tiled_combine")
    combine.launches += 1
    return out


def _tiled_route(ops, term1, q, lips, term2, seeds, lr, beta_l, max_step, k,
                 starts, step_mat):
    """The six steps of ``_tiled_ns_update``; the scalar glue between them
    is PyTorch on (B,) tensors on q's device (no host sync)."""
    v_spd, v_skh = starts if starts is not None else (None, None)
    bound = ops.norm_bound(term1, seeds, "spd", 0, k, v_spd)
    lip, coeff = _lips_update(bound, lips, term2, lr, beta_l)
    q1 = ops.tiled_step(term1 if step_mat is None else step_mat, q, coeff, term2,
                        step_mat is not None)
    r = ops.tsub(q1)
    rnorm = ops.norm_bound(r, seeds, "skh", SKH_TAG, k, v_skh)
    inv = 1.0 / (rnorm + torch.finfo(rnorm.dtype).tiny)
    rq, tr_rq = ops.scaled_matmul_trace(r, q1, inv)
    rrq, tr_rrq = ops.scaled_matmul_trace(r, rq, inv)
    return ops.combine(q1, rq, rrq, step_size(tr_rq, tr_rrq, max_step)), lip


def step_size(tr_rq, tr_rrq, max_step=1 / 8):
    """The procrustes step a = min(-tr RQ / tr RRQ, max_step) where
    tr RRQ < 0, else max_step; (B,) tensors on their device."""
    neg = tr_rrq < 0
    safe = torch.where(neg, tr_rrq, -torch.ones_like(tr_rrq))
    return torch.where(neg, torch.clamp(-tr_rq / safe, max=max_step),
                       torch.full_like(tr_rq, max_step))


# ---------------------------------------------------------------------------
# the NS update (replaces pallas_kernels.fused_ns_update)
# ---------------------------------------------------------------------------

_KERNELS = SimpleNamespace(ns_step=ns_step, procrustes=procrustes,
                           norm_bound=norm_bound, tiled_step=tiled_step,
                           tsub=tsub, scaled_matmul_trace=scaled_matmul_trace,
                           combine=combine)
_PLAIN = SimpleNamespace(ns_step=ns_step_plain, procrustes=procrustes_plain,
                         norm_bound=norm_bound_plain, tiled_step=tiled_step_plain,
                         tsub=tsub_plain,
                         scaled_matmul_trace=scaled_matmul_trace_plain,
                         combine=combine_plain)


def _dispatch(ops, single, term1, q, lips, term2, seeds, lr, beta_l, max_step,
              k, starts, route, step_mat):
    route = ns_route(q.shape[-1], q.dtype) if route is None else route
    args = (term1, q, lips, term2, seeds, lr, beta_l, max_step, k, starts,
            step_mat)
    if route == "xla":
        return xla_ns_update(*args)
    if route == "single":
        return single(*args)
    if route == "split":
        return _split_route(ops, *args)
    if route == "tiled":
        return _tiled_route(ops, *args)
    raise ValueError(f"unknown NS route {route!r}; routes are "
                     f"{NS_ROUTES + ('xla',)}")


def fused_ns_update_plain(term1, q, lips, term2, seeds, lr, beta_l,
                          max_step=1 / 8, k=NORM_K, starts=None, route=None,
                          step_mat=None):
    """The NS update's plain version: each route composed of its pieces'
    plain versions.

    ``starts`` = (spd start, skh start), pre-drawn (B, k', n) subspace
    starts with k' = width_norm_k(k, n); without them the starts are drawn
    from Philox keyed by ``seeds`` (and ``seeds`` ^ tag for the skew bound),
    the kernels' bits.  Returns (q' in q's dtype, L' in lips' dtype)."""
    return _dispatch(_PLAIN, _single_plain, term1, q, lips, term2, seeds, lr,
                     beta_l, max_step, k, starts, route, step_mat)


@_counted_step_mat
def fused_ns_update(term1, q, lips, term2, seeds, lr, beta_l,
                    max_step=1 / 8, k=NORM_K, starts=None, route=None,
                    step_mat=None):
    """Batched Q0.5EQ1.5 dense-factor update.

    term1, q: (B, n, n); lips, term2: (B,) float32; seeds: (B, 2) int32
    Philox seed words.  ``step_mat`` (B, n, n) in Q's dtype, when given, is
    the step's matrix S in q1 = q - lr/L' (S q - term2 q), while the bound
    and L' still read term1 (the Newton fit: term1 = A + B, S = A - B).
    Returns (new q (B, n, n) in q's dtype, new L (B,)).
    ``route`` picks "single", "split" or "tiled" explicitly; by default
    ``ns_route(n, q.dtype)``.  On CUDA every route is kernel launches with
    no host sync; ``starts`` (the plain versions' replay hook) is refused
    there.  ``fused_ns_update.launches`` counts the single route's chains
    (``.step_mat_launches`` those given a step matrix); the other routes
    count in their pieces' counters."""
    return _dispatch(_KERNELS, _single, term1, q, lips, term2, seeds, lr,
                     beta_l, max_step, k, starts, route, step_mat)


# ---------------------------------------------------------------------------
# how far a kernel may be from its plain version (chip_smoke.py and the
# card's tests read these)
# ---------------------------------------------------------------------------

# A route or a split stage, (q' Frobenius-relative, L' relative).  f32: the
# same arithmetic in another order.  bf16: the kernels round the bounds'
# thin operands to bf16 where the plain chains keep f32.
ROUTE_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 2e-2)}

# q' of the FFMA single route in bf16 against its plain version (Frobenius-
# relative) by (B, n), on chip_smoke.py's problems on an H100 80GB HBM3 at
# 700 W (PERF.md, Findings).  The tensor-core chain reads the same bf16
# operands, so at these shapes it may be at most twice as far.
FFMA_SINGLE_REL = {(12, 768): 3.02e-4, (1, 1024): 3.58e-4}

# norm_bound against its plain version summed in the kernel's own order
BOUND_RTOL = 1e-5


def norm_bound_rtol(mat, seeds, mode="spd", tag=0, k=NORM_K) -> float:
    """How far ``norm_bound`` may be from ``norm_bound_plain`` on these
    inputs, relative: ``BOUND_RTOL``, plus in bf16 (n % 8 == 0, the tensor
    cores) how far the plain version itself moves when its products are
    summed as the tensor cores sum them (``linalg.tensor_core_matmul``).
    The bound rounds its f32 iterate to bf16 before each product, so
    another summation order flips a few of those roundings, and one on the
    row of the largest norm moves the bound; the f32 bound and the FFMA
    GEMM sum in the plain version's order."""
    if mat.dtype != torch.bfloat16 or mat.shape[-1] % _TC_WIDTH_MULTIPLE:
        return BOUND_RTOL
    plain = norm_bound_plain(mat, seeds, mode, tag, k)
    ordered = norm_bound_stored(mat, mode, seeds=_tagged(seeds, tag), k=k,
                                tensor_core_sums=True)
    return BOUND_RTOL + ((ordered - plain).abs() / plain).max().item()


SPLIT_KERNELS = (ns_step, procrustes)
TILED_KERNELS = (norm_bound, tiled_step, tsub, scaled_matmul_trace, combine)
# the wrappers that take a step matrix (the TPU kernels' has_step_mat)
STEP_MAT_KERNELS = (fused_ns_update, ns_step, tiled_step)


def reset_launch_counts() -> None:
    for fn in (fused_ns_update, damped_noise, unit_noise, transpose_sub,
               xla_ns_update, xla_procrustes, philox_start, *SPLIT_KERNELS,
               *TILED_KERNELS):
        fn.launches = 0
    for fn in (*STEP_MAT_KERNELS, xla_ns_update):
        fn.step_mat_launches = 0
    for fn in (damped_noise, unit_noise):
        fn.complex_launches = 0
