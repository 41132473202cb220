"""The hand-written Hopper kernels of the PSGD hot path, their plain PyTorch
versions, and the build that makes them.

Counterpart of psgd_torch_tpu/ops/pallas_kernels.py.  Two kernels carry the
Kron whitening main path:

* ``fused_ns_update`` (csrc/ns_update.cu) -- the whole Q0.5EQ1.5 dense-factor
  update (spd norm bound, L and lr/L, the q1 step, the Procrustes rotation),
  batched over a layer stack.  Replaces ``fused_ns_update``/``_ns_kernel``.
* ``damped_noise`` and ``unit_noise`` (csrc/noise.cu) -- per-batch-seeded
  Philox4x32-10 uniform(-sqrt3, sqrt3) noise, alone or fused into the
  whitening damping g + (damping + eps|g|) v.  Replaces
  ``unit_noise``/``_noise_kernel`` and the damping around it.

Dispatch: a wrapper takes its plain version only for tensors on the CPU.
For a CUDA tensor it launches the kernel or raises; nothing falls back.
Each wrapper counts its launches in a plain integer attribute
(``fused_ns_update.launches`` and so on).

Build: at first use, nvcc compiles every ``csrc/*.cu`` for sm_90a (one
process per source, all started together) and links them into one shared
library with a plain C interface under ``build/kernels/`` at the repository
root, named by a hash of the sources; ctypes binds it.  Every C entry point
launches on PyTorch's current stream, allocates nothing, does not
synchronize, and returns ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from .linalg import norm_lower_bound_spd, procrustes_step2, width_norm_k
from .philox import UNIT_SCALE, seed_words_u32, unit_uniform

NORM_K = 32
SKH_TAG = 0x5BD1E995  # xored into seed word 1 for the skew bound's stream

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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
    these sources).  Returns (library path, nvcc's -Xptxas -v report; empty
    when the library was already there)."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        digest.update(f.name.encode() + f.read_bytes())
    lib = BUILD_DIR / f"libpsgd_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
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
    os.replace(tmp, lib)
    return lib, "".join(report)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The bound kernel library (built on first call)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    vp, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.psgd_noise.argtypes = [vp, vp, vp, i32, i64, i32, i32, f32, f32, f32, vp]
    lib.psgd_noise.restype = i32
    lib.psgd_ns_workspace_bytes.argtypes = [i32, i32, i32]
    lib.psgd_ns_workspace_bytes.restype = i64
    lib.psgd_ns_update.argtypes = [vp] * 8 + [i32, i32, i32, i32, f32, f32, f32,
                                              f32, vp]
    lib.psgd_ns_update.restype = i32
    return lib


def _check(err: int, what: str) -> None:
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


def key_seed_words(keys, device) -> torch.Tensor:
    """(B, 2) int32 device tensor of Philox seed words: the raw threefry key
    data (as ``key_seed_words`` in the JAX package), so a stream is keyed by
    the full 64-bit key.  A CUDA copy goes through pinned memory without
    blocking, so the host never waits on the card."""
    words = np.ascontiguousarray(np.asarray(keys, np.uint32).reshape(-1, 2))
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


def unit_noise_plain(seeds: torch.Tensor, shape, dtype) -> torch.Tensor:
    """(B,)+shape uniform(-sqrt3, sqrt3) in ``dtype``; the kernel's bits."""
    return unit_uniform(seeds, tuple(shape)).to(dtype)


def damped_noise_plain(g: torch.Tensor, seeds: torch.Tensor,
                       damping: float) -> torch.Tensor:
    """g + (damping + eps(dtype)|g|) v with v the unit noise in g's dtype,
    computed in float32 with one rounding per operation, as the kernel."""
    v = unit_noise_plain(seeds, g.shape[1:], g.dtype).float()
    g32 = g.float()
    d = torch.tensor(damping, dtype=torch.float32) + _eps(g.dtype) * g32.abs()
    return (g32 + d * v).to(g.dtype)


def _noise_launch(g, out, seeds, fused, damping, eps):
    dev = out.device
    b = out.shape[0]
    per_batch = out.numel() // b if b else 0
    with torch.cuda.device(dev):
        err = library().psgd_noise(
            g.data_ptr() if g is not None else None, out.data_ptr(),
            seeds.data_ptr(), b, per_batch, _DTYPE_CODE[out.dtype], int(fused),
            UNIT_SCALE, damping, eps, _stream(dev))
    _check(err, "psgd_noise")


def unit_noise(seeds: torch.Tensor, shape, dtype) -> torch.Tensor:
    """(B,)+shape white noise; element i's stream is a pure function of
    seeds[i] (two 32-bit words).  CUDA: one kernel launch."""
    out_shape = (seeds.shape[0],) + tuple(shape)
    if seeds.device.type == "cpu":
        return unit_noise_plain(seeds, shape, dtype)
    _require(seeds, "seeds", seeds.device, (torch.int32,), (seeds.shape[0], 2))
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"the noise kernel takes float32/bfloat16, not {dtype}")
    out = torch.empty(out_shape, dtype=dtype, device=seeds.device)
    _noise_launch(None, out, seeds, False, 0.0, 0.0)
    unit_noise.launches += 1
    return out


unit_noise.launches = 0


def damped_noise(g: torch.Tensor, seeds: torch.Tensor,
                 damping: float) -> torch.Tensor:
    """g + (damping + eps(dtype)|g|) v for a stack g (B, ...), v white noise
    keyed per batch element by seeds (B, 2).  CUDA: one launch, v made in
    registers (never written to memory)."""
    if g.device.type == "cpu":
        return damped_noise_plain(g, seeds, damping)
    _require(g, "g", g.device, _DTYPE_CODE)
    _require(seeds, "seeds", g.device, (torch.int32,), (g.shape[0], 2))
    out = torch.empty_like(g)
    _noise_launch(g, out, seeds, True, float(damping), _eps(g.dtype))
    damped_noise.launches += 1
    return out


damped_noise.launches = 0


# ---------------------------------------------------------------------------
# NS update (replaces pallas_kernels.fused_ns_update / _ns_kernel)
# ---------------------------------------------------------------------------


def _tagged(seeds: torch.Tensor) -> torch.Tensor:
    s = seed_words_u32(seeds)
    return torch.stack([s[:, 0], s[:, 1] ^ SKH_TAG], dim=1)


def fused_ns_update_plain(term1, q, lips, term2, seeds, lr, beta_l,
                          max_step=1 / 8, k=NORM_K, starts=None):
    """The ``_ns_tail_stacked_xla`` math (psgd_torch_tpu/precond/kron.py),
    batched, in float64 for f64 Q and float32 otherwise.

    ``starts`` = (spd start, skh start), pre-drawn (B, k', n) subspace
    starts with k' = width_norm_k(k, n); without them the starts are drawn
    from Philox keyed by ``seeds`` (and ``seeds`` ^ tag for the skew bound),
    the kernel's bits.  Returns (q' in q's dtype, L' in lips' dtype)."""
    cd = torch.float64 if q.dtype == torch.float64 else torch.float32
    n = q.shape[-1]
    k = width_norm_k(k, n)
    t1, f = term1.to(cd), q.to(cd)
    t2 = term2.to(cd)
    v_spd, v_skh = starts if starts is not None else (None, None)
    ell = norm_lower_bound_spd(t1, seeds, k=k, v0=v_spd) + t2
    ell = ell.to(lips.dtype)
    lip = torch.maximum(beta_l * lips + (1.0 - beta_l) * ell, ell)
    coeff = (lr / lip).to(cd)[:, None, None]
    fq = f - coeff * (t1 @ f - t2[:, None, None] * f)
    fq = procrustes_step2(fq, max_step, norm_k=k, seeds=_tagged(seeds),
                          v0=v_skh)
    return fq.to(q.dtype), lip


def fused_ns_update(term1, q, lips, term2, seeds, lr, beta_l,
                    max_step=1 / 8, k=NORM_K, starts=None):
    """Batched Q0.5EQ1.5 dense-factor update.

    term1, q: (B, n, n); lips, term2: (B,) float32; seeds: (B, 2) int32
    Philox seed words.  Returns (new q (B, n, n) in q's dtype, new L (B,)).
    On CUDA: one chain of kernel launches, no host sync; ``starts`` (the
    plain version's replay hook) is refused there."""
    if q.device.type == "cpu":
        return fused_ns_update_plain(term1, q, lips, term2, seeds, lr, beta_l,
                                     max_step, k, starts)
    if starts is not None:
        raise ValueError("pre-drawn starts are taken by the plain version "
                         "only; the kernel draws its own from seeds")
    dev = q.device
    b, n = q.shape[0], q.shape[-1]
    _require(q, "q", dev, _DTYPE_CODE, (b, n, n))
    _require(term1, "term1", dev, (q.dtype,), (b, n, n))
    _require(lips, "lips", dev, (torch.float32,), (b,))
    _require(term2, "term2", dev, (torch.float32,), (b,))
    _require(seeds, "seeds", dev, (torch.int32,), (b, 2))
    kk = width_norm_k(k, n)
    lib = library()
    ws = torch.empty(lib.psgd_ns_workspace_bytes(b, n, kk), dtype=torch.uint8,
                     device=dev)
    q_out = torch.empty_like(q)
    lips_out = torch.empty_like(lips)
    with torch.cuda.device(dev):
        err = lib.psgd_ns_update(
            term1.data_ptr(), q.data_ptr(), lips.data_ptr(), term2.data_ptr(),
            seeds.data_ptr(), q_out.data_ptr(), lips_out.data_ptr(),
            ws.data_ptr(), b, n, kk, _DTYPE_CODE[q.dtype], float(lr),
            float(beta_l), 1.0 - float(beta_l), float(max_step), _stream(dev))
    _check(err, "psgd_ns_update")
    fused_ns_update.launches += 1
    return q_out, lips_out


fused_ns_update.launches = 0


def reset_launch_counts() -> None:
    for fn in (fused_ns_update, damped_noise, unit_noise):
        fn.launches = 0
