"""Rules of the port: it imports no JAX, optax, opt_einsum or
psgd_torch_tpu module, its entry points refuse to fall back to the CPU
when no card is present, and its CUDA sources are its own kernels (no
library GEMM), built for sm_90a."""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = Path(ROOT) / "psgd_torch_tpu_torch" / "ops" / "csrc"
# a call into cuBLAS, a CUTLASS device-level GEMM, or an include of one
_LIBRARY_GEMM = re.compile(
    r"cublas|cutlass::gemm::device|#\s*include\s*[<\"]cutlass/gemm/(device|kernel)/",
    re.IGNORECASE)

_CHECK = textwrap.dedent("""
    import importlib, pkgutil, sys
    import numpy, torch                      # their own imports are theirs
    before = set(sys.modules)
    import psgd_torch_tpu_torch as pkg
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(m.name)
    import chip_smoke
    new = sorted(set(sys.modules) - before)
    bad = [m for m in new if m.split(".")[0] in
           ("jax", "jaxlib", "optax", "opt_einsum", "psgd_torch_tpu")]
    print("BAD", bad)
    print("N", len([m for m in new if m.startswith("psgd_torch_tpu_torch")]))
    print("HVP", "psgd_torch_tpu_torch.optim.hvp" in new)
    print("PAR", ",".join(m for m in new if m.startswith("psgd_torch_tpu_torch.parallel")))
""")


def test_port_imports_no_jax():
    """A fresh interpreter imports every module of the port (the
    distributed ``parallel`` modules included) and chip_smoke.py; none of
    them pulls in a forbidden module."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = dict(l.split(" ", 1) for l in out.stdout.strip().splitlines())
    assert lines["BAD"] == "[]", lines["BAD"]
    assert int(lines["N"]) >= 20
    assert lines["HVP"] == "True"
    assert {"psgd_torch_tpu_torch.parallel.mesh",
            "psgd_torch_tpu_torch.parallel.recipe",
            "psgd_torch_tpu_torch.parallel.sharded"} <= set(lines["PAR"].split(","))


def test_sources_name_no_forbidden_import():
    pkg = os.path.join(ROOT, "psgd_torch_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
             if f.endswith(".py")] + [os.path.join(ROOT, "chip_smoke.py")]
    for path in files:
        with open(path) as fh:
            for line in fh:
                s = line.strip()
                if s.startswith(("import ", "from ")):
                    mod = s.split()[1]
                    assert mod.split(".")[0] not in (
                        "jax", "optax", "opt_einsum", "psgd_torch_tpu"), \
                        (path, s)


def test_entry_points_refuse_the_cpu_without_being_asked():
    """Without a card and without device="cpu" every entry point raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from psgd_torch_tpu_torch import resolve_device
    from psgd_torch_tpu_torch.models import gpt2
    from psgd_torch_tpu_torch.optim import KronNewton, KronWhiten
    cfg = gpt2.tiny_config(n_layer=1, n_head=2, n_embd=32, block_size=8,
                           vocab_size=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt2.GPT2(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt2.synthetic_lm_batch(torch.Generator(), 1, 8, 64)
    model = gpt2.GPT2(cfg, device="cpu")
    for opt in (KronWhiten, KronNewton):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            opt(model.named_parameters())
        opt(model.named_parameters(), device="cpu")
    assert resolve_device("cpu") == torch.device("cpu")


def test_distributed_entry_points_refuse_the_cpu_without_being_asked():
    """make_mesh on its default CUDA device, and a factor-sharded
    KronWhiten or KronNewton, raise without a card unless the CPU is asked
    for (before any process group is touched)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from psgd_torch_tpu_torch.optim import KronNewton, KronWhiten
    from psgd_torch_tpu_torch.parallel import make_mesh
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(axis_names=("fsdp",))
    for opt in (KronWhiten, KronNewton):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            opt([("w", torch.zeros(4, 3))], factor_sharding=("mesh", {"w": ()}))


def test_sharded_training_entry_points_refuse_the_cpu_without_being_asked():
    """make_multihost_mesh, the sharded trainer and gather_checkpoint
    (checkpoints across world sizes) raise without a card unless the CPU
    is asked for (before any process group or file is touched)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from psgd_torch_tpu_torch.examples import train_gpt2_sharded
    from psgd_torch_tpu_torch.parallel import make_multihost_mesh
    from psgd_torch_tpu_torch.utils import gather_checkpoint
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_multihost_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_gpt2_sharded.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gather_checkpoint("/nonexistent/checkpoints")
    with pytest.raises(FileNotFoundError):
        gather_checkpoint("/nonexistent/checkpoints", device="cpu")


def test_lra_dense_entry_points_refuse_the_cpu_without_being_asked():
    """The LRA and dense optimizers, the closure classes and the LRA and
    dense state constructors raise without a card unless device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from psgd_torch_tpu_torch.ops import fastrand
    from psgd_torch_tpu_torch.optim import (DenseNewton, LRANewton,
                                            LRAWhiten, classes)
    from psgd_torch_tpu_torch.precond import dense, lra
    params = [torch.zeros(16, requires_grad=True)]
    for opt in (LRAWhiten, LRANewton, DenseNewton, classes.KronWhiten,
                classes.KronNewton, classes.LRAWhiten, classes.LRANewton,
                classes.DenseNewton):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            opt(params, preconditioner_init_scale=1.0)
        opt(params, preconditioner_init_scale=1.0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lra.init_lra(16, 2, fastrand.prng_key(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dense.init_dense(16)
    assert lra.init_lra(16, 2, fastrand.prng_key(0), device="cpu").u.shape == (16, 2)
    assert dense.init_dense(16, device="cpu").q.shape == (16, 16)


def test_utils_data_and_trainer_refuse_the_cpu_without_being_asked():
    """The trainer, the corpus batches and the step timer raise without a
    card unless the CPU is asked for; the utils, lm_data and the trainer
    import no JAX (test_port_imports_no_jax walks them too)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    import numpy as np
    from psgd_torch_tpu_torch.examples import train_gpt2
    from psgd_torch_tpu_torch.models import lm_data
    from psgd_torch_tpu_torch.utils import StepTimer
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_gpt2.main(["--steps", "1", "--data", "synthetic"])
    toks = np.arange(100, dtype=np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_data.corpus_batch(torch.Generator(), toks, 2, 8)
    assert lm_data.corpus_batch(torch.Generator(), toks, 2, 8,
                                device="cpu")[0].shape == (2, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StepTimer()
    assert StepTimer(device="cpu").device == torch.device("cpu")
    for sub in ("utils", "examples"):
        assert (Path(ROOT) / "psgd_torch_tpu_torch" / sub / "__init__.py").exists()


@pytest.mark.parametrize("name", sorted(p.name for p in CSRC.iterdir()))
def test_kernel_sources_call_no_library_gemm(name):
    """Every product on the port's kernel paths is its own device code."""
    text = (CSRC / name).read_text()
    assert not _LIBRARY_GEMM.search(text), _LIBRARY_GEMM.search(text).group(0)


def test_build_compiles_every_source_for_sm90a(monkeypatch, tmp_path):
    """build() runs one nvcc per source with
    -gencode arch=compute_90a,code=sm_90a (wgmma exists only for sm_90a)
    and the -Xptxas -v report, then links them (nvcc faked: no toolkit
    here)."""
    from psgd_torch_tpu_torch.ops import kernels
    calls = []

    class FakeCompile:
        returncode = 0

        def __init__(self, cmd, **_):
            calls.append(cmd)

        def communicate(self):
            return "ptxas info : Used 1 registers\n", None

    def fake_link(cmd, **_):
        calls.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).touch()
        return SimpleNamespace(returncode=0, stdout="")

    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels.subprocess, "Popen", FakeCompile)
    monkeypatch.setattr(kernels.subprocess, "run", fake_link)
    lib, report = kernels.build()
    compiles = [c for c in calls if "-c" in c]
    assert sorted(Path(c[c.index("-c") + 1]).name for c in compiles) == \
        sorted(p.name for p in CSRC.glob("*.cu"))
    for cmd in compiles:
        i = cmd.index("-gencode")
        assert cmd[i + 1] == "arch=compute_90a,code=sm_90a", cmd
        assert cmd[cmd.index("-Xptxas") + 1] == "-v", cmd
    assert lib.exists() and lib.parent == tmp_path and "Used 1 registers" in report
    calls.clear()
    assert kernels.build() == (lib, report) and not calls   # built: kept report


def _c_entry(source: str, name: str) -> str:
    """The body of the C entry point ``name`` in ``source``: from its
    definition to the next one."""
    text = (CSRC / source).read_text()
    start = text.index(f'extern "C" int {name}(')
    end = text.find('extern "C"', start + 1)
    return text[start:] if end < 0 else text[start:end]


def _function(source: str, signature: str) -> str:
    """The body of the function whose definition starts with ``signature``:
    from there to the first closing brace at the start of a line."""
    text = (CSRC / source).read_text()
    start = text.index(signature)
    return text[start:text.index("\n}", start)]


# each bf16 entry on the tensor cores: the call in its body that takes the
# GEMM, the width rule in its body (a refusal of n % 8 != 0, or a choice of
# GEMM by shape), and the wiring that call leads to
_REFUSES = "n % 8 != 0"
_TC_ENTRIES = {
    "psgd_ns_step": ("ns_update.cu", "ns_step_chain<bf16, bf16, TcGemm>", _REFUSES, ()),
    "psgd_scaled_matmul_trace": ("ns_tiled.cu", "tc_gemm<kMulTrace, bf16>", _REFUSES, ()),
    "psgd_tiled_step": ("ns_tiled.cu", "tc_gemm<kStep, bf16>", _REFUSES, ()),
    "psgd_procrustes": ("ns_update.cu", "procrustes_chain<bf16, bf16, TcGemm>", _REFUSES, (
        ("ns_update.cu", "void procrustes_chain(", "Gemm::div_trace("),
        ("ns_update.cu", "void procrustes_chain(", "norm_bound<float, Gemm, false>"),
        ("ns_gemm_sm90.cuh", "struct TcGemm {", "tc_gemm<kDivTrace, float>"))),
    # the single route: odd bf16 widths take the FFMA chain, by shape
    "psgd_ns_update": ("ns_update.cu", "ns_update<bf16, TcGemm>",
                       "on_tensor_cores(n, dtype)", (
        ("ns_update.cu", "bool on_tensor_cores(", "n % 8 == 0"),
        ("ns_update.cu", "int psgd_ns_update(", "ns_update<bf16, FfmaGemm<true>>"),
        ("ns_update.cu", "void ns_update(", "ns_step_chain<T, float, Gemm>"),
        ("ns_update.cu", "void ns_update(", "procrustes_chain<T, float, Gemm>"),
        ("ns_update.cu", "void procrustes_chain(", "Gemm::operand(q1, q1_16)"),
        ("ns_gemm_sm90.cuh", "struct TcGemm {", "tc_gemm<kStep, TQ1>(s, q, q1, q1_16"))),
    # the tiled bound: the stored bf16 matrix is its own product operand;
    # odd bf16 widths take the FFMA GEMM, by shape
    "psgd_norm_bound": ("ns_tiled.cu", "bound<bf16, TcGemm>", "n % 8 == 0", (
        ("ns_tiled.cu", "int psgd_norm_bound(", "bound<bf16, FfmaGemm<true>>"),
        ("ns_tiled.cu", "void bound(", "norm_bound<T, Gemm, true>(mat, mat,"),
        ("ns_tiled.cu", "long long carve_bound_only(", "carve_bound(c, B, n, k, dtype != 0)"))),
}


@pytest.mark.parametrize("entry", sorted(_TC_ENTRIES))
def test_tensor_core_gemm_feeds_its_two_entries(entry):
    """The wgmma + TMA GEMM is in ns_gemm_sm90.cuh and is what each bf16
    entry on the tensor cores launches: the single route (its step product
    writing q1's bf16 copy, which procrustes reads; the FFMA chain only at
    bf16 widths n % 8 != 0), psgd_ns_step, psgd_procrustes (its two full
    products through the kDivTrace epilogue, its bound's thin products),
    psgd_norm_bound (on the stored bf16 matrix; the FFMA chain only at bf16
    widths n % 8 != 0), psgd_tiled_step and psgd_scaled_matmul_trace."""
    gemm = (CSRC / "ns_gemm_sm90.cuh").read_text()
    for instr in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier.try_wait",
                  "cuTensorMapEncodeTiled"):
        assert instr in gemm, instr
    source, call, width_rule, wiring = _TC_ENTRIES[entry]
    assert '#include "ns_gemm_sm90.cuh"' in (CSRC / source).read_text()
    body = _c_entry(source, entry)
    assert call in body and "tc_status()" in body and width_rule in body, entry
    for src, signature, snippet in wiring:
        assert snippet in _function(src, signature), (signature, snippet)


@pytest.mark.parametrize("entry", ["psgd_ns_update", "psgd_ns_step"])
def test_step_matrix_feeds_the_step_product(entry):
    """The TPU kernels' has_step_mat variant: each NS entry takes a nullable
    step matrix S that the step product reads (null: term1), while the spd
    bound, and so L', still reads term1; both GEMM policies take S as the
    step's A operand.  The tiled route's step already takes its matrix as
    an operand."""
    body = _c_entry("ns_update.cu", entry)
    assert f'int {entry}(const void* term1, const void* step_mat,' in body
    assert "const void* s = step_mat ? step_mat : term1;" in body
    chain = _function("ns_update.cu", "void ns_step_chain(")
    assert "norm_bound<T, Gemm, false>(term1, term1," in chain
    assert "Gemm::step(s, q," in chain
    for src, policy in (("ns_gemm_sm90.cuh", "struct TcGemm {"),
                        ("ns_common.cuh", "struct FfmaGemm {")):
        assert "static void step(const T* s, const T* q," in _function(src, policy)
