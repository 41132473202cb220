"""Rules of the port: it imports no JAX, optax, opt_einsum or
psgd_torch_tpu module, and its entry points refuse to fall back to the CPU
when no card is present."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
""")


def test_port_imports_no_jax():
    """A fresh interpreter imports every module of the port and
    chip_smoke.py; none of them pulls in a forbidden module."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = dict(l.split(" ", 1) for l in out.stdout.strip().splitlines())
    assert lines["BAD"] == "[]", lines["BAD"]
    assert int(lines["N"]) >= 10


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
    from psgd_torch_tpu_torch.optim import KronWhiten
    cfg = gpt2.tiny_config(n_layer=1, n_head=2, n_embd=32, block_size=8,
                           vocab_size=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt2.GPT2(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt2.synthetic_lm_batch(torch.Generator(), 1, 8, 64)
    model = gpt2.GPT2(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KronWhiten(model.named_parameters())
    assert resolve_device("cpu") == torch.device("cpu")
    KronWhiten(model.named_parameters(), device="cpu")
