"""PyTorch/CUDA port of psgd_torch_tpu (PSGD on NVIDIA Hopper).

The package mirrors the JAX package's layout (``ops``, ``precond``,
``optim``, ``models``, ``parallel``: the distributed layer on
``torch.distributed``).  It imports torch, numpy and the standard library
only.  Its preconditioners are the three families of the reference:
Kronecker-factored (``precond.kron``), low-rank approximation
(``precond.lra``) and dense (``precond.dense``), fitted by whitening or
from Hessian-vector products.  Entry points (``models.gpt2.GPT2``,
``models.llama.Llama``, ``models.vit.ViT``, the optimizers ``optim.KronWhiten``,
``KronNewton``, ``LRAWhiten``, ``LRANewton``, ``DenseNewton`` and the
reference-named closure classes of ``optim.classes``,
``models.gpt2.synthetic_lm_batch``, ``models.vit.synthetic_cifar``, the
examples' ``main``) run on the CUDA device unless the
caller passes ``device="cpu"``; without a card they raise instead of
falling back.  On CUDA tensors the hot-path kernels (``ops.kernels``: the
Newton-Schulz update's three routes and their pieces, the norm bound, the
Procrustes rotation and the noise) are hand-written CUDA C++ for sm_90a,
built with nvcc at first use.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another one.  Raises when CUDA is asked for (or defaulted to) and no
    card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
