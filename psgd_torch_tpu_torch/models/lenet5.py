"""LeNet5 (the reference's MNIST demo model, mnist_with_lenet5.py:23-40),
functional PyTorch.

Counterpart of psgd_torch_tpu/models/lenet5.py.  As the reference demo,
each layer is one "affine" matrix [W; b], so one preconditioner covers the
weight and the bias: conv kernels flattened to (fan_in, fan_out), the
fan-in ordered (c_in, k_h, k_w) as the JAX model's.  The JAX model reads
NHWC images and HWIO kernels; here the images are NCHW and a conv's
[W; b] matrix becomes an OIHW kernel by one permutation, so the same
matrices give the same logits (``params_from_jax``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device

# (fan_in, fan_out) of the five [W; b] matrices (bias row excluded)
LAYERS = ((1 * 5 * 5, 6), (6 * 5 * 5, 16), (16 * 5 * 5, 120), (120, 84),
          (84, 10))


def init_lenet5(generator: torch.Generator | None = None, dtype=torch.float32,
                device=None) -> list:
    """The five [W; b] parameters: W standard normal times fan_in^-1/2
    (drawn in float32 from ``generator`` on the CPU), b zero; on the card
    unless ``device`` names another device."""
    dev = resolve_device(device)
    out = []
    for fan_in, fan_out in LAYERS:
        w = torch.randn((fan_in, fan_out), generator=generator) * fan_in ** -0.5
        wb = torch.cat([w, torch.zeros((1, fan_out))]).to(dtype)
        out.append(wb.to(dev).requires_grad_())
    return out


def params_from_jax(params) -> list:
    """The JAX model's list of [W; b] arrays (numpy) as tensors."""
    return [torch.from_numpy(np.array(p)) for p in params]


def _conv(x, wb, k: int, cin: int, cout: int):
    """A VALID conv by the [W; b] matrix: W read as (c_in, k, k, c_out),
    permuted to OIHW."""
    w = wb[:-1].reshape(cin, k, k, cout).permute(3, 0, 1, 2)
    return F.conv2d(x, w.to(x.dtype), wb[-1].to(x.dtype))


def apply_lenet5(params: list, images: torch.Tensor) -> torch.Tensor:
    """images (B, 1, 32, 32) (the classic 32 x 32 input; MNIST's 28 x 28
    padded by 2) -> logits (B, 10)."""
    x = F.max_pool2d(F.relu(_conv(images, params[0], 5, 1, 6)), 2)
    x = F.max_pool2d(F.relu(_conv(x, params[1], 5, 6, 16)), 2)
    # 32 -conv5-> 28 -pool-> 14 -conv5-> 10 -pool-> 5; flatten channel-major
    x = x.reshape(x.shape[0], -1)
    for i, wb in enumerate(params[2:]):
        x = x @ wb[:-1].to(x.dtype) + wb[-1].to(x.dtype)
        if i < 2:
            x = F.relu(x)
    return x


def loss_lenet5(params: list, images: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy, the log-softmax in float32 as the JAX model's."""
    logp = F.log_softmax(apply_lenet5(params, images).to(torch.float32), dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels[:, None]))


def synthetic_mnist(generator: torch.Generator, n: int, num_classes: int = 10,
                    image_size: int = 32, device=None):
    """Learnable synthetic image classes (no dataset download), as the JAX
    ``synthetic_mnist``: each class a fixed low-frequency template (8 x 8
    normals from a generator seeded 1234, upsampled), a sample its
    template plus 0.5 standard normal noise.  Drawn on the CPU from
    ``generator``: (images (n, 1, size, size) float32, labels (n,) int64)
    on ``device``."""
    dev = resolve_device(device)
    coarse = torch.randn((num_classes, 1, 8, 8),
                         generator=torch.Generator().manual_seed(1234))
    rep = image_size // 8
    templates = coarse.repeat_interleave(rep, dim=2).repeat_interleave(rep, dim=3)
    labels = torch.randint(0, num_classes, (n,), generator=generator)
    noise = 0.5 * torch.randn((n, 1, image_size, image_size), generator=generator)
    return (templates[labels] + noise).to(dev), labels.to(dev)
