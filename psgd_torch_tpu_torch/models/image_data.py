"""Real image data without a download.

Counterpart of psgd_torch_tpu/models/image_data.py.  The reference's image
benchmarks use MNIST and CIFAR-10, which need downloads; the UCI
handwritten-digits set that scikit-learn ships in its own package data
(1,797 real 8 x 8 grayscale digits, ``load_digits``) needs none.  It is
labelled as digits, not MNIST, wherever it is used.  scikit-learn is
imported only by ``load_digits_split``, so a host without it can use the
rest (and the examples fall back to ``lenet5.synthetic_mnist``).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device


def load_digits_split(test_frac: float = 0.2, seed: int = 0
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(train_x, train_y, test_x, test_y): the 8 x 8 digits scaled to
    [0, 1] (float32), shuffled by ``np.random.RandomState(seed)`` and
    split.  Raises ImportError without scikit-learn."""
    from sklearn.datasets import load_digits
    d = load_digits()
    x = (d.images / 16.0).astype(np.float32)
    y = d.target.astype(np.int32)
    order = np.random.RandomState(seed).permutation(len(x))
    x, y = x[order], y[order]
    n_test = int(len(x) * test_frac)
    return x[n_test:], y[n_test:], x[:n_test], y[:n_test]


def digits_resized(x: np.ndarray, size: int, channels: int = 1) -> torch.Tensor:
    """8 x 8 digits (N, 8, 8) bilinearly upscaled to (N, channels, size,
    size): 32 x 32 x 1 for LeNet5 (half-pixel centres, edges clamped, as
    ``jax.image.resize`` upsamples)."""
    t = F.interpolate(torch.from_numpy(np.asarray(x))[:, None], size=(size, size),
                      mode="bilinear", align_corners=False)
    return t.repeat(1, channels, 1, 1)


def batches(generator: torch.Generator, x: torch.Tensor, y: torch.Tensor,
            batch: int, steps: int, device=None) -> Iterator:
    """``steps`` batches of ``batch`` samples drawn with replacement from
    (x, y) by ``generator`` (on the CPU), on ``device``."""
    dev = resolve_device(device)
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    for _ in range(steps):
        idx = torch.randint(0, len(x), (batch,), generator=generator)
        yield x[idx].to(dev), y[idx].to(dev)
