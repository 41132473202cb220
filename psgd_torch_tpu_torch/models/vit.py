"""A small Vision Transformer in PyTorch, in the JAX package's layout.

Counterpart of psgd_torch_tpu/models/vit.py (the reference's CIFAR-10
benchmark model: dim 256, depth 4, 8 heads, 4 x 4 patches).  As the
port's GPT-2: the blocks' parameters stacked along a leading layer axis
(``blocks.<name>``), float32 parameters cast to ``compute_dtype`` at each
use, LayerNorm in float32 (``gpt2._layer_norm``), tanh-approximate GELU.
Attention is non-causal over a cls token and the patches; the head reads
the cls row.  Images are NHWC (B, H, W, 3), as the JAX model takes them,
so the same numpy images feed both.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from .gpt2 import _layer_norm, params_from_jax  # noqa: F401 (the same layout)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 32
    patch_size: int = 4
    num_classes: int = 10
    dim: int = 256
    depth: int = 4
    heads: int = 8
    mlp_ratio: int = 4
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return 3 * self.patch_size ** 2


class ViT(nn.Module):
    """Pre-LN ViT with stacked block parameters.

    Initialization as JAX ``init_vit``: the block weights normal(0, 0.02),
    the patch embedding normal(0, patch_dim^-1/2), the position table
    normal(0, 0.02), zero biases, cls token and head, unit LayerNorm
    scales; drawn from a ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, cfg: ViTConfig, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        d, l, m = cfg.dim, cfg.depth, cfg.mlp_ratio * cfg.dim
        gen = torch.Generator(device=dev).manual_seed(seed)
        pd = cfg.param_dtype

        def normal(shape, s=0.02):
            t = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
            return nn.Parameter((s * t).to(pd))

        def const(shape, v):
            return nn.Parameter(torch.full(shape, v, dtype=pd, device=dev))

        # the normal draws in the JAX key order: the four block weights,
        # then the patch embedding and the position table
        self.blocks = nn.ParameterDict({
            "ln1_scale": const((l, d), 1.0),
            "ln1_bias": const((l, d), 0.0),
            "attn_qkv_w": normal((l, d, 3 * d)),
            "attn_qkv_b": const((l, 3 * d), 0.0),
            "attn_proj_w": normal((l, d, d)),
            "attn_proj_b": const((l, d), 0.0),
            "ln2_scale": const((l, d), 1.0),
            "ln2_bias": const((l, d), 0.0),
            "mlp_fc_w": normal((l, d, m)),
            "mlp_fc_b": const((l, m), 0.0),
            "mlp_proj_w": normal((l, m, d)),
            "mlp_proj_b": const((l, d), 0.0),
        })
        self.patch_w = normal((cfg.patch_dim, d), cfg.patch_dim ** -0.5)
        self.patch_b = const((d,), 0.0)
        self.pos_emb = normal((cfg.num_patches + 1, d))
        self.cls = const((d,), 0.0)
        self.lnf_scale = const((d,), 1.0)
        self.lnf_bias = const((d,), 0.0)
        self.head_w = const((d, cfg.num_classes), 0.0)
        self.head_b = const((cfg.num_classes,), 0.0)

    def _block(self, x, bp):
        cfg = self.cfg
        b, t, d = x.shape
        h, cd = cfg.heads, cfg.compute_dtype
        y = _layer_norm(x, bp["ln1_scale"], bp["ln1_bias"])
        qkv = y @ bp["attn_qkv_w"].to(cd) + bp["attn_qkv_b"].to(cd)
        q, k, v = (z.reshape(b, t, h, d // h).transpose(1, 2)
                   for z in qkv.split(d, dim=-1))
        att = F.scaled_dot_product_attention(q, k, v)
        att = att.transpose(1, 2).reshape(b, t, d)
        x = x + att @ bp["attn_proj_w"].to(cd) + bp["attn_proj_b"].to(cd)
        y = _layer_norm(x, bp["ln2_scale"], bp["ln2_bias"])
        y = F.gelu(y @ bp["mlp_fc_w"].to(cd) + bp["mlp_fc_b"].to(cd),
                   approximate="tanh")
        return x + y @ bp["mlp_proj_w"].to(cd) + bp["mlp_proj_b"].to(cd)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) images -> (B, num_classes) float32 logits."""
        cfg = self.cfg
        cd = cfg.compute_dtype
        x = _patchify(images.to(cd), cfg.patch_size)
        x = x @ self.patch_w.to(cd) + self.patch_b.to(cd)
        cls = self.cls.to(cd).expand(x.shape[0], 1, cfg.dim)
        x = torch.cat([cls, x], dim=1) + self.pos_emb.to(cd)[None]
        # unbind once per stack: its backward is one stack per leaf
        layers = {k: p.unbind(0) for k, p in self.blocks.items()}
        for i in range(cfg.depth):
            x = self._block(x, {k: v[i] for k, v in layers.items()})
        x = _layer_norm(x[:, 0], self.lnf_scale, self.lnf_bias)
        return (x @ self.head_w.to(cd) + self.head_b.to(cd)).float()


def _patchify(images: torch.Tensor, p: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/p * W/p, p * p * C), patches in row-major
    order, each flattened (row, column, channel): JAX ``_patchify``."""
    b, h, w, c = images.shape
    x = images.reshape(b, h // p, p, w // p, p, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, (h // p) * (w // p), p * p * c)


def loss_vit(model: ViT, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the float32 logits."""
    return F.cross_entropy(model(images), labels)


def scanned_layers_mask(model: ViT) -> dict:
    """name -> bool: the layer-stacked leaves (one preconditioner per layer)."""
    return {name: name.startswith("blocks.")
            for name, _ in model.named_parameters()}


def synthetic_cifar(generator: torch.Generator, n: int, num_classes: int = 10,
                    image_size: int = 32, device=None):
    """Learnable synthetic image classes (no dataset download), as the JAX
    ``synthetic_cifar``: each class a fixed low-frequency template (8 x 8 x 3
    normals from a generator seeded 4321, upsampled), a sample its template
    plus 0.7 standard normal noise.  Drawn on the CPU from ``generator``:
    (images (n, size, size, 3) float32, labels (n,) int64) on ``device``."""
    dev = resolve_device(device)
    coarse = torch.randn((num_classes, 8, 8, 3),
                         generator=torch.Generator().manual_seed(4321))
    rep = image_size // 8
    templates = coarse.repeat_interleave(rep, dim=1).repeat_interleave(rep, dim=2)
    labels = torch.randint(0, num_classes, (n,), generator=generator)
    noise = 0.7 * torch.randn((n, image_size, image_size, 3), generator=generator)
    return (templates[labels] + noise).to(dev), labels.to(dev)
