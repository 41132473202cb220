"""GPT-2 style transformer LM in PyTorch, in the JAX package's layout.

Counterpart of psgd_torch_tpu/models/gpt2.py.  The transformer blocks'
parameters are stacked along a leading layer axis (``blocks.<name>`` of
shape (n_layer, ...)) and ``forward`` loops over the layers, so the
optimizer sees the same leaves as the JAX transform and fits one
preconditioner per layer with one batched update per stack.

Numerics follow the JAX model: float32 parameters cast to
``compute_dtype`` at each use, LayerNorm in float32 with eps 1e-5,
tanh-approximate GELU, causal attention, a weight-tied LM head with
float32 logits, vocab padded to 50304.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50304          # 50257 padded up to a multiple of 128
    block_size: int = 1024
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


def tiny_config(**kw) -> GPT2Config:
    """The reference demo scale (6 layers / 12 heads / 384 embd / block 128)."""
    base = dict(vocab_size=50304, block_size=128, n_layer=6, n_head=12,
                n_embd=384)
    base.update(kw)
    return GPT2Config(**base)


def gpt2_124m(**kw) -> GPT2Config:
    base = dict(vocab_size=50304, block_size=1024, n_layer=12, n_head=12,
                n_embd=768)
    base.update(kw)
    return GPT2Config(**base)


def _layer_norm(x, scale, bias, eps=1e-5):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


class GPT2(nn.Module):
    """Pre-LN GPT-2 with stacked block parameters.

    Initialization as the JAX model: normal(0, 0.02), residual projections
    scaled by 1/sqrt(2 L), position table 0.01, zero biases, unit LayerNorm
    scales; drawn from a ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, cfg: GPT2Config, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        d, l = cfg.n_embd, cfg.n_layer
        gen = torch.Generator(device=dev).manual_seed(seed)
        pd = cfg.param_dtype
        std, resid_std = 0.02, 0.02 / math.sqrt(2 * l)

        def normal(shape, s=std):
            t = torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32)
            return nn.Parameter((s * t).to(pd))

        def const(shape, v):
            return nn.Parameter(torch.full(shape, v, dtype=pd, device=dev))

        self.wte = normal((cfg.vocab_size, d))
        self.wpe = normal((cfg.block_size, d), 0.01)
        self.blocks = nn.ParameterDict({
            "ln1_scale": const((l, d), 1.0),
            "ln1_bias": const((l, d), 0.0),
            "attn_qkv_w": normal((l, d, 3 * d)),
            "attn_qkv_b": const((l, 3 * d), 0.0),
            "attn_proj_w": normal((l, d, d), resid_std),
            "attn_proj_b": const((l, d), 0.0),
            "ln2_scale": const((l, d), 1.0),
            "ln2_bias": const((l, d), 0.0),
            "mlp_fc_w": normal((l, d, 4 * d)),
            "mlp_fc_b": const((l, 4 * d), 0.0),
            "mlp_proj_w": normal((l, 4 * d, d), resid_std),
            "mlp_proj_b": const((l, d), 0.0),
        })
        self.lnf_scale = const((d,), 1.0)
        self.lnf_bias = const((d,), 0.0)

    def _block(self, x, bp):
        cfg = self.cfg
        b, t, d = x.shape
        h, hd, cd = cfg.n_head, cfg.head_dim, cfg.compute_dtype
        y = _layer_norm(x, bp["ln1_scale"], bp["ln1_bias"])
        qkv = y @ bp["attn_qkv_w"].to(cd) + bp["attn_qkv_b"].to(cd)
        q, k, v = (z.reshape(b, t, h, hd).transpose(1, 2)
                   for z in qkv.split(d, dim=-1))
        att = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        att = att.transpose(1, 2).reshape(b, t, d)
        x = x + att @ bp["attn_proj_w"].to(cd) + bp["attn_proj_b"].to(cd)
        y = _layer_norm(x, bp["ln2_scale"], bp["ln2_bias"])
        y = y @ bp["mlp_fc_w"].to(cd) + bp["mlp_fc_b"].to(cd)
        y = F.gelu(y, approximate="tanh")
        return x + y @ bp["mlp_proj_w"].to(cd) + bp["mlp_proj_b"].to(cd)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, T) int tokens -> (B, T, vocab) float32 logits."""
        cd = self.cfg.compute_dtype
        t = tokens.shape[1]
        x = self.wte[tokens].to(cd) + self.wpe[:t].to(cd)[None]
        # unbind once per stack: its backward is one stack per leaf
        layers = {k: p.unbind(0) for k, p in self.blocks.items()}
        for i in range(self.cfg.n_layer):
            x = self._block(x, {k: v[i] for k, v in layers.items()})
        x = _layer_norm(x, self.lnf_scale, self.lnf_bias)
        return (x @ self.wte.t().to(cd)).float()


def loss_gpt2(model: GPT2, tokens: torch.Tensor,
              targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy with float32 logits."""
    logits = model(tokens)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))


def scanned_layers_mask(model: GPT2) -> dict:
    """name -> bool: the layer-stacked leaves (one preconditioner per layer)."""
    return {name: name.startswith("blocks.")
            for name, _ in model.named_parameters()}


def params_from_jax(tree: dict) -> dict:
    """The JAX model's parameter tree (numpy arrays) as this module's state
    dict: nested keys joined with '.'."""
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{k}.", v)
        else:
            out[prefix[:-1]] = torch.from_numpy(np.array(node))

    walk("", tree)
    return out


def synthetic_lm_batch(generator: torch.Generator, batch: int, seq_len: int,
                       vocab_size: int, device=None):
    """Synthetic, learnable LM data (as the JAX ``synthetic_lm_batch``):
    x[t] = (31 x[t-1] + 7) mod vocab with probability 0.8, else a uniform
    token.  Drawn on the CPU from ``generator``; returned on ``device``."""
    dev = resolve_device(device)
    base = torch.randint(0, vocab_size, (batch, seq_len + 1),
                         generator=generator)
    coins = torch.rand((batch, seq_len + 1), generator=generator)
    toks = torch.empty_like(base)
    prev = base[:, 0]
    for t in range(seq_len + 1):
        prev = torch.where(coins[:, t] < 0.8, (prev * 31 + 7) % vocab_size,
                           base[:, t])
        toks[:, t] = prev
    toks = toks.to(dev)
    return toks[:, :-1], toks[:, 1:]
