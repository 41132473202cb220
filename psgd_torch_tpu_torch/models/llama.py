"""LLaMA-family decoder LM in PyTorch, in the JAX package's layout.

Counterpart of psgd_torch_tpu/models/llama.py: RMSNorm, rotary position
embeddings, a fused SwiGLU MLP, grouped-query attention, no biases.  The
blocks' parameters are stacked along a leading layer axis
(``blocks.<name>`` of shape (n_layer, ...)) and ``forward`` loops over the
layers, so the optimizer sees the JAX transform's leaves: a fused ``wqkv``
(d, (h + 2 kv) hd) whose two Kron factors differ in width, square ``wo``,
and the SwiGLU ``w_gu`` (d, 2 hidden) / ``w_down`` (hidden, d) whose wide
dim lands on the max_skew diagonal rule.

Numerics follow the JAX model: float32 parameters cast to ``compute_dtype``
at each use, RMSNorm in float32 with eps 1e-5, half-split RoPE with float32
angles, causal attention through PyTorch's scaled_dot_product_attention
(query head j reads kv head j // (h / kv)), float32 logits.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from .gpt2 import params_from_jax, synthetic_lm_batch  # noqa: F401  (shared)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000          # multiple of 128 (LLaMA tokenizer size)
    block_size: int = 1024
    n_layer: int = 22
    n_head: int = 32
    n_kv_head: int = 4
    n_embd: int = 2048
    hidden_dim: int = 5632           # SwiGLU width (~8/3 d, padded)
    rope_theta: float = 10000.0
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = False
    tie_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def qkv_dim(self) -> int:
        """Fused q/k/v output width: h hd + 2 kv hd (unequal split)."""
        return (self.n_head + 2 * self.n_kv_head) * self.head_dim


def tiny_llama_config(**kw) -> LlamaConfig:
    """Test scale: GQA (4:1), RoPE, SwiGLU, tied head."""
    base = dict(vocab_size=256, block_size=64, n_layer=2, n_head=4,
                n_kv_head=1, n_embd=64, hidden_dim=176, tie_embeddings=True)
    base.update(kw)
    return LlamaConfig(**base)


def llama_1b(**kw) -> LlamaConfig:
    """TinyLlama-1.1B proportions (22 x 2048, 32 q / 4 kv heads, SwiGLU
    5632)."""
    base = dict(vocab_size=32000, block_size=1024, n_layer=22, n_head=32,
                n_kv_head=4, n_embd=2048, hidden_dim=5632)
    base.update(kw)
    return LlamaConfig(**base)


def llama_7b(**kw) -> LlamaConfig:
    """LLaMA-7B proportions (32 x 4096, MHA, SwiGLU 11008)."""
    base = dict(vocab_size=32000, block_size=2048, n_layer=32, n_head=32,
                n_kv_head=32, n_embd=4096, hidden_dim=11008)
    base.update(kw)
    return LlamaConfig(**base)


def _rms_norm(x, scale, eps=1e-5):
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def _rope(x, theta: float):
    """Rotary embedding over the head dim (half-split rotation, float32
    angles).  x: (B, T, H, hd), positions 0..T-1."""
    t, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] \
        * freqs[None, :]
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def attention(q, k, v):
    """Causal attention in the JAX layout: q (B, T, H, hd), k and v
    (B, T, KV, hd) with H a multiple of KV; query head j reads kv head
    j // (H / KV).  Returns (B, T, H, hd)."""
    q, k, v = (z.transpose(1, 2) for z in (q, k, v))
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                         enable_gqa=True)
    return out.transpose(1, 2)


class Llama(nn.Module):
    """Pre-RMSNorm LLaMA decoder with stacked block parameters.

    Initialization as the JAX model: normal(0, 0.02) projections, residual
    outputs (wo, w_down) scaled by 1/sqrt(2 L), unit RMSNorm scales, no
    biases; drawn from a ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, cfg: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        d, l, hd = cfg.n_embd, cfg.n_layer, cfg.hidden_dim
        gen = torch.Generator(device=dev).manual_seed(seed)
        pd = cfg.param_dtype
        std, resid_std = 0.02, 0.02 / math.sqrt(2 * l)

        def normal(shape, s=std):
            t = torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32)
            return nn.Parameter((s * t).to(pd))

        def ones(shape):
            return nn.Parameter(torch.ones(shape, dtype=pd, device=dev))

        self.wte = normal((cfg.vocab_size, d))
        self.blocks = nn.ParameterDict({
            "rms1_scale": ones((l, d)),
            "wqkv": normal((l, d, cfg.qkv_dim)),
            "wo": normal((l, cfg.n_head * cfg.head_dim, d), resid_std),
            "rms2_scale": ones((l, d)),
            "w_gu": normal((l, d, 2 * hd)),
            "w_down": normal((l, hd, d), resid_std),
        })
        self.rmsf_scale = ones((d,))
        self.lm_head = None if cfg.tie_embeddings else \
            normal((d, cfg.vocab_size))

    def _block(self, x, bp):
        cfg = self.cfg
        b, t, _ = x.shape
        h, kv, hd, cd = cfg.n_head, cfg.n_kv_head, cfg.head_dim, cfg.compute_dtype
        y = _rms_norm(x, bp["rms1_scale"])
        qkv = y @ bp["wqkv"].to(cd)
        q, k, v = qkv.split([h * hd, kv * hd, kv * hd], dim=-1)
        q = _rope(q.reshape(b, t, h, hd), cfg.rope_theta)
        k = _rope(k.reshape(b, t, kv, hd), cfg.rope_theta)
        att = attention(q, k, v.reshape(b, t, kv, hd))
        x = x + att.reshape(b, t, h * hd) @ bp["wo"].to(cd)
        y = _rms_norm(x, bp["rms2_scale"])
        g, u = (y @ bp["w_gu"].to(cd)).chunk(2, dim=-1)
        return x + (F.silu(g) * u) @ bp["w_down"].to(cd)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, T) int tokens -> (B, T, vocab) float32 logits."""
        cfg = self.cfg
        cd = cfg.compute_dtype
        x = self.wte[tokens].to(cd)
        # unbind once per stack: its backward is one stack per leaf
        layers = {k: p.unbind(0) for k, p in self.blocks.items()}
        for i in range(cfg.n_layer):
            bp = {k: v[i] for k, v in layers.items()}
            if cfg.remat:
                x = checkpoint(self._block, x, bp, use_reentrant=False)
            else:
                x = self._block(x, bp)
        x = _rms_norm(x, self.rmsf_scale)
        head = self.wte.t() if cfg.tie_embeddings else self.lm_head
        return (x @ head.to(cd)).float()


def loss_llama(model: Llama, tokens: torch.Tensor,
               targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy with float32 logits."""
    logits = model(tokens)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))


def scanned_layers_mask(model: Llama) -> dict:
    """name -> bool: the layer-stacked leaves (one preconditioner per layer)."""
    return {name: name.startswith("blocks.")
            for name, _ in model.named_parameters()}


def count_params(model: Llama) -> int:
    return sum(p.numel() for p in model.parameters())
