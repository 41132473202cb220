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

``shard_model(model, mesh)`` places the parameters as JAX
``llama_partition_specs`` places them on a (dp, fsdp, tp) mesh (DTensor
parameters, each rank its block) and switches the forward to the
tensor-parallel one, which computes what JAX's ``loss_llama`` computes
under GSPMD on the same parameters.  The machinery is GPT-2's
(``parallel.tensor_parallel``: each block gathered over the mesh dims
other than tp, the vocab-parallel embedding and cross-entropy); what
LLaMA adds:

* ``wqkv``'s (h + 2 kv) hd columns are cut contiguously over tp, so its
  output is gathered over tp and each rank takes its query heads [r h/tp,
  (r+1) h/tp) and the kv heads those read (``_heads``): with kv a multiple
  of tp, kv heads [r kv/tp, (r+1) kv/tp); with kv < tp a kv head is read
  by several ranks, and the sum over tp in the gather's backward makes its
  gradient whole.  RoPE is applied per head after the split (its positions
  do not change);
* ``w_gu``'s columns are [gate | up], cut contiguously too (tp 2: rank 0
  holds every gate column), so its output is gathered over tp and each
  rank takes hidden block r of g and of u (``_gate_up``); ``w_down``
  row-parallel on that block;
* ``wo`` and ``w_down`` row-parallel, their products summed over tp in
  float32; the RMSNorm scales replicated;
* the logits vocab-parallel: from ``lm_head``'s tp columns (placed
  (fsdp, tp)) or, tied, from ``wte``'s tp rows; ``forward`` gathers them
  whole, ``loss_llama`` takes the vocab-parallel cross-entropy.

Every rank of a tp group must see the same tokens.  On a mesh whose tp
dim is 1 the sharded forward is the plain one, bit for bit.  ``cfg.remat``
recomputes each block, its tp collectives included, at every tp size.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..parallel import tensor_parallel
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
        self._tp = tensor_parallel.PLAIN    # shard_model's layout

    def _block(self, x, bp, lay):
        cfg = self.cfg
        b, t, _ = x.shape
        h, kv, hd, cd = cfg.n_head, cfg.n_kv_head, cfg.head_dim, cfg.compute_dtype
        qh, kvh = _heads(h, kv, lay.size, lay.index)
        y = _rms_norm(x, bp["rms1_scale"])
        qkv = lay.copy(y) @ bp["wqkv"].to(cd)
        # every tp rank's columns, then this rank's query heads and the kv
        # heads they read
        qkv = lay.copy(lay.gather(qkv, -1))
        q, k, v = qkv.split([h * hd, kv * hd, kv * hd], dim=-1)
        q = _rope(q.reshape(b, t, h, hd)[:, :, qh], cfg.rope_theta)
        k = _rope(k.reshape(b, t, kv, hd)[:, :, kvh], cfg.rope_theta)
        att = attention(q, k, v.reshape(b, t, kv, hd)[:, :, kvh])
        # the row-parallel products' partial sums, summed over tp
        x = x + lay.reduce(att.reshape(b, t, -1) @ bp["wo"].to(cd))
        y = _rms_norm(x, bp["rms2_scale"])
        gu = lay.copy(lay.gather(lay.copy(y) @ bp["w_gu"].to(cd), -1))
        g, u = _gate_up(gu, lay.size, lay.index)
        return x + lay.reduce((F.silu(g) * u) @ bp["w_down"].to(cd))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, T) int tokens -> (B, T, vocab) float32 logits."""
        return self._tp.gather(self._logits(*self._hidden(tokens)), -1)

    def _hidden(self, tokens: torch.Tensor):
        """(the final RMSNorm's output, this rank's tp block of the head:
        (d, V/tp))."""
        cfg, lay = self.cfg, self._tp
        wte = lay.block(self.wte, "wte")
        x = tensor_parallel.embedding(wte, tokens, lay).to(cfg.compute_dtype)
        # unbind once per stack: its backward is one stack per leaf
        layers = {k: lay.block(p, f"blocks.{k}").unbind(0)
                  for k, p in self.blocks.items()}
        for i in range(cfg.n_layer):
            bp = {k: v[i] for k, v in layers.items()}
            if cfg.remat:
                x = checkpoint(self._block, x, bp, lay, use_reentrant=False)
            else:
                x = self._block(x, bp, lay)
        x = _rms_norm(x, lay.block(self.rmsf_scale, "rmsf_scale"))
        head = wte.t() if cfg.tie_embeddings else lay.block(self.lm_head, "lm_head")
        return x, head

    def _logits(self, x, head) -> torch.Tensor:
        """This rank's columns of the logits, float32."""
        return (self._tp.copy(x) @ head.to(self.cfg.compute_dtype)).float()


def _heads(n_head: int, n_kv_head: int, tp: int, index: int):
    """(the query heads tp rank ``index`` of ``tp`` attends with, the kv
    heads they read, in the order ``attention`` pairs them).  Query head j
    reads kv head j // (h / kv); the rank's query heads [a, a + m) read kv
    heads [a // g, (a + m - 1) // g + 1), taken as one slice when GQA's
    grouping of the m heads over them is that reading (every m / n query
    heads one kv head), else one kv head per query head."""
    m, g = n_head // tp, n_head // n_kv_head
    a = index * m
    lo, hi = a // g, (a + m - 1) // g + 1
    n = hi - lo
    if m % n == 0 and all((a + j) // g - lo == j // (m // n) for j in range(m)):
        return slice(a, a + m), slice(lo, hi)
    return slice(a, a + m), [(a + j) // g for j in range(m)]


def _gate_up(gu: torch.Tensor, tp: int, index: int):
    """(g, u): hidden block ``index`` of ``tp`` of the gate and of the up
    projection from the whole [gate | up] output."""
    hidden = gu.shape[-1] // 2
    k = hidden // tp
    lo = index * k
    return gu[..., lo:lo + k], gu[..., hidden + lo:hidden + lo + k]


# the tensor dim that tp shards in the JAX layout (others: replicated)
_TP_DIMS = {"wte": 0, "lm_head": 1, "blocks.wqkv": 2, "blocks.wo": 1,
            "blocks.w_gu": 2, "blocks.w_down": 1}


def shard_model(model: Llama, mesh, placements: dict | None = None) -> Llama:
    """Place ``model``'s parameters on ``mesh`` (``placements``: name ->
    DTensor placements, default ``parallel.llama_partition_specs(mesh,
    model)``) and switch its forward to the tensor-parallel one (module
    docstring); returns the model.  The layout's rules and refusals are
    ``parallel.tensor_parallel.shard``'s over ``_TP_DIMS``.  Every rank
    calls it alike.  Raises ValueError, naming the dim, when ``n_head``,
    ``hidden_dim`` or ``vocab_size`` is not a multiple of the mesh's tp
    dim, or for a tp placement the forward does not take."""
    from ..parallel.mesh import llama_partition_specs
    names = tuple(mesh.mesh_dim_names)
    tp = mesh.size(names.index("tp")) if "tp" in names else 1
    cfg = model.cfg
    for dim in ("n_head", "hidden_dim", "vocab_size"):
        if getattr(cfg, dim) % tp:
            raise ValueError(f"{dim} {getattr(cfg, dim)} is not a multiple of "
                             f"the mesh's tp {tp}")
    model._tp = tensor_parallel.shard(
        model, mesh, placements or llama_partition_specs(mesh, model), _TP_DIMS)
    return model


def loss_llama(model: Llama, tokens: torch.Tensor,
               targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy with float32 logits (a sharded
    model's over its vocab-parallel logits)."""
    if model._tp.size > 1:
        return tensor_parallel.cross_entropy(
            model._logits(*model._hidden(tokens)), targets, model._tp)
    logits = model(tokens)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))


def scanned_layers_mask(model: Llama) -> dict:
    """name -> bool: the layer-stacked leaves (one preconditioner per layer)."""
    return {name: name.startswith("blocks.")
            for name, _ in model.named_parameters()}


def count_params(model: Llama) -> int:
    return sum(p.numel() for p in model.parameters())
