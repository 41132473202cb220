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

``shard_model(model, mesh)`` places the parameters as JAX
``gpt2_partition_specs`` places them on a (dp, fsdp, tp) mesh (DTensor
parameters, each rank its block) and switches the forward to the
tensor-parallel one, which computes what JAX's ``loss_gpt2`` computes
under GSPMD on the same parameters:

* each parameter's block gathered over the mesh dims other than tp
  (``parallel.tensor_parallel.gather``: bytes, backward this rank's
  block), so every rank of a tp group holds its tp block whole;
* the embedding vocab-parallel: each rank looks up the tokens of its rows
  of ``wte`` (zeros for the others) and the sum over tp is the lookup;
* ``attn_qkv_w``'s 3d columns are cut contiguously over tp (tp 2: rank 0
  holds q and the first half of k), so the qkv activations are gathered
  over tp and each rank takes its heads [r h/tp, (r+1) h/tp) of q, k and
  v; ``attn_proj_w`` and ``mlp_proj_w`` row-parallel (their products
  summed over tp in float32), ``mlp_fc_w`` and ``mlp_fc_b``
  column-parallel; LayerNorms and the ``*_proj_b`` replicated;
* the tied logits vocab-parallel and the cross-entropy over them (the
  max, the sum of exponentials and the target's logit summed over tp);
  ``forward`` gathers the logits whole.

Every rank of a tp group must see the same tokens.  On a mesh whose tp
dim is 1 the sharded forward is the plain one, bit for bit.

``cfg.remat`` recomputes each block in the backward (JAX's ``remat``,
``jax.checkpoint`` of the block), at every tp size: the recomputation
repeats the block's tp collectives, in the same order on every rank.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..parallel import tensor_parallel


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50304          # 50257 padded up to a multiple of 128
    block_size: int = 1024
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = False              # recompute each block in the backward

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


def gpt2_350m(**kw) -> GPT2Config:
    """GPT-2 medium proportions (24 x 1024, 16 heads)."""
    base = dict(vocab_size=50304, block_size=1024, n_layer=24, n_head=16,
                n_embd=1024)
    base.update(kw)
    return GPT2Config(**base)


def gpt2_774m(**kw) -> GPT2Config:
    """GPT-2 large proportions (36 x 1280, 20 heads)."""
    base = dict(vocab_size=50304, block_size=1024, n_layer=36, n_head=20,
                n_embd=1280)
    base.update(kw)
    return GPT2Config(**base)


_BLOCK_LEAVES = ("ln1_scale", "ln1_bias", "attn_qkv_w", "attn_qkv_b", "attn_proj_w",
                 "attn_proj_b", "ln2_scale", "ln2_bias", "mlp_fc_w", "mlp_fc_b",
                 "mlp_proj_w", "mlp_proj_b")


def param_shapes(cfg: GPT2Config) -> dict:
    """name -> shape of every parameter (the JAX tree's leaves, dotted; the
    blocks' stacked along the layer axis), without building the model."""
    d, l = cfg.n_embd, cfg.n_layer
    per_layer = {"attn_qkv_w": (d, 3 * d), "attn_qkv_b": (3 * d,),
                 "attn_proj_w": (d, d), "mlp_fc_w": (d, 4 * d),
                 "mlp_fc_b": (4 * d,), "mlp_proj_w": (4 * d, d)}
    return {"wte": (cfg.vocab_size, d), "wpe": (cfg.block_size, d),
            **{f"blocks.{k}": (l, *per_layer.get(k, (d,))) for k in _BLOCK_LEAVES},
            "lnf_scale": (d,), "lnf_bias": (d,)}


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
        gen = torch.Generator(device=dev).manual_seed(seed)
        pd = cfg.param_dtype
        std, resid_std = 0.02, 0.02 / math.sqrt(2 * cfg.n_layer)

        def normal(shape, s=std):
            t = torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32)
            return nn.Parameter((s * t).to(pd))

        def const(shape, v):
            return nn.Parameter(torch.full(shape, v, dtype=pd, device=dev))

        shape = param_shapes(cfg)
        blk = {k: shape[f"blocks.{k}"] for k in _BLOCK_LEAVES}
        self.wte = normal(shape["wte"])
        self.wpe = normal(shape["wpe"], 0.01)
        self.blocks = nn.ParameterDict({
            "ln1_scale": const(blk["ln1_scale"], 1.0),
            "ln1_bias": const(blk["ln1_bias"], 0.0),
            "attn_qkv_w": normal(blk["attn_qkv_w"]),
            "attn_qkv_b": const(blk["attn_qkv_b"], 0.0),
            "attn_proj_w": normal(blk["attn_proj_w"], resid_std),
            "attn_proj_b": const(blk["attn_proj_b"], 0.0),
            "ln2_scale": const(blk["ln2_scale"], 1.0),
            "ln2_bias": const(blk["ln2_bias"], 0.0),
            "mlp_fc_w": normal(blk["mlp_fc_w"]),
            "mlp_fc_b": const(blk["mlp_fc_b"], 0.0),
            "mlp_proj_w": normal(blk["mlp_proj_w"], resid_std),
            "mlp_proj_b": const(blk["mlp_proj_b"], 0.0),
        })
        self.lnf_scale = const(shape["lnf_scale"], 1.0)
        self.lnf_bias = const(shape["lnf_bias"], 0.0)
        self._tp = tensor_parallel.PLAIN    # shard_model's layout

    def _block(self, x, bp, lay):
        cfg = self.cfg
        b, t, d = x.shape
        h, hd, cd = cfg.n_head, cfg.head_dim, cfg.compute_dtype
        y = _layer_norm(x, bp["ln1_scale"], bp["ln1_bias"])
        qkv = lay.copy(y) @ bp["attn_qkv_w"].to(cd) + bp["attn_qkv_b"].to(cd)
        # every tp rank's columns, then this rank's heads of q, k and v
        qkv = lay.copy(lay.gather(qkv, -1))
        heads = _heads(h, lay.size, lay.index)
        q, k, v = (z.reshape(b, t, h, hd)[:, :, heads].transpose(1, 2)
                   for z in qkv.split(d, dim=-1))
        att = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        att = att.transpose(1, 2).reshape(b, t, -1)
        # the row-parallel products' partial sums, summed over tp
        x = x + lay.reduce(att @ bp["attn_proj_w"].to(cd)) + \
            bp["attn_proj_b"].to(cd)
        y = _layer_norm(x, bp["ln2_scale"], bp["ln2_bias"])
        y = lay.copy(y) @ bp["mlp_fc_w"].to(cd) + bp["mlp_fc_b"].to(cd)
        y = F.gelu(y, approximate="tanh")
        return x + lay.reduce(y @ bp["mlp_proj_w"].to(cd)) + \
            bp["mlp_proj_b"].to(cd)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, T) int tokens -> (B, T, vocab) float32 logits."""
        x, wte = self._hidden(tokens)
        return self._tp.gather(self._logits(x, wte), -1)

    def _hidden(self, tokens: torch.Tensor):
        """(the final LayerNorm's output, this rank's rows of wte)."""
        cd, lay = self.cfg.compute_dtype, self._tp
        t = tokens.shape[1]
        wte = lay.block(self.wte, "wte")
        emb = tensor_parallel.embedding(wte, tokens, lay)
        x = emb.to(cd) + lay.block(self.wpe, "wpe")[:t].to(cd)[None]
        # unbind once per stack: its backward is one stack per leaf
        layers = {k: lay.block(p, f"blocks.{k}").unbind(0)
                  for k, p in self.blocks.items()}
        for i in range(self.cfg.n_layer):
            bp = {k: v[i] for k, v in layers.items()}
            if self.cfg.remat:
                x = checkpoint(self._block, x, bp, lay, use_reentrant=False)
            else:
                x = self._block(x, bp, lay)
        x = _layer_norm(x, lay.block(self.lnf_scale, "lnf_scale"),
                        lay.block(self.lnf_bias, "lnf_bias"))
        return x, wte

    def _logits(self, x, wte) -> torch.Tensor:
        """This rank's columns of the tied logits, float32."""
        cd = self.cfg.compute_dtype
        return (self._tp.copy(x) @ wte.t().to(cd)).float()


def _heads(n_head: int, tp: int, index: int):
    """The heads tp rank ``index`` of ``tp`` attends with."""
    k = n_head // tp
    return slice(index * k, (index + 1) * k)


# the tensor dim that tp shards in the JAX layout (others: replicated)
_TP_DIMS = {"wte": 0, "blocks.attn_qkv_w": 2, "blocks.attn_qkv_b": 1,
            "blocks.attn_proj_w": 1, "blocks.mlp_fc_w": 2, "blocks.mlp_fc_b": 1,
            "blocks.mlp_proj_w": 1}


def shard_model(model: GPT2, mesh, placements: dict | None = None) -> GPT2:
    """Place ``model``'s parameters on ``mesh`` (``placements``: name ->
    DTensor placements, default ``parallel.gpt2_partition_specs(mesh)``)
    and switch its forward to the tensor-parallel one (module docstring);
    returns the model.  The layout's rules and refusals are
    ``parallel.tensor_parallel.shard``'s over ``_TP_DIMS``: tp must shard
    the dims the JAX layout shards over tp and no other.  Every rank calls
    it alike.  Raises ValueError for another layout."""
    from ..parallel.mesh import gpt2_partition_specs
    model._tp = tensor_parallel.shard(
        model, mesh, placements or gpt2_partition_specs(mesh), _TP_DIMS)
    return model


def loss_gpt2(model: GPT2, tokens: torch.Tensor,
              targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy with float32 logits (a sharded
    model's over its vocab-parallel logits)."""
    if model._tp.size > 1:
        return tensor_parallel.cross_entropy(
            model._logits(*model._hidden(tokens)), targets, model._tp)
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
