"""Recurrent models for the delayed-XOR problem (the reference's hard
long-horizon benchmark: lstm_with_xor_problem.py and
rnn_xor_problem_general_purpose_preconditioner.py), functional PyTorch.

Counterpart of psgd_torch_tpu/models/rnn.py.  The task: a sequence of
(value, marker) pairs with exactly two marked positions; the target is the
XOR of the two marked values, in the +-1 encoding.  The reference counts
it solved at a loss below 0.1 (lstm_with_xor_problem.py:72-74).  Each
cell's input, recurrent and bias weights are one affine matrix
[W_in; W_rec; b], as the JAX models hold them; a parameter set is a dict
(name -> tensor), its sorted names the JAX pytree order.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device


def _params(tensors: dict, dtype, device) -> dict:
    dev = resolve_device(device)
    return {k: v.to(device=dev, dtype=dtype).requires_grad_()
            for k, v in tensors.items()}


def init_rnn(generator: torch.Generator | None = None, dim_in: int = 2,
             dim_hidden: int = 30, dim_out: int = 1, dtype=torch.float32,
             device=None) -> dict:
    """The tanh RNN: input block 0.1 randn, recurrent block orthogonal (the
    Q of a normal matrix's QR, reference get_rand_orth), zero biases; drawn
    in float32 on the CPU from ``generator``."""
    w_in = 0.1 * torch.randn((dim_in, dim_hidden), generator=generator)
    w_rec, _ = torch.linalg.qr(torch.randn((dim_hidden, dim_hidden),
                                           generator=generator))
    w1 = torch.cat([w_in, w_rec, torch.zeros((1, dim_hidden))])
    w2 = torch.cat([0.1 * torch.randn((dim_hidden, dim_out), generator=generator),
                    torch.zeros((1, dim_out))])
    return _params({"w1": w1, "w2": w2}, dtype, device)


def apply_rnn(params: dict, xs: torch.Tensor) -> torch.Tensor:
    """xs (T, B, dim_in) -> (B, dim_out): the tanh RNN, read out from its
    last state."""
    w1, b1 = params["w1"][:-1], params["w1"][-1]
    w2, b2 = params["w2"][:-1], params["w2"][-1]
    h = xs.new_zeros((xs.shape[1], w1.shape[1]))
    for x in xs:
        h = torch.tanh(torch.cat([x, h], dim=1) @ w1 + b1)
    return h @ w2 + b2


def init_lstm(generator: torch.Generator | None = None, dim_in: int = 2,
              dim_hidden: int = 30, dim_out: int = 1, dtype=torch.float32,
              device=None) -> dict:
    """An LSTM with its four gates (i, f, g, o) in one affine matrix, the
    weights normal times fan_in^-1/2, the biases zero but the forget
    gate's 1 (reference lstm_with_xor_problem.py:23-45)."""
    fan = dim_in + dim_hidden
    w = torch.randn((fan + 1, 4 * dim_hidden), generator=generator) * fan ** -0.5
    w[-1] = 0.0
    w[-1, dim_hidden:2 * dim_hidden] = 1.0
    w2 = torch.randn((dim_hidden + 1, dim_out), generator=generator) \
        * dim_hidden ** -0.5
    return _params({"w_gates": w, "w_out": w2}, dtype, device)


def apply_lstm(params: dict, xs: torch.Tensor) -> torch.Tensor:
    wg, bg = params["w_gates"][:-1], params["w_gates"][-1]
    w2, b2 = params["w_out"][:-1], params["w_out"][-1]
    h = xs.new_zeros((xs.shape[1], w2.shape[0]))
    c = torch.zeros_like(h)
    for x in xs:
        i, f, g, o = (torch.cat([x, h], dim=1) @ wg + bg).chunk(4, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
    return h @ w2 + b2


def params_from_jax(params: dict) -> dict:
    """The JAX model's parameter dict (numpy arrays) as tensors."""
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


def xor_batch(generator: torch.Generator, batch_size: int, seq_len: int,
              device=None):
    """Delayed-XOR data (reference generate_train_data,
    lstm_with_xor_problem.py:47-60): values +-1, one marked position in
    each half of the sequence, the target their product (XOR in the +-1
    encoding).  Drawn on the CPU from ``generator``: (xs (T, B, 2), target
    (B, 1)) float32 on ``device``."""
    dev = resolve_device(device)
    values = torch.sign(torch.randn((seq_len, batch_size), generator=generator))
    values = torch.where(values == 0, 1.0, values)
    i = torch.randint(0, seq_len // 2, (batch_size,), generator=generator)
    j = torch.randint(seq_len // 2, seq_len, (batch_size,), generator=generator)
    pos = torch.arange(seq_len)[:, None]
    marker = ((pos == i[None]) | (pos == j[None])).to(values.dtype)
    xs = torch.stack([values, marker], dim=-1)
    cols = torch.arange(batch_size)
    target = (values[i, cols] * values[j, cols])[:, None]
    return xs.to(dev), target.to(dev)


def xor_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The logistic loss in the +-1 encoding (reference train_criterion,
    lstm_with_xor_problem.py:63-65)."""
    return -torch.mean(torch.log(torch.sigmoid(logits * target) + 1e-30))
