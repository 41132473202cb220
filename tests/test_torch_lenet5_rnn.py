"""The port's LeNet5, tanh RNN and LSTM (psgd_torch_tpu_torch.models
.lenet5, .rnn), its digits loader (.image_data) and the two examples that
run the legacy families (psgd_torch_tpu_torch.examples.mnist_lenet5,
.affine_wrapped_layers) against the JAX package's: forward parity through
``params_from_jax`` on the JAX models' own weights and inputs, the RNN's
Hessian-vector product, the digits split and resize; then the data makers'
invariants and one tiny ``main()`` run of each example on the CPU.

Tolerance: rtol 1e-9 in float64.  The LeNet5 loss takes its log-softmax in
float32 on both sides (as the JAX model does), so it holds at 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_torch_tpu.models import image_data as jimage
from psgd_torch_tpu.models import lenet5 as jlenet5
from psgd_torch_tpu.models import rnn as jrnn
from psgd_torch_tpu_torch.examples import affine_wrapped_layers, mnist_lenet5
from psgd_torch_tpu_torch.models import image_data, lenet5, rnn
from psgd_torch_tpu_torch.optim import hvp
from test_torch_kron import to_np
from test_torch_legacy import FAST_COMPILE

RTOL = 1e-9
F32_RTOL = 1e-6


def close(got, ref, rtol=RTOL, what=""):
    ref = to_np(ref)
    np.testing.assert_allclose(to_np(got), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(initial=0.0), 1e-300),
                               err_msg=what)


def jit(fn):
    return jax.jit(fn, compiler_options=FAST_COMPILE)


def test_lenet5_forward_matches_jax():
    jparams = jit(functools.partial(jlenet5.init_lenet5, dtype=jnp.float64))(
        jax.random.key(0))
    images, labels = jit(lambda k: jlenet5.synthetic_mnist(k, 6))(jax.random.key(1))
    images = images.astype(jnp.float64)
    params = lenet5.params_from_jax([np.asarray(p) for p in jparams])
    assert [tuple(p.shape) for p in params] == [(f + 1, o) for f, o in lenet5.LAYERS]
    x = torch.from_numpy(np.array(images)).permute(0, 3, 1, 2)   # NHWC -> NCHW
    y = torch.from_numpy(np.array(labels)).long()
    close(lenet5.apply_lenet5(params, x), jit(jlenet5.apply_lenet5)(jparams, images),
          what="logits")
    close(lenet5.loss_lenet5(params, x, y),
          jit(jlenet5.loss_lenet5)(jparams, images, labels), F32_RTOL, "loss")


@pytest.mark.parametrize("cell", ["rnn", "lstm"])
def test_recurrent_forward_and_hvp_match_jax(cell):
    init, apply = ((jrnn.init_rnn, jrnn.apply_rnn) if cell == "rnn"
                   else (jrnn.init_lstm, jrnn.apply_lstm))
    jparams = jit(functools.partial(init, dim_hidden=7, dtype=jnp.float64))(
        jax.random.key(2))
    xs, target = jit(lambda k: jrnn.xor_batch(k, 5, 8))(jax.random.key(3))
    params = {k: v.requires_grad_() for k, v in rnn.params_from_jax(
        {k: np.asarray(v) for k, v in jparams.items()}).items()}
    txs, ttarget = (torch.from_numpy(np.array(a, np.float64)) for a in (xs, target))
    tapply = rnn.apply_rnn if cell == "rnn" else rnn.apply_lstm
    close(tapply(params, txs), jit(apply)(jparams, xs.astype(jnp.float64)),
          what="outputs")

    def jloss(p):
        return jrnn.xor_loss(apply(p, xs.astype(jnp.float64)), target)

    names = sorted(params)
    vs = {k: np.random.default_rng(4).standard_normal(params[k].shape) for k in names}
    jv = {k: jnp.asarray(v) for k, v in vs.items()}
    jl, (jg, jh) = jit(lambda p, v: (jloss(p), jax.jvp(jax.grad(jloss), (p,), (v,))))(
        jparams, jv)
    leaves = [params[k] for k in names]
    loss = rnn.xor_loss(tapply(params, txs), ttarget)
    close(loss, jl, what="loss")
    grads, hvs = hvp.hvp_exact(lambda: rnn.xor_loss(tapply(params, txs), ttarget),
                               leaves, [torch.from_numpy(vs[k]) for k in names])
    for k, g, h in zip(names, grads, hvs):
        close(g, jg[k], what=f"grad {k}")
        close(h, jh[k], what=f"H v {k}")


def test_initialisers_and_data():
    gen = torch.Generator().manual_seed(0)
    params = lenet5.init_lenet5(gen, device="cpu")
    assert sum(p.numel() for p in params) == 61706
    assert all(p.requires_grad and float(p[-1].detach().abs().max()) == 0.0
               for p in params)
    r = rnn.init_rnn(gen, device="cpu")
    w_rec = r["w1"][2:32].detach()
    close(w_rec.T @ w_rec, torch.eye(30), 1e-6, "orthogonal recurrent block")
    assert sum(p.numel() for p in r.values()) == 1021
    lstm = rnn.init_lstm(gen, device="cpu")
    assert float(lstm["w_gates"][-1, 30:60].detach().min()) == 1.0

    images, labels = lenet5.synthetic_mnist(torch.Generator().manual_seed(1), 64,
                                            device="cpu")
    again, labels2 = lenet5.synthetic_mnist(torch.Generator().manual_seed(1), 64,
                                            device="cpu")
    assert images.shape == (64, 1, 32, 32) and torch.equal(images, again)
    assert torch.equal(labels, labels2) and int(labels.max()) < 10
    # one template per class: the class means differ by much more than the noise
    means = torch.stack([images[labels == c].mean(0) for c in labels.unique()])
    assert float(torch.cdist(means.flatten(1), means.flatten(1)).sum()) > 0

    xs, target = rnn.xor_batch(torch.Generator().manual_seed(2), 16, 10, device="cpu")
    assert xs.shape == (10, 16, 2) and target.shape == (16, 1)
    marks = xs[..., 1]
    assert torch.equal(marks.sum(0), torch.full((16,), 2.0))
    assert torch.equal(marks[:5].sum(0), torch.ones(16))
    marked = (xs[..., 0] * marks).T
    prod = torch.where(marked == 0, torch.ones_like(marked), marked).prod(1)
    assert torch.equal(prod[:, None], target)
    assert set(xs[..., 0].unique().tolist()) == {-1.0, 1.0}


def test_image_data_matches_jax():
    pytest.importorskip("sklearn")
    split = image_data.load_digits_split()
    for a, b in zip(split, jimage.load_digits_split()):
        assert np.array_equal(a, b)
    x = np.random.default_rng(5).random((3, 8, 8))
    got = image_data.digits_resized(x, 32, channels=3)
    ref = np.asarray(jimage.digits_resized(x, 32, 3))
    assert got.shape == (3, 3, 32, 32)
    close(got.permute(0, 2, 3, 1), ref, what="resize")
    xb = torch.arange(10.0)[:, None]
    yb = torch.arange(10)
    out = list(image_data.batches(torch.Generator().manual_seed(0), xb, yb, 4, 3,
                                  device="cpu"))
    assert len(out) == 3 and all(torch.equal(a[:, 0].long(), b) for a, b in out)


def test_mnist_lenet5_main(capsys, monkeypatch):
    out = mnist_lenet5.main(["--device", "cpu", "--epochs", "2",
                             "--steps_per_epoch", "2", "--batch", "8"])
    printed = capsys.readouterr().out
    assert "data: real UCI digits" in printed or "data: synthetic" in printed
    assert np.isfinite(out["train_loss"]) and 0.0 <= out["test_acc"] <= 1.0

    def missing(*args, **kwargs):
        raise ImportError("no sklearn")

    monkeypatch.setattr(image_data, "load_digits_split", missing)
    out = mnist_lenet5.main(["--device", "cpu", "--epochs", "1",
                             "--steps_per_epoch", "1", "--batch", "4"])
    assert "data: synthetic" in capsys.readouterr().out
    assert np.isfinite(out["train_loss"])


def test_affine_wrapped_layers_main(capsys):
    res = affine_wrapped_layers.main(["--device", "cpu", "--model", "lenet5",
                                      "--iters", "3", "--batch", "8"])
    assert set(res) == {"sgd", "psgd-affine"} and all(np.isfinite(list(res.values())))
    loss = affine_wrapped_layers.main(["--device", "cpu", "--model", "rnn",
                                       "--iters", "3", "--batch", "8",
                                       "--seq_len", "6"])
    assert np.isfinite(loss)
    assert "[rnn/psgd-affine] not solved in 3 iters" in capsys.readouterr().out
    if not torch.cuda.is_available():     # the card unless the CPU is asked for
        with pytest.raises(RuntimeError, match="device='cpu'"):
            affine_wrapped_layers.main(["--iters", "1"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mnist_lenet5.main(["--epochs", "1"])
