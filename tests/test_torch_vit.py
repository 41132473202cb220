"""The port's ViT (psgd_torch_tpu_torch.models.vit) and its CIFAR-10 example
against the JAX package's, at dim 64, depth 2, 4 heads: the config and the
layer mask, the patches, the loss and its gradients on carried weights,
two KronWhiten steps over every leaf (the slice as a whole: the blocks'
64-wide factors and head_w's 10, patch_w's 48 and pos_emb's 65 dense), the
synthetic data, training, and the example's main."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import psgd_torch_tpu.optim as jopt
from psgd_torch_tpu.models import vit as jv
from psgd_torch_tpu_torch.examples import vit_cifar10
from psgd_torch_tpu_torch.models import image_data
from psgd_torch_tpu_torch.models import vit as tv
from psgd_torch_tpu_torch.optim import KronWhiten
from test_torch_legacy import FAST_COMPILE, fast_draw

SMALL = dict(dim=64, depth=2, heads=4)


CFGJ = jv.ViTConfig(compute_dtype=jnp.float64, param_dtype=jnp.float64, **SMALL)


@functools.lru_cache(maxsize=None)
def _jax_params() -> dict:
    """JAX's f64 init with a random cls token, head and head bias (init_vit
    zeroes them, and a zero head passes no gradient to the rest), numpy."""
    params = jax.tree_util.tree_map(np.asarray, jv.init_vit(jax.random.PRNGKey(0), CFGJ))
    rng = np.random.default_rng(3)
    for name in ("cls", "head_w", "head_b"):
        params[name] = 0.5 * rng.standard_normal(params[name].shape)
    return params


def carried_pair():
    """(JAX params, JAX config, port model) holding the same f64 weights."""
    params = _jax_params()
    model = tv.ViT(tv.ViTConfig(compute_dtype=torch.float64,
                                param_dtype=torch.float64, **SMALL), device="cpu")
    model.load_state_dict(tv.params_from_jax(params))
    return jax.tree_util.tree_map(jnp.asarray, params), CFGJ, model


def images(seed=0, batch=4, size=32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, size, size, 3)),
            rng.integers(0, 10, (batch,)))


def _names(tree):
    return [".".join(k.key for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_config_and_mask_match_jax():
    """Every field but the dtypes' types, num_patches and patch_dim; the
    parameter names and shapes; the scanned-layers mask."""
    for kw in ({}, SMALL):
        a, b = tv.ViTConfig(**kw), jv.ViTConfig(**kw)
        for f in dataclasses.fields(jv.ViTConfig):
            if not f.name.endswith("dtype"):
                assert getattr(a, f.name) == getattr(b, f.name), f.name
        assert (a.num_patches, a.patch_dim) == (b.num_patches, b.patch_dim)
    assert (tv.ViTConfig().compute_dtype, tv.ViTConfig().param_dtype) == \
        (torch.bfloat16, torch.float32)
    params, _, model = carried_pair()
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert shapes == {".".join(k.key for k in path): tuple(np.shape(v))
                      for path, v in flat}
    jmask = dict(zip(_names(params),
                     jax.tree_util.tree_leaves(jv.scanned_layers_mask(params))))
    assert tv.scanned_layers_mask(model) == jmask
    assert sum(jmask.values()) == 12


def test_patchify_matches_jax():
    x, _ = images(1, batch=3)
    for p in (4, 8):
        np.testing.assert_array_equal(
            tv._patchify(torch.from_numpy(x), p).numpy(),
            np.asarray(jv._patchify(jnp.asarray(x), p)))


def test_loss_and_gradients_match_jax():
    """f64 compute on both sides.  JAX's attention takes its softmax in
    float32 and both sides' logits are float32, so the loss and each
    gradient leaf agree at rtol 1e-5 (atol 1e-5 x the leaf's largest
    entry), the tolerance of test_torch_gpt2.py."""
    params, cfgj, model = carried_pair()
    x, y = images()
    lj, gj = jax.value_and_grad(jv.loss_vit)(params, jnp.asarray(x),
                                             jnp.asarray(y), cfgj)
    lt = tv.loss_vit(model, torch.from_numpy(x), torch.from_numpy(y))
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    grads = dict(model.named_parameters())
    flat = jax.tree_util.tree_flatten_with_path(gj)[0]
    assert len(flat) == len(grads) == 20
    for path, g in flat:
        name = ".".join(k.key for k in path)
        ref = np.asarray(g)
        assert np.abs(ref).max() > 0, name
        np.testing.assert_allclose(grads[name].grad.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=name)
    logits = model(torch.from_numpy(x))
    assert logits.dtype == torch.float32 and logits.shape == (4, 10)


def test_two_kron_whiten_steps_match_jax():
    """The example's KronWhiten (momentum 0.9, max_skew 2, the layer mask,
    the on-the-fly init scale) over every ViT leaf, f64 parameters and Q,
    the JAX draws replayed (``fast_draw``; the JAX programs compiled with
    ``FAST_COMPILE``), both sides fed JAX's gradients at the JAX
    parameters (the models' own gradients differ by JAX's float32
    softmax): parameters, Q and L at rtol 1e-9.  The amplitude clip is set
    where it cannot act (both sides take its RMS in float32)."""
    kw = dict(momentum=0.9, preconditioner_max_skew=2.0,
              grad_clip_max_amps=(1e3, 1e3))
    params, cfgj, model = carried_pair()
    x, y = images(2, batch=8)
    grad = jax.jit(jax.grad(lambda p: jv.loss_vit(p, jnp.asarray(x),
                                                  jnp.asarray(y), cfgj)),
                   compiler_options=FAST_COMPILE)
    jo = jopt.kron_whiten(learning_rate=1e-3,
                          scanned_layers=jv.scanned_layers_mask(params), **kw)
    state = jo.init(params)
    update = jax.jit(jo.update, compiler_options=FAST_COMPILE)
    to = KronWhiten(model.named_parameters(), lr=1e-3, device="cpu",
                    scanned_layers=tv.scanned_layers_mask(model), draw=fast_draw,
                    **kw)
    got = dict(model.named_parameters())
    for _ in range(2):
        g = grad(params)
        for path, leaf in jax.tree_util.tree_flatten_with_path(g)[0]:
            got[".".join(k.key for k in path)].grad = torch.from_numpy(
                np.array(leaf))
        to.step()
        upd, state = update(g, state, params)
        params = optax.apply_updates(params, upd)
    assert to.fit_steps == 2
    precond = [s for s in state if hasattr(s, "precond")][0].precond
    dense = set()
    for (path, ref), st in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                               precond):
        name = ".".join(k.key for k in path)
        p, ref = got[name], np.asarray(ref)
        np.testing.assert_allclose(p.detach().numpy(), ref, rtol=1e-9,
                                   atol=1e-9 * np.abs(ref).max(), err_msg=name)
        for a, b in zip(to.state[p]["q"], st.q):
            b = np.asarray(b)
            if b.ndim >= 2 and b.shape[-1] == b.shape[-2]:
                dense.add(b.shape[-1])
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-9,
                                       atol=1e-9 * np.abs(b).max(), err_msg=name)
        for a, b in zip(to.state[p]["lips"], st.lips):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                       err_msg=name)
    assert {10, 48, 64, 65} <= dense


def test_synthetic_cifar():
    """Shapes, labels in range, NHWC float32, the same data for the same
    seed, and class templates under the noise (a class's mean image is
    nearer its own template than another's)."""
    a = tv.synthetic_cifar(torch.Generator().manual_seed(0), 400, device="cpu")
    b = tv.synthetic_cifar(torch.Generator().manual_seed(0), 400, device="cpu")
    c = tv.synthetic_cifar(torch.Generator().manual_seed(1), 400, device="cpu")
    x, y = a
    assert x.shape == (400, 32, 32, 3) and x.dtype == torch.float32
    assert y.shape == (400,) and y.dtype == torch.int64
    assert int(y.min()) >= 0 and int(y.max()) <= 9
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    means = torch.stack([x[y == k].mean(0) for k in range(10)])
    dist = ((means[:, None] - means[None]) ** 2).mean((2, 3, 4))
    noise = 0.7 ** 2 * 10 / 400     # about a class mean's noise variance
    assert float(dist.diagonal().max()) == 0.0
    assert float(dist[~torch.eye(10, dtype=torch.bool)].min()) > 10 * noise


def test_vit_tiny_trains():
    """tests/test_models_e2e.py::test_vit_tiny_trains on the port: the small
    ViT in f32 by KronWhiten (lr 3e-3, momentum 0.9, max_skew 2), 80 steps
    of fresh synthetic batches of 32; the last loss below half the first."""
    cfg = tv.ViTConfig(compute_dtype=torch.float32, **SMALL)
    model = tv.ViT(cfg, device="cpu", seed=5)
    opt = KronWhiten(model.named_parameters(), lr=3e-3, momentum=0.9,
                     preconditioner_max_skew=2.0, device="cpu",
                     scanned_layers=tv.scanned_layers_mask(model))
    gen = torch.Generator().manual_seed(100)
    losses = []
    for _ in range(80):
        x, y = tv.synthetic_cifar(gen, 32, device="cpu")
        opt.zero_grad()
        loss = tv.loss_vit(model, x, y)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert losses[-1] < 0.5 * losses[0], f"ViT: {losses[0]} -> {losses[-1]}"


def test_vit_cifar10_main(capsys, monkeypatch):
    """The example on the CPU at 1 epoch x 2 steps x batch 8, with the
    digits and without scikit-learn; without a card and without --device
    it raises."""
    arms = ("adam", "psgd-kron(Q0.5EQ1.5)")
    argv = ["--device", "cpu", "--epochs", "1", "--steps_per_epoch", "2",
            "--batch", "8"]
    out = vit_cifar10.main(argv)
    printed = capsys.readouterr().out
    assert "data: real UCI digits" in printed or "data: synthetic" in printed
    assert tuple(out) == arms
    for res in out.values():
        assert np.isfinite(res["train_loss"]) and 0.0 <= res["test_acc"] <= 1.0
        assert len(res["epoch_losses"]) == 1 and res["step_ms"] > 0
        assert np.isfinite(res["first_loss"])
    assert out["adam"]["fit_steps"] is None
    assert out[arms[1]]["fit_steps"] == 2

    def missing(*args, **kwargs):
        raise ImportError("no sklearn")

    monkeypatch.setattr(image_data, "load_digits_split", missing)
    out = vit_cifar10.main(argv)
    assert "data: synthetic" in capsys.readouterr().out
    assert all(np.isfinite(r["train_loss"]) for r in out.values())
    if not torch.cuda.is_available():     # the card unless the CPU is asked for
        with pytest.raises(RuntimeError, match="device='cpu'"):
            vit_cifar10.main(["--epochs", "1"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tv.ViT(tv.ViTConfig(**SMALL))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tv.synthetic_cifar(torch.Generator(), 2)
