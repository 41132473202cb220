"""The port's GPT-2 trainer (python -m
psgd_torch_tpu_torch.examples.train_gpt2) on the CPU: ``main`` for 3
steps by PSGD and by AdamW, on the corpus and on the synthetic stream,
with finite losses; its recipe is the JAX example's (examples/
train_gpt2.py), the update probability's schedule optax's
linear_schedule.  ``main`` runs ``--model tiny`` at a narrower width here
(2 layers of 64, vocab 512): the tiny model's 50304 x 384 embedding
makes each fit draw 19M noise values through the plain Philox version,
seconds per step on a loaded CPU; ``make_config`` is held apart."""

import math
import warnings

import optax
import pytest
import torch

from psgd_torch_tpu_torch.examples import train_gpt2
from psgd_torch_tpu_torch.models import gpt2


NARROW = gpt2.tiny_config(n_layer=2, n_head=2, n_embd=64, block_size=32,
                          vocab_size=512, compute_dtype=torch.float32)


@pytest.mark.parametrize("data", ["corpus", "synthetic"])
@pytest.mark.parametrize("opt", ["psgd", "adamw"])
def test_main_trains_on_the_cpu(opt, data, capsys, monkeypatch):
    asked = []
    monkeypatch.setattr(train_gpt2, "make_config",
                        lambda model, device: asked.append((model, device)) or NARROW)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        losses = train_gpt2.main(["--model", "tiny", "--steps", "3", "--device",
                                  "cpu", "--batch", "1", "--opt", opt,
                                  "--data", data])
    assert asked == [("tiny", torch.device("cpu"))]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    out = capsys.readouterr().out
    assert "step     2" in out and "device cpu" in out
    assert ("corpus:" in out) == (data == "corpus")


def test_make_config():
    """The JAX example's models: tiny (f32 compute on the CPU) and 124M."""
    cpu = torch.device("cpu")
    assert train_gpt2.make_config("tiny", cpu) == gpt2.tiny_config(
        compute_dtype=torch.float32)
    assert train_gpt2.make_config("124m", cpu) == gpt2.gpt2_124m()


@pytest.mark.parametrize("steps", [1, 8, 300])
def test_linear_schedule_is_optax(steps):
    ours = train_gpt2.linear_schedule(1.0, 0.1, max(steps // 2, 1))
    ref = optax.linear_schedule(1.0, 0.1, max(steps // 2, 1))
    for count in range(steps + 3):
        assert ours(count) == pytest.approx(float(ref(count)), rel=1e-6)


def test_psgd_recipe():
    """The JAX example's PSGD settings on the CPU: lr 1e-3/4, momentum 0.9
    whitened, max_skew 2, init scale 1, wd 0.01, norm_k 32, the
    parameters' dtype for Q and momentum, one preconditioner per layer."""
    cfg = gpt2.tiny_config(n_layer=2, n_head=2, n_embd=32, block_size=16,
                           vocab_size=64)
    model = gpt2.GPT2(cfg, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        opt = train_gpt2.psgd_optimizer(model, 8, torch.device("cpu"))
    group = opt.param_groups[0]
    assert group["lr"] == 1e-3 / 4 and group["weight_decay"] == 0.01
    assert opt.momentum == 0.9 and not opt.whiten_grad and opt.norm_k == 32
    assert opt.init_scale == 1.0
    assert group["preconditioner_update_probability"](4) == pytest.approx(0.1)
    assert sum(opt.scanned) == len(model.blocks)
    assert {st["q"][0].dtype for st in opt.state.values()} == {torch.float32}
    adamw = train_gpt2.adamw_optimizer(model)
    assert adamw.defaults["betas"] == (0.9, 0.95) and adamw.defaults["lr"] == 1e-3
