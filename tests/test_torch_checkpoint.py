"""Checkpoint and resume (psgd_torch_tpu_torch.utils.checkpoint), after
tests/test_checkpoint.py: a tiny GPT-2 on the CPU trained by the
trainer's PSGD recipe, saved mid-run, restored into a fresh model and
optimizer, continued, and bitwise equal with the unbroken run (parameters
and the whole optimizer state).  Also ``latest_step`` and the failures:
FileNotFoundError without a checkpoint, no partial directory left behind
by a failed save."""

import os
import warnings

import pytest
import torch

from psgd_torch_tpu_torch.examples import train_gpt2
from psgd_torch_tpu_torch.models import gpt2
from psgd_torch_tpu_torch.utils import checkpoint as ckpt
from test_torch_state_dict import assert_same

CPU = torch.device("cpu")
STEPS = 6


def setup(seed=0):
    cfg = gpt2.tiny_config(n_layer=2, n_head=2, n_embd=32, block_size=16,
                           vocab_size=64, compute_dtype=torch.float32)
    model = gpt2.GPT2(cfg, device=CPU, seed=seed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        opt = train_gpt2.psgd_optimizer(model, STEPS, CPU, seed=1)
    return cfg, model, opt


def train(cfg, model, opt, start, stop):
    for i in range(start, stop):
        x, y = gpt2.synthetic_lm_batch(torch.Generator().manual_seed(100 + i),
                                       2, cfg.block_size, cfg.vocab_size,
                                       device=CPU)
        opt.zero_grad(set_to_none=True)
        gpt2.loss_gpt2(model, x, y).backward()
        opt.step()


def test_restore_and_continue(tmp_path):
    """3 steps -> save -> restore into a fresh model and optimizer -> 3
    more steps: bitwise equal with 6 unbroken steps.  The recipe's gate
    (seed 1, p from 1.0 to 0.1 over 3 steps) fits on both sides."""
    cfg, model, opt = setup()
    train(cfg, model, opt, 0, 3)
    ckpt.save_checkpoint(str(tmp_path / "ck"), 3, model, opt,
                         extra={"data_step": 3})
    train(cfg, model, opt, 3, STEPS)

    _, model2, opt2 = setup(seed=5)        # other weights, fresh state
    step, extra = ckpt.restore_checkpoint(str(tmp_path / "ck"), model2, opt2)
    assert step == 3 and extra == {"data_step": 3}
    assert opt2.count == 3
    train(cfg, model2, opt2, 3, STEPS)
    for (n, a), (_, b) in zip(model.named_parameters(), model2.named_parameters()):
        assert torch.equal(a, b), n
    assert_same(opt.state_dict(), opt2.state_dict())
    assert 0 < opt.fit_steps < STEPS


def test_latest_step(tmp_path):
    cfg, model, opt = setup()
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    (tmp_path / "empty").mkdir()
    assert ckpt.latest_step(str(tmp_path / "empty")) is None
    for step in (1, 7, 3):
        ckpt.save_checkpoint(str(tmp_path / "ck2"), step, model, opt)
    assert ckpt.latest_step(str(tmp_path / "ck2")) == 7
    ckpt.save_checkpoint(str(tmp_path / "ck2"), 7, model, opt)   # replaced
    assert sorted(os.listdir(tmp_path / "ck2")) == ["step_1", "step_3", "step_7"]
    assert ckpt.restore_checkpoint(str(tmp_path / "ck2"), model, opt, step=3)[0] == 3


def test_restore_without_checkpoint_raises(tmp_path):
    cfg, model, opt = setup()
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"), model, opt)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "empty"), model, opt)


def test_failed_save_leaves_no_partial_checkpoint(tmp_path, monkeypatch):
    """A save that fails while writing leaves neither ``step_N`` nor its
    temporary directory, and an earlier checkpoint stays readable."""
    cfg, model, opt = setup()
    path = str(tmp_path / "ck")
    ckpt.save_checkpoint(path, 1, model, opt)
    real_save = torch.save

    def half_save(obj, fh):
        fh.write(b"half a checkpoint")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", half_save)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save_checkpoint(path, 2, model, opt)
    monkeypatch.setattr(torch, "save", real_save)
    assert os.listdir(path) == ["step_1"]
    assert ckpt.latest_step(path) == 1
    assert ckpt.restore_checkpoint(path, model, opt)[0] == 1
