"""Failure detection and rollback (psgd_torch_tpu_torch.utils.failsafe),
mirroring tests/test_failsafe.py's five tests on the port's optimizers,
plus: ``finite_check`` agrees with JAX's on the same arrays (complex and
integer leaves included), a rollback restores the model and the optimizer
bit for bit, a non-finite update from the preconditioner is caught, and
``lr_scale`` scales the update."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from psgd_torch_tpu.utils.failsafe import finite_check as jax_finite_check
from psgd_torch_tpu_torch.optim import KronWhiten
from psgd_torch_tpu_torch.utils import checkpoint as ckpt
from psgd_torch_tpu_torch.utils.failsafe import (FailsafeLoop, finite_check,
                                                 make_guarded_step)
from test_torch_state_dict import assert_same


class Vector(nn.Module):
    def __init__(self, init):
        super().__init__()
        self.w = nn.Parameter(torch.as_tensor(init, dtype=torch.float32))


def kron(model, lr):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return KronWhiten(model.named_parameters(), lr=lr,
                          preconditioner_init_scale=1.0, device="cpu")


CASES = {
    "finite": [np.ones(3), np.arange(4)],
    "nan": [np.array([1.0, np.nan])],
    "inf": [np.array([np.inf])],
    "complex-nan": [np.array([1 + 1j * np.nan], np.complex64)],
    "complex-inf": [np.array([np.inf + 1j], np.complex128)],
    "complex-finite": [np.array([1 + 2j], np.complex64)],
    "integer-and-scalar": [np.arange(3), np.zeros(())],
    "bool": [np.array([True, False])],
    "none": [],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_finite_check(case):
    """The port's finite_check agrees with JAX's on the same arrays."""
    arrays = CASES[case]
    ours = finite_check([torch.from_numpy(a) for a in arrays])
    ref = jax_finite_check([jnp.asarray(a) for a in arrays])
    assert ours.dtype == torch.bool and ours.ndim == 0
    assert bool(ours) == bool(ref)


def test_finite_check_nested():
    assert bool(finite_check({"a": torch.ones(3), "b": (torch.arange(4),)}))
    assert not bool(finite_check({"a": [torch.tensor([1.0, float("nan")])]}))


def test_failsafe_rolls_back_and_recovers():
    """A loss that blows up at one step: the loop rolls back to the last
    good snapshot, shrinks the lr scale, and keeps training."""
    def loss_fn(model, poison):
        base = 0.5 * torch.sum((model.w - 1.0) ** 2)
        return base + (float("nan") if poison else 0.0)

    model = Vector(np.zeros(8))
    opt = kron(model, 0.3)
    loop = FailsafeLoop(make_guarded_step(opt, loss_fn), model, opt,
                        snapshot_every=5)
    failed = 0
    for i in range(25):
        loss = loop.run_step(i == 10)
        if loss is None:
            failed += 1
            assert loop.step % 5 == 0
        else:
            assert loss == loss and abs(loss) != float("inf")
    assert failed == 1
    assert loop.lr_scale < 1.0
    final = float(0.5 * torch.sum((model.w.detach() - 1.0) ** 2))
    assert final < 0.05, final


def test_failsafe_gives_up_after_max_rollbacks():
    model = Vector(np.zeros(4))
    opt = kron(model, 0.1)
    loop = FailsafeLoop(make_guarded_step(opt, lambda m: float("nan") * m.w.sum()),
                        model, opt, max_rollbacks=3)
    with pytest.raises(RuntimeError, match="consecutive failed"):
        for _ in range(10):
            loop.run_step()


def test_failsafe_checkpoint_integration(tmp_path):
    """With checkpoint_dir set, snapshots also land on disk."""
    model = Vector(np.ones(4))
    opt = kron(model, 0.1)
    loop = FailsafeLoop(make_guarded_step(opt, lambda m: 0.5 * torch.sum(m.w ** 2)),
                        model, opt, snapshot_every=3, checkpoint_dir=str(tmp_path))
    for _ in range(7):
        loop.run_step()
    assert ckpt.latest_step(str(tmp_path)) == 6


def test_snapshot_preserves_key_and_bool_leaves():
    """The snapshot copies the optimizer's key (int64) and a model's bool
    and integer buffers dtype-faithfully, and a rollback restores the
    model and the optimizer bit for bit."""
    model = Vector(np.ones(3))
    model.register_buffer("flag", torch.tensor([True, False]))
    model.register_buffer("seen", torch.arange(3))
    opt = kron(model, 0.1)
    state = {"poison": False}

    def loss_fn(m):
        return torch.sum(m.w ** 2) * (float("inf") if state["poison"] else 1.0)

    loop = FailsafeLoop(make_guarded_step(opt, loss_fn), model, opt,
                        snapshot_every=2)
    for _ in range(2):
        assert loop.run_step() is not None
    snap = loop._good
    assert snap.step == 2 and snap.optimizer["psgd"]["key"].dtype == torch.int64
    assert snap.model["flag"].dtype == torch.bool
    assert snap.model["seen"].dtype == torch.int64
    assert np.array_equal(snap.optimizer["psgd"]["key"].numpy(), opt.key)
    good_model = {k: v.clone() for k, v in model.state_dict().items()}
    good_opt = deep_copy(opt.state_dict())
    assert loop.run_step() is not None          # step 3, no snapshot
    state["poison"] = True
    assert loop.run_step() is None              # rolled back to step 2
    assert loop.step == 2 and loop.lr_scale == 0.5
    assert_same(good_model, model.state_dict())
    assert_same(good_opt, opt.state_dict())


def deep_copy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: deep_copy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(deep_copy(v) for v in tree)
    return tree


def test_guarded_step_catches_a_preconditioner_blow_up():
    """A finite loss and gradient, but Q holds a NaN: the update is not
    finite, so the step reports unhealthy."""
    model = Vector(np.ones(4))
    opt = kron(model, 0.1)
    step = make_guarded_step(opt, lambda m: torch.sum(m.w ** 2))
    loss, healthy = step(model, opt, 1.0)
    assert bool(healthy) and torch.isfinite(loss)
    st = opt.state[model.w]
    st["q"] = tuple(torch.full_like(q, float("nan")) for q in st["q"])
    loss, healthy = step(model, opt, 1.0)
    assert torch.isfinite(loss) and not bool(healthy)


def test_guarded_step_scales_the_update():
    """At lr_scale 0.5 the parameters move by half of what the same step
    at lr_scale 1 moves them (whatever lr the optimizer holds, a schedule
    here)."""
    moves = []
    for scale in (1.0, 0.5):
        model = Vector(np.linspace(-1.0, 1.0, 6))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            opt = KronWhiten(model.named_parameters(), lr=lambda c: 0.1,
                             preconditioner_init_scale=1.0, device="cpu")
        before = model.w.detach().clone()
        make_guarded_step(opt, lambda m: torch.sum(m.w ** 4))(model, opt, scale)
        moves.append(model.w.detach() - before)
    torch.testing.assert_close(moves[1], 0.5 * moves[0], rtol=1e-6, atol=1e-7)


def test_guarded_step_refuses_another_optimizer():
    model = Vector(np.ones(2))
    opt, other = kron(model, 0.1), kron(model, 0.1)
    with pytest.raises(ValueError):
        make_guarded_step(opt, lambda m: m.w.sum())(model, other, 1.0)
