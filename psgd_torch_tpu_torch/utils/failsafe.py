"""Failure detection and rollback for PSGD training loops (counterpart of
psgd_torch_tpu/utils/failsafe.py; the reference has neither, SURVEY.md
§5).

* ``finite_check(tensors)``: one 0-dim bool tensor on the device, True iff
  every floating or complex tensor is finite; no host sync.
* ``FailsafeLoop``: runs a step, reads its health, and on failure rolls
  the model and the optimizer back to the last good snapshot (a device
  copy of both ``state_dict()``s) and backs the lr scale off.
* ``make_guarded_step``: such a step from an optimizer and a loss.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def finite_check(tensors: Any) -> torch.Tensor:
    """0-dim bool: every tensor of ``tensors`` (a tensor, or nested dicts,
    lists and tuples of them) is finite.  Complex tensors are checked on
    both parts; integer and bool tensors pass."""
    ok = None
    for x in _leaves(tensors):
        if not (x.is_floating_point() or x.is_complex()):
            continue
        leaf = torch.isfinite(x).all()
        ok = leaf if ok is None else ok & leaf
    return torch.tensor(True) if ok is None else ok


def _copy(tree):
    """A deep copy of a state_dict: every tensor cloned on its device."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_copy(v) for v in tree)
    return tree


class FailsafeState(NamedTuple):
    """The last known-good training state."""
    step: int
    model: dict
    optimizer: dict
    lr_scale: float


class FailsafeLoop:
    """Rollback-on-failure loop around a training step.

    ``step_fn(model, optimizer, lr_scale, *batch) -> (loss, healthy)``
    steps the model and the optimizer in place; ``healthy`` is a 0-dim bool
    (e.g. ``finite_check`` of the loss and the update).  The loop
    snapshots both ``state_dict()``s every ``snapshot_every`` steps (and
    saves a checkpoint there when ``checkpoint_dir`` is set); when a step
    reports unhealthy, or a non-finite loss, it loads the snapshot back and
    multiplies the lr scale by ``lr_backoff``.

    >>> loop = FailsafeLoop(step_fn, model, optimizer)
    >>> for batch in data:
    ...     loss = loop.run_step(*batch)
    """

    def __init__(self, step_fn: Callable, model, optimizer,
                 snapshot_every: int = 100, lr_backoff: float = 0.5,
                 max_rollbacks: int = 10,
                 checkpoint_dir: Optional[str] = None):
        self._step_fn = step_fn
        self.model = model
        self.optimizer = optimizer
        self.step = 0
        self.lr_scale = 1.0
        self.snapshot_every = snapshot_every
        self.lr_backoff = lr_backoff
        self.max_rollbacks = max_rollbacks
        self.rollbacks = 0
        self.checkpoint_dir = checkpoint_dir
        self._good = self._snapshot()

    def _snapshot(self) -> FailsafeState:
        if self.checkpoint_dir is not None:
            from . import checkpoint
            checkpoint.save_checkpoint(self.checkpoint_dir, self.step,
                                       self.model, self.optimizer)
        return FailsafeState(self.step, _copy(self.model.state_dict()),
                             _copy(self.optimizer.state_dict()),
                             self.lr_scale)

    def run_step(self, *batch):
        """One guarded step.

        Returns the loss (a float) on success, or None when the step was
        unhealthy: then the model and the optimizer are back at the last
        good snapshot and the lr scale is shrunk; the caller goes on with
        its next batch.  Raises RuntimeError after ``max_rollbacks``
        failures in a row."""
        loss, healthy = self._step_fn(self.model, self.optimizer,
                                      self.lr_scale, *batch)
        loss_f = float(loss)
        ok = bool(healthy) and loss_f == loss_f and abs(loss_f) != float("inf")
        if ok:
            self.step += 1
            self.rollbacks = 0
            if self.step % self.snapshot_every == 0:
                self._good = self._snapshot()
            return loss_f
        self.rollbacks += 1
        if self.rollbacks > self.max_rollbacks:
            raise RuntimeError(
                f"step {self.step}: {self.rollbacks} consecutive failed "
                f"steps; giving up (last loss {loss_f})")
        self.lr_scale *= self.lr_backoff
        self.model.load_state_dict(self._good.model)
        self.optimizer.load_state_dict(self._good.optimizer)
        self.step = self._good.step
        return None


def make_guarded_step(optimizer, loss_fn: Callable) -> Callable:
    """A ``FailsafeLoop`` step from ``optimizer`` and ``loss_fn(model,
    *batch)``: backward and ``optimizer.step()`` (a closure optimizer, one
    with ``step(closure)``, takes the loss as its closure), then the update
    u = new - old parameters; health is finite(loss) and finite(u), so a
    non-finite update is caught whether it came from the gradient or from
    the preconditioner.  The update is scaled by ``lr_scale``: the
    parameters become old + lr_scale u (left as stepped at lr_scale 1),
    whatever ``lr`` (a float or a schedule) the optimizer holds."""
    from ..optim.transforms import KronNewton, _FlatNewton
    core = getattr(optimizer, "optimizer", optimizer)   # a closure class
    takes_closure = core is not optimizer or isinstance(
        core, (KronNewton, _FlatNewton))

    def step(model, opt, lr_scale: float, *batch):
        if opt is not optimizer:
            raise ValueError("the step was made for another optimizer")
        params = [p for g in core.param_groups for p in g["params"]]
        old = [p.detach().clone() for p in params]
        if takes_closure:
            loss = optimizer.step(lambda: loss_fn(model, *batch))
        else:
            optimizer.zero_grad(set_to_none=True)
            with torch.enable_grad():
                loss = loss_fn(model, *batch)
                loss.backward()
            optimizer.step()
        with torch.no_grad():
            updates = [p - o for p, o in zip(params, old)]
            healthy = finite_check(updates) & torch.isfinite(loss.detach())
            if lr_scale != 1.0:
                for p, o, u in zip(params, old, updates):
                    p.copy_(o + u * lr_scale)
        return loss.detach(), healthy

    return step
