"""Checkpoint and resume for PSGD training (counterpart of
psgd_torch_tpu/utils/checkpoint.py).  The reference cannot checkpoint its
optimizer state at all (SURVEY.md §5); the port's optimizers carry their
whole state through ``state_dict()``, so one ``torch.save`` holds a run.

A checkpoint is ``path/step_N/state.pt``: {"step", "model", "optimizer",
"extra"}, written under a temporary name, flushed to disk and renamed, so
a crash leaves no half checkpoint (the JAX version is atomic through
orbax).  ``restore_checkpoint`` reads it with ``weights_only=True``.

An optimizer whose state is its rank's own (``stack_sharding``,
``factor_sharding``, ``vector_sharding``, the per-shard optimizers:
``optimizer.per_rank``)
writes one file per rank,
``path/step_N/state.rank{r}of{k}.pt`` (each renamed into place on its
own), and each rank restores its own; gathering a whole checkpoint onto
one rank is not ported (ROADMAP A8b).
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional

import torch

_FILE = "state.pt"


def _file(optimizer) -> str:
    """The checkpoint file of this process: one per rank for an optimizer
    whose state is its rank's own."""
    if getattr(getattr(optimizer, "optimizer", optimizer), "per_rank", False):
        import torch.distributed as dist
        return f"state.rank{dist.get_rank()}of{dist.get_world_size()}.pt"
    return _FILE


def _write(path: str, payload: dict) -> None:
    with open(path, "wb") as fh:
        torch.save(payload, fh)
        fh.flush()
        os.fsync(fh.fileno())


def save_checkpoint(path: str, step: int, model, optimizer,
                    extra: Optional[dict] = None) -> None:
    """Save the model's and the optimizer's ``state_dict()`` (and
    ``extra``) as ``path/step_{step}``, replacing one that is there."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, f"step_{step}")
    payload = {"step": step, "model": model.state_dict(),
               "optimizer": optimizer.state_dict(), "extra": extra or {}}
    name = _file(optimizer)
    if name != _FILE:        # one file per rank, each renamed into place
        os.makedirs(final, exist_ok=True)
        tmp = os.path.join(final, f".{name}.{os.getpid()}.tmp")
        _write(tmp, payload)
        os.replace(tmp, os.path.join(final, name))
        return
    tmp = tempfile.mkdtemp(prefix=f".step_{step}.", dir=path)
    try:
        _write(os.path.join(tmp, _FILE), payload)
        if os.path.isdir(final):
            old = tempfile.mkdtemp(prefix=f".old_step_{step}.", dir=path)
            os.replace(final, os.path.join(old, "replaced"))
            os.replace(tmp, final)
            shutil.rmtree(old)
        else:
            os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def latest_step(path: str) -> Optional[int]:
    """The largest N of the ``step_N`` checkpoints under ``path``, or None
    (no such directory, or no checkpoint in it)."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_", 1)[1]) for d in os.listdir(path)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore_checkpoint(path: str, model, optimizer,
                       step: Optional[int] = None):
    """Load checkpoint ``step`` (default: the latest) into ``model`` and
    ``optimizer``; returns (step, extra).  Tensors are read onto the
    model's device; the optimizer's keep the dtypes they were saved with.
    Raises FileNotFoundError when there is no checkpoint."""
    path = os.path.abspath(path)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    device = next(iter(model.state_dict().values())).device
    saved = torch.load(os.path.join(path, f"step_{step}", _file(optimizer)),
                       map_location=device, weights_only=True)
    model.load_state_dict(saved["model"])
    optimizer.load_state_dict(saved["optimizer"])
    return saved["step"], saved["extra"]
