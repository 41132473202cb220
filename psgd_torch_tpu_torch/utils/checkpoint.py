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
``optimizer.per_rank``) writes one file per rank,
``path/step_N/state.rank{r}of{k}.pt`` (each renamed into place on its
own).  Beside its state each file holds where the rank's parts sit in the
whole tensors ("pieces": the optimizer's ``_pieces()``, and each DTensor
model entry's block, saved as its local tensor) and the layout of the
unsharded optimizer of the same settings.  Every rank of the world saves
together: rank 0 first clears the step's ``state.pt`` and every rank file
(of any world size) an earlier save left there, so a step directory holds
one save's files only, and a save cut short leaves an incomplete set,
which restoring refuses, never an older state.

Across world sizes (the JAX checkpoint holds global arrays, which restore
into any mesh): ``gather_checkpoint`` turns the k rank files into the
``state.pt`` that the unsharded optimizer (and model) would have written,
offline, with no process group: ``Shard`` parts concatenated where the
pieces say, parts that several ranks hold (``Replicate``) taken once after
checking them bit for bit, the vector-sharded pad rows left out.
``restore_checkpoint`` at a world size whose own file is missing (or holds
another layout) reads that file, gathering it first when it is missing,
and cuts this rank's share: its layers, dim blocks and rows, the pad rows
as a fresh optimizer holds them; when the file must be gathered, the
first rank of the restoring group gathers it while the others wait.  ``load_state_dict`` itself still refuses
a mismatched layout.  The per-shard optimizers plan each shard's Q from
the shard's shape, so their checkpoints restore only at the world size
that wrote them.
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile
from typing import Optional

import torch

_FILE = "state.pt"
_RANK_FILE = re.compile(r"^state\.rank(\d+)of(\d+)\.pt$")
_PER_SHARD = ("a per-shard optimizer's checkpoint restores only at the world "
              "size that wrote it: each shard's Q is planned from the "
              "shard's shape, so it has no unsharded form")


def _core(optimizer):
    """The optimizer itself, or the one a closure class wraps."""
    return getattr(optimizer, "optimizer", optimizer)


def _file(optimizer) -> str:
    """The checkpoint file of this process: one per rank for an optimizer
    whose state is its rank's own."""
    if getattr(_core(optimizer), "per_rank", False):
        import torch.distributed as dist
        return f"state.rank{dist.get_rank()}of{dist.get_world_size()}.pt"
    return _FILE


def _write(directory: str, name: str, payload: dict) -> str:
    """``payload`` saved as ``directory/name``: written under a unique
    temporary name in the same directory, flushed to disk and renamed."""
    fd, tmp = tempfile.mkstemp(prefix=f".{name}.", suffix=".tmp", dir=directory)
    try:
        with os.fdopen(fd, "wb") as fh:
            torch.save(payload, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, os.path.join(directory, name))
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    return os.path.join(directory, name)


def _rank_files(d: str) -> dict:
    """World size -> the ranks whose ``state.rank{r}of{k}.pt`` is in
    ``d``."""
    found = {}
    for f in os.listdir(d) if os.path.isdir(d) else ():
        m = _RANK_FILE.match(f)
        if m:
            found.setdefault(int(m.group(2)), []).append(int(m.group(1)))
    return found


def _clear_step(d: str) -> None:
    """Remove ``d``'s gathered ``state.pt`` and every rank file, of any
    world size."""
    for f in os.listdir(d):
        if f == _FILE or _RANK_FILE.match(f):
            os.remove(os.path.join(d, f))


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _dtensor_index(x) -> list:
    """Where a DTensor's local block sits in its global tensor: [start,
    stop] per dim."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return [[int(o), int(o) + int(n)] for o, n in zip(offset, shape)]


def _model_payload(model) -> tuple:
    """(the model's state dict with each DTensor entry as its local
    tensor, the pieces of those entries)."""
    out, pieces = {}, {}
    for k, v in model.state_dict().items():
        if _is_dtensor(v):
            pieces[(k,)] = {"shape": list(v.shape), "index": _dtensor_index(v)}
            v = v.to_local()
        out[k] = v
    return out, pieces


def save_checkpoint(path: str, step: int, model, optimizer,
                    extra: Optional[dict] = None) -> None:
    """Save the model's and the optimizer's ``state_dict()`` (and
    ``extra``) as ``path/step_{step}``, replacing one that is there.  A
    per-rank optimizer's every rank calls it (it holds two barriers of
    the default group)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, f"step_{step}")
    name = _file(optimizer)
    model_sd, model_pieces = _model_payload(model)
    payload = {"step": step, "model": model_sd,
               "optimizer": optimizer.state_dict(), "extra": extra or {}}
    if name != _FILE:        # one file per rank, each renamed into place
        core = _core(optimizer)
        opt_pieces = core._pieces()
        payload["pieces"] = (None if opt_pieces is None else
                             {"model": model_pieces, "optimizer": opt_pieces})
        payload["unsharded_layout"] = core._unsharded_layout()
        import torch.distributed as dist
        os.makedirs(final, exist_ok=True)
        if dist.get_rank() == 0:
            _clear_step(final)
        dist.barrier()
        _write(final, name, payload)
        dist.barrier()
        return
    tmp = tempfile.mkdtemp(prefix=f".step_{step}.", dir=path)
    try:
        _write(tmp, _FILE, payload)
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


def _step_dir(path: str, step: Optional[int]) -> tuple:
    path = os.path.abspath(path)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    return step, os.path.join(path, f"step_{step}")


# -- gathering --------------------------------------------------------------


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8),
        b.contiguous().reshape(-1).view(torch.uint8)))


def _box(index) -> tuple:
    return tuple(slice(a, b) for a, b in index)


def _volume(index) -> int:
    out = 1
    for a, b in index:
        out *= max(0, b - a)
    return out


def _assemble(where: str, parts: list) -> torch.Tensor:
    """One whole tensor from every rank's (tensor, piece or None).  No
    piece anywhere: the ranks' copies, bit for bit equal.  Otherwise each
    piece's part in its place; pieces that cover the same region must
    agree bit for bit, distinct ones must not overlap, and together they
    must cover the whole."""
    if all(pc is None for _, pc in parts):
        first = parts[0][0]
        for r, (x, _) in enumerate(parts[1:], 1):
            if not _same_bits(x, first):
                raise ValueError(f"{where}: rank {r}'s copy differs from rank "
                                 "0's (a replicated entry drifted)")
        return first
    if any(pc is None for _, pc in parts):
        raise ValueError(f"{where}: some rank files place this entry, others "
                         "hold it whole")
    shapes = {tuple(pc["shape"]) for _, pc in parts}
    if len(shapes) != 1:
        raise ValueError(f"{where}: the ranks disagree on its shape {shapes}")
    whole = torch.empty(shapes.pop(), dtype=parts[0][0].dtype,
                        device=parts[0][0].device)
    seen, covered = {}, 0
    for r, (x, pc) in enumerate(parts):
        index = tuple(tuple(ab) for ab in pc["index"])
        if _volume(index) == 0:
            continue
        part = x[_box(pc.get("local", [[0, n] for n in x.shape]))]
        if index in seen:
            if not _same_bits(part, seen[index]):
                raise ValueError(f"{where}: ranks hold different values for the "
                                 f"same block {list(index)} (drift)")
            continue
        for other in seen:
            if all(max(a, c) < min(b, d) for (a, b), (c, d) in zip(index, other)):
                raise ValueError(f"{where}: blocks {list(index)} and "
                                 f"{list(other)} overlap")
        seen[index] = part
        whole[_box(index)] = part
        covered += _volume(index)
    if covered != whole.numel():
        raise ValueError(f"{where}: the rank files cover {covered} of its "
                         f"{whole.numel()} entries")
    return whole


def _gather_tree(where: str, nodes: list, pieces: list, path: tuple = ()):
    """The unsharded form of a structure that every rank holds (its
    tensors assembled by their pieces, its other values equal on every
    rank)."""
    first = nodes[0]
    label = where + "".join(f"[{k!r}]" for k in path)
    if isinstance(first, torch.Tensor):
        return _assemble(label, [(x, pc.get(path)) for x, pc in zip(nodes, pieces)])
    if isinstance(first, dict):
        if any(not isinstance(n, dict) or set(n) != set(first) for n in nodes):
            raise ValueError(f"{label}: the rank files hold different entries")
        return {k: _gather_tree(where, [n[k] for n in nodes], pieces, path + (k,))
                for k in first}
    if isinstance(first, (tuple, list)):
        if any(len(n) != len(first) for n in nodes):
            raise ValueError(f"{label}: the rank files hold different entries")
        return type(first)(_gather_tree(where, [n[j] for n in nodes], pieces,
                                        path + (j,)) for j in range(len(first)))
    if any(n != first for n in nodes[1:]):
        raise ValueError(f"{label}: the rank files differ ({nodes!r})")
    return first


def gather_checkpoint(path: str, step: Optional[int] = None,
                      device=None) -> str:
    """Turn the rank files of checkpoint ``step`` (default: the latest)
    into its ``state.pt``: the model's and the optimizer's state as the
    unsharded model and optimizer of the same settings would have saved
    them, with that optimizer's layout.  A file operation (no process
    group; one process, any host), its tensors assembled on ``device``
    (default CUDA; ``"cpu"`` on a host without a card): raises ValueError
    unless the files are one complete set ``state.rank{r}of{k}.pt``, r =
    0..k-1, written with their pieces, and their replicated entries agree
    bit for bit; a per-shard optimizer's files raise too.  Returns the
    file's path."""
    from .. import resolve_device
    device = resolve_device(device)
    step, d = _step_dir(path, step)
    k = _complete_set(d)
    saved = [torch.load(os.path.join(d, f"state.rank{r}of{k}.pt"),
                        map_location=device, weights_only=True) for r in range(k)]
    if any(s.get("pieces") is None or s.get("unsharded_layout") is None
           for s in saved):
        raise ValueError(f"{d}: cannot gather: {_PER_SHARD}")
    layout = _gather_tree("unsharded layout",
                          [s["unsharded_layout"] for s in saved], [{}] * k)
    opt = [dict(s["optimizer"], psgd=dict(s["optimizer"]["psgd"], layout=layout))
           for s in saved]
    payload = {
        "step": _gather_tree("step", [s["step"] for s in saved], [{}] * k),
        "model": _gather_tree("model", [s["model"] for s in saved],
                              [s["pieces"]["model"] for s in saved]),
        "optimizer": _gather_tree("optimizer", opt,
                                  [s["pieces"]["optimizer"] for s in saved]),
        "extra": _gather_tree("extra", [s["extra"] for s in saved], [{}] * k)}
    return _write(d, _FILE, payload)


def _complete_set(d: str) -> int:
    """The world size k of ``d``'s rank files; raises unless they are one
    complete set r = 0..k-1."""
    found = _rank_files(d)
    if not found:
        raise FileNotFoundError(f"no rank files in {d}")
    if len(found) != 1:
        raise ValueError(f"{d} holds rank files of world sizes {sorted(found)}")
    (k, ranks), = found.items()
    missing = sorted(set(range(k)) - set(ranks))
    if missing:
        raise ValueError(f"{d}: the rank files are not a complete set: ranks "
                         f"{missing} of {k} are missing")
    return k


# -- restoring --------------------------------------------------------------


def _load_model(model, saved: dict) -> None:
    """``model.load_state_dict``; a model with DTensor entries (FSDP2's)
    takes each saved tensor into its entry's local block."""
    current = model.state_dict()
    if not any(_is_dtensor(v) for v in current.values()):
        model.load_state_dict(saved)
        return
    if sorted(current) != sorted(saved):
        raise ValueError(f"the saved model holds {sorted(saved)}, this one "
                         f"{sorted(current)}")
    with torch.no_grad():
        for k, v in current.items():
            dst = v.to_local() if _is_dtensor(v) else v
            if dst.shape != saved[k].shape:
                raise ValueError(f"model entry {k}: saved {tuple(saved[k].shape)}, "
                                 f"here {tuple(dst.shape)}")
            dst.copy_(saved[k])


def _cut_model(model, whole: dict) -> dict:
    """This rank's blocks of a gathered model state."""
    out = {}
    for k, v in model.state_dict().items():
        if k not in whole:
            raise ValueError(f"model entry {k} is not in the checkpoint")
        out[k] = whole[k][_box(_dtensor_index(v))] if _is_dtensor(v) else whole[k]
    return out


def _at(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _cut_tree(node, live, pieces: dict, path: tuple = ()):
    """A gathered optimizer state cut as ``live`` (this optimizer's own
    ``state_dict()``) holds it: each piece's region of the whole written
    into a copy of this optimizer's tensor (its pad rows kept), in the
    saved dtype; the rest as saved."""
    if isinstance(node, torch.Tensor):
        pc = pieces.get(path)
        if pc is None:
            return node
        mine = _at(live, path)
        out = mine.detach().to(node.dtype, copy=True)
        local = pc.get("local", [[0, n] for n in mine.shape])
        out[_box(local)] = node[_box(pc["index"])].to(out.device)
        return out
    if isinstance(node, dict):
        return {k: _cut_tree(v, live, pieces, path + (k,)) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return type(node)(_cut_tree(v, live, pieces, path + (j,))
                          for j, v in enumerate(node))
    return node


def _cut_optimizer(optimizer, whole: dict) -> dict:
    """This rank's ``state_dict`` from a gathered one; ValueError when the
    gathered layout is not this optimizer's unsharded layout."""
    from ..optim.transforms import _first_mismatch
    core = _core(optimizer)
    want = core._unsharded_layout()
    found = _first_mismatch(whole["psgd"]["layout"], want, "layout")
    if found:
        raise ValueError(f"the gathered checkpoint does not match this "
                         f"{type(core).__name__}: {found}")
    live = core.state_dict()
    out = _cut_tree(whole, live, core._pieces())
    out["psgd"]["layout"] = live["psgd"]["layout"]
    return out


def _gathered(path: str, step: int, d: str, device, group) -> str:
    """``d``'s ``state.pt``, gathered first when it is missing: by the
    first rank of ``group`` (default the world) while the others wait,
    or by this process when there is no process group."""
    whole = os.path.join(d, _FILE)
    if os.path.exists(whole):
        return whole
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return gather_checkpoint(path, step, device)
    # every rank of the group has looked for the file (here and in
    # restore_checkpoint) before the first writes it: a rank that saw it
    # would skip the barrier below and pair with another one
    dist.barrier(group)
    failed = None
    if dist.get_rank(group) == 0:
        try:
            gather_checkpoint(path, step, device)
        except Exception as e:         # the others must not wait forever
            failed = e
    dist.barrier(group)
    if failed is not None:
        raise failed
    if not os.path.exists(whole):
        raise FileNotFoundError(f"{whole}: the group's first rank could not "
                                "gather it")
    return whole


def restore_checkpoint(path: str, model, optimizer,
                       step: Optional[int] = None, group=None):
    """Load checkpoint ``step`` (default: the latest) into ``model`` and
    ``optimizer``; returns (step, extra).  Tensors are read onto the
    model's device; the optimizer's keep the dtypes they were saved with.
    A per-rank optimizer reads its own file when the step holds a
    complete set of this world's rank files in its layout; else it
    restores from the gathered ``state.pt`` and cuts its share.  When
    that file must be gathered, ``group`` (default the world: every rank
    restores) names the ranks that restore together, whose first gathers
    it.  Raises FileNotFoundError when there is no checkpoint, ValueError
    for an incomplete rank set and for a per-shard optimizer at another
    world size."""
    step, d = _step_dir(path, step)
    name = _file(optimizer)
    core = _core(optimizer)
    first = next(iter(model.state_dict().values()))
    device = first.to_local().device if _is_dtensor(first) else first.device
    own = os.path.join(d, name)
    if os.path.exists(own):
        if name != _FILE:
            _complete_set(d)        # this world's, or raises
        saved = torch.load(own, map_location=device, weights_only=True)
        if name == _FILE or saved["optimizer"]["psgd"]["layout"] == core._layout():
            _load_model(model, saved["model"])
            optimizer.load_state_dict(saved["optimizer"])
            return saved["step"], saved["extra"]
    if name != _FILE and core._unsharded_layout() is None:
        raise ValueError(f"{own}: {_PER_SHARD}")
    saved = torch.load(_gathered(path, step, d, device, group),
                       map_location=device, weights_only=True)
    if name == _FILE:
        _load_model(model, saved["model"])
        optimizer.load_state_dict(saved["optimizer"])
    else:
        _load_model(model, _cut_model(model, saved["model"]))
        optimizer.load_state_dict(_cut_optimizer(optimizer, saved["optimizer"]))
    return saved["step"], saved["extra"]
