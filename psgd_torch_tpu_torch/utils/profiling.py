"""Profiling helpers (counterpart of psgd_torch_tpu/utils/profiling.py;
the reference times its demos with time.time(), SURVEY.md §5).

Collective traffic.  The JAX module's ``collective_bytes`` and
``collective_boundary_bytes`` read the collectives of a compiled XLA
program.  The port has no such program: its collectives are calls into
``torch.distributed``, made in ``parallel.mesh`` (``all_gather_stack``,
``MeshAxes``, ``RowReduce``).  Each such call reports itself to every open
``count_collectives()`` window, by its kind in JAX's HLO names
("all-reduce", "all-gather", "all-to-all"), the bytes of its result on
this rank (an all-gather's whole result, as HLO counts it) and the global
ranks of its group.  ``collective_bytes(window)`` and
``collective_boundary_bytes(window, group_of)`` then read a window as the
JAX functions read a program: one step's traffic per rank."""

from __future__ import annotations

import contextlib
import os
import time
from typing import NamedTuple

import torch

from .. import resolve_device


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (the CPU, and CUDA where a card is
    present), written as a Chrome trace to ``log_dir/trace.json``
    (chrome://tracing, Perfetto).  Yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Step timer with warmup discard and simple stats (JAX ``StepTimer``).

    On the card ``start`` and ``mark`` record CUDA events on the current
    stream and do not synchronise; the times are read from the events when
    ``times``, ``mean``, ``best`` or ``steps_per_sec`` is asked for.  On
    the CPU they read ``time.perf_counter``.  ``device``: the card unless
    the caller asks for the CPU.  Times are in seconds."""

    def __init__(self, warmup: int = 2, device=None):
        self.warmup = warmup
        self.device = resolve_device(device)
        self._times = []
        self._pending = []     # (start, end) marks not read yet
        self._t = None
        self._n = 0

    def _now(self):
        if self.device.type != "cuda":
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        return event

    def start(self):
        self._t = self._now()

    def mark(self):
        if self._t is None:
            self.start()
            return
        now = self._now()
        self._n += 1
        if self._n > self.warmup:
            self._pending.append((self._t, now))
        self._t = now

    @property
    def times(self) -> list:
        """The steps after the warmup, in seconds."""
        for a, b in self._pending:
            if isinstance(b, float):
                self._times.append(b - a)
            else:
                b.synchronize()
                self._times.append(a.elapsed_time(b) / 1e3)
        self._pending.clear()
        return self._times

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    @property
    def best(self) -> float:
        return min(self.times) if self.times else float("nan")

    def steps_per_sec(self) -> float:
        m = self.mean
        return 1.0 / m if m > 0 else float("nan")


class CollectiveCall(NamedTuple):
    """One collective: its kind (JAX's HLO name), the bytes of its result
    on this rank, and the global ranks of its group."""
    kind: str
    nbytes: int
    ranks: tuple


_WINDOWS: list = []


@contextlib.contextmanager
def count_collectives():
    """A window that records the port's collectives made inside it (on
    this rank); yields the list it appends ``CollectiveCall``s to.
    Windows nest: a call is recorded in each one open."""
    calls: list = []
    _WINDOWS.append(calls)
    try:
        yield calls
    finally:
        _WINDOWS.remove(calls)


def record_collective(kind: str, result: torch.Tensor, group=None) -> None:
    """Report one collective to the open windows (``parallel.mesh`` calls
    it beside each of its collectives); nothing when none is open."""
    if not _WINDOWS:
        return
    import torch.distributed as dist
    ranks = tuple(dist.get_process_group_ranks(group) if group is not None
                  else range(dist.get_world_size()))
    call = CollectiveCall(kind, result.numel() * result.element_size(), ranks)
    for calls in _WINDOWS:
        calls.append(call)


def collective_bytes(calls, per_op: bool = False):
    """The result bytes of the collectives in a window (JAX
    ``collective_bytes``: the per-device volume of one execution): an int,
    or {kind: bytes} with ``per_op``."""
    out: dict = {}
    for c in calls:
        out[c.kind] = out.get(c.kind, 0) + c.nbytes
    return out if per_op else sum(out.values())


def collective_boundary_bytes(calls, group_of, per_op: bool = False):
    """A window's collective bytes split into {"intra", "cross"} (JAX
    ``collective_boundary_bytes``): ``group_of[r]`` labels global rank r
    (a host, say), and a call is "cross" when its group spans two labels.
    With ``per_op`` {kind: {"intra": b, "cross": b}}."""
    group_of = list(group_of)
    out: dict = {}
    for c in calls:
        side = "cross" if len({group_of[r] for r in c.ranks}) > 1 else "intra"
        entry = out.setdefault(c.kind, {"intra": 0, "cross": 0})
        entry[side] += c.nbytes
    if per_op:
        return out
    return {side: sum(e[side] for e in out.values())
            for side in ("intra", "cross")}
