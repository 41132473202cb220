"""Profiling helpers (counterpart of psgd_torch_tpu/utils/profiling.py;
the reference times its demos with time.time(), SURVEY.md §5).  The JAX
module's ``collective_bytes`` and ``collective_boundary_bytes`` parse
compiled XLA HLO and come with the distributed port (ROADMAP A8)."""

from __future__ import annotations

import contextlib
import os
import time

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
