"""Profiling helpers (psgd_torch_tpu_torch.utils.profiling) on the CPU:
``StepTimer`` with the JAX timer's warmup, mean, best and steps_per_sec
(perf_counter here; CUDA events on the card, where the smoke logs its
medians), and ``trace`` writing a Chrome trace."""

import json
import time

import torch

from psgd_torch_tpu_torch.utils import StepTimer, trace


def test_step_timer_discards_warmup():
    timer = StepTimer(warmup=2, device="cpu")
    timer.mark()                       # the first mark starts the clock
    for pause in (0.0, 0.0, 0.02, 0.01):
        time.sleep(pause)
        timer.mark()
    assert len(timer.times) == 2       # four intervals, two of warmup
    assert timer.best >= 0.009 and timer.mean >= timer.best
    assert abs(timer.steps_per_sec() - 1.0 / timer.mean) < 1e-9
    empty = StepTimer(device="cpu")
    assert empty.times == [] and empty.mean == 0.0
    assert empty.best != empty.best   # nan: nothing timed


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in events["traceEvents"])
