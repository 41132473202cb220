"""Utilities for training with the port's optimizers (counterpart of
psgd_torch_tpu/utils): checkpoint and resume, failure detection and
rollback, optimizer-health metrics and state memory, profiling."""

from .checkpoint import (gather_checkpoint, latest_step, restore_checkpoint,
                         save_checkpoint)
from .failsafe import FailsafeLoop, finite_check, make_guarded_step
from .metrics import psgd_metrics, state_memory_report
from .profiling import (StepTimer, collective_boundary_bytes,
                        collective_bytes, count_collectives, trace)

__all__ = ["FailsafeLoop", "StepTimer", "collective_boundary_bytes",
           "collective_bytes", "count_collectives", "finite_check",
           "gather_checkpoint",
           "latest_step", "make_guarded_step", "psgd_metrics",
           "restore_checkpoint", "save_checkpoint", "state_memory_report",
           "trace"]
