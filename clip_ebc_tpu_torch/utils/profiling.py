"""Profiling and timing hooks: counterpart of
``clip_ebc_tpu/utils/profiling.py``.

- :func:`trace` records ``torch.profiler`` (CPU and, on a card, CUDA
  activity) and writes a Chrome trace through
  ``tensorboard_trace_handler`` (``{log_dir}/{name}.{time}.pt.trace.json``,
  readable by TensorBoard's profiler plugin or ``chrome://tracing``);
- :func:`annotate` names a region in that trace (``record_function``);
- :class:`StepTimer` measures steady-state step latency, synchronizing
  the device before it reads the clock.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True, worker_name: Optional[str] = None) -> Iterator[None]:
    """Capture a trace of the body into ``log_dir``; a no-op unless
    ``enabled``."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir, worker_name=worker_name)):
        yield


def annotate(name: str):
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock step timing with warm-up discard and a device sync."""

    def __init__(self, warmup_steps: int = 2) -> None:
        self.warmup = warmup_steps
        self.times = []
        self._t0: Optional[float] = None
        self._count = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> None:
        """End a step; the device's queued work (``result``'s, or all of
        it) is waited for first."""
        if isinstance(result, torch.Tensor) and result.is_cuda:
            torch.cuda.synchronize(result.device)
        elif torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)

    def summary(self, items_per_step: int = 1) -> Dict[str, float]:
        if not self.times:
            return {}
        import numpy as np

        t = np.asarray(self.times)
        return {
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p95_s": float(np.percentile(t, 95)),
            "throughput": items_per_step / float(t.mean()),
        }
