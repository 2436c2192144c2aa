"""Profiling and tracing (counterpart of
go_with_the_flows_tpu/utils/profiling.py, on torch.profiler):

  * `trace(logdir)`: a context manager that profiles its body (the host
    and, where there is one, the card) and writes a Chrome trace,
    `<logdir>/trace.json`, which chrome://tracing and Perfetto open;
  * `annotate(name)`: a named range inside an active trace;
  * `StepTimer`: wall-clock step times that wait for the card's queued
    work (synchronize on the watched tensor's device) before stamping.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the body; on exit the card's queued work is waited for and
    the trace written to `<logdir>/trace.json`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named range in an active trace."""
    return torch.profiler.record_function(name)


def _wait(value) -> None:
    if isinstance(value, torch.Tensor) and value.device.type == "cuda":
        torch.cuda.synchronize(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _wait(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _wait(v)


class StepTimer:
    """Per-step timing under asynchronous launches: `stop(x)` with a
    value the step produced waits for the card before stamping."""

    def __init__(self):
        self.times = []
        self._start: Optional[float] = None

    def start(self):
        self._start = time.perf_counter()

    def stop(self, value=None) -> float:
        if value is not None:
            _wait(value)
        dt = time.perf_counter() - (self._start or time.perf_counter())
        self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)
