"""Structured metrics and profiling (port of ``wavernn_tpu.utils.metrics``):
a JSONL metrics log, a rolling steps/s timer, and ``profile_trace`` on
``torch.profiler``."""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Optional


class MetricsLogger:
    """Append-only JSONL metrics stream: one dict per step/event."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._t0 = time.time()

    def log(self, **fields):
        fields.setdefault("wall", round(time.time() - self._t0, 3))
        with open(self.path, "a") as f:
            f.write(json.dumps(fields) + "\n")


@contextmanager
def profile_trace(log_dir: Optional[str] = None):
    """torch.profiler trace of the CPU and, where there is one, the CUDA
    device around a region, written as a Chrome trace
    (``<log_dir>/trace.json``, chrome://tracing or Perfetto). No-op when
    log_dir is None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


class StepTimer:
    """Rolling steps/sec over the last ``window`` ticks."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times = []

    def tick(self):
        self.times.append(time.perf_counter())
        if len(self.times) > self.window:
            self.times.pop(0)

    @property
    def steps_per_sec(self) -> float:
        if len(self.times) < 2:
            return 0.0
        return (len(self.times) - 1) / (self.times[-1] - self.times[0])
