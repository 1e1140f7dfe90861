"""Stage timing with CUDA events (no synchronisation inside the path)."""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Optional

import torch


@contextmanager
def stage(timings: Optional[dict], name: str, device: torch.device):
    """Record CUDA events around a stage into ``timings[name]``. Does
    nothing when ``timings`` is None or the device is not CUDA."""
    if timings is None or device.type != "cuda":
        yield
        return
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()
    timings.setdefault(name, []).append((start, end))


def elapsed_ms(timings: dict) -> Dict[str, float]:
    """Device milliseconds per stage, summed over its records; call after
    the recorded work has finished (``torch.cuda.synchronize()``)."""
    return {name: sum(s.elapsed_time(e) for s, e in pairs)
            for name, pairs in timings.items()}
