"""The traced run's reduction of a ``torch.profiler`` trace of the window:
device busy time (the union of every device operation's interval), device
seconds by kernel name, the longest idle gaps labelled by the host
operation that overlapped each most, and the top device operations.
"""
from __future__ import annotations

from contextlib import contextmanager

import numpy as np


@contextmanager
def profiled(device_type: str):
    """A torch.profiler over the block (host and, on a card, device
    activity); yields a holder whose ``prof`` is set once it has closed."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    holder = type("Holder", (), {"prof": None})()
    with profile(activities=acts) as prof:
        yield holder
        if device_type == "cuda":
            torch.cuda.synchronize()
    holder.prof = prof


def _annotation(e) -> bool:
    """A user annotation (``record_function``) mirrored on the device's
    timeline: it spans device work and idle time alike, and is no
    operation."""
    f = getattr(e, "is_user_annotation", None)
    if f is not None and f():
        return True
    f = getattr(e, "activity_type", None)
    return f is not None and "annotation" in str(f()).lower()


def _events(prof):
    """(device ops, host ops) as (start_us, end_us, name) from the raw
    Kineto events, without building the profiler's event tree."""
    import torch
    dev, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda and _annotation(e):
            continue
        s = e.start_ns() / 1e3
        end = s + e.duration_ns() / 1e3
        (dev if e.device_type() == cuda else host).append((s, end, e.name()))
    return dev, host


def reduce(prof, window_s: float, top: int = 10) -> dict:
    """{busy_s, kernels {name: s}, breakdown {device_ops, idle_gaps}}."""
    dev, host = _events(prof)
    dev.sort()
    busy, end, spans = 0.0, None, []
    for s, e, _ in dev:
        if end is None or s > end:
            spans.append([s, e])
        else:
            spans[-1][1] = max(spans[-1][1], e)
        end = e if end is None else max(end, e)
    busy = sum(e - s for s, e in spans) / 1e6
    kernels = {}
    for s, e, n in dev:
        kernels[n] = kernels.get(n, 0.0) + (e - s) / 1e6
    gaps = sorted(((spans[i + 1][0] - spans[i][1], spans[i][1],
                    spans[i + 1][0]) for i in range(len(spans) - 1)),
                  reverse=True)[:top]
    idle = []
    if host:
        hs = np.array([h[0] for h in host])
        he = np.array([h[1] for h in host])
        for g, a, b in gaps:
            ov = np.minimum(he, b) - np.maximum(hs, a)
            # the op that covers most of the gap, the innermost of equals
            i = int(np.lexsort((he - hs, -ov))[0])
            label = host[i][2] if ov[i] > 0 else "no host op"
            idle.append([label[:80], g / 1e6])
    ops = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy, "kernels": kernels,
            "breakdown": {"device_ops": [[n[:80], s] for n, s in ops],
                          "idle_gaps": idle},
            "window_s": window_s}
