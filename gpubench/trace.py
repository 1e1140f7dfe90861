"""The traced run's reduction of a ``torch.profiler`` trace of the window:
device busy time (the union of every device operation's interval), device
seconds by kernel name and by program stage, the longest idle gaps
labelled by the host operation that overlapped each most, and the top
device operations.
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


# the host mark that ``StageMarks`` leaves in the trace as a stage closes
MARK = "gpubench.stage:"


class StageMarks(dict):
    """A ``timings=`` dict for the program's stages (``timing.stage`` adds
    each stage's CUDA events by ``setdefault`` as the stage closes) that
    also marks that moment on the profiler's host timeline, so that the
    trace's reduction gives each stage the device operations launched
    since the mark before it: their device time, without the host's launch
    gaps that the stage's own events span."""

    def setdefault(self, key, default=None):
        from torch.profiler import record_function
        with record_function(MARK + key):
            pass
        return super().setdefault(key, default)


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
    """From the raw Kineto events, without building the profiler's event
    tree: device ops as (start_us, end_us, name, launch_us), host ops as
    (start_us, end_us, name), and ``StageMarks``' marks as (us, stage). A
    device op's launch is the host start of the host op that launched it
    (the one it is linked to; a CUDA runtime call is itself linked to that
    op, a host op to none); None where the trace lacks it."""
    import torch
    dev, host, marks, ops = [], [], [], {}
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda and _annotation(e):
            continue
        s = e.start_ns() / 1e3
        end = s + e.duration_ns() / 1e3
        if e.device_type() == cuda:
            dev.append((s, end, e.name(), e.linked_correlation_id()))
            continue
        host.append((s, end, e.name()))
        if e.name().startswith(MARK):
            marks.append((s, e.name()[len(MARK):]))
        elif e.linked_correlation_id() == 0:
            ops[e.correlation_id()] = s
    dev = [(s, end, n, ops.get(op)) for s, end, n, op in dev]
    return dev, host, marks


def stage_seconds(dev, marks):
    """({stage: device s}, unattributed device s): each device op goes to
    the stage of the first mark at or after its launch on the host. None
    where the window has no marks."""
    if not marks:
        return None
    marks = sorted(marks)
    at = np.array([m[0] for m in marks])
    out, lost = {}, 0.0
    for s, e, _, t in dev:
        i = len(at) if t is None else int(np.searchsorted(at, t))
        if i == len(at):
            lost += (e - s) / 1e6
            continue
        name = marks[i][1]
        out[name] = out.get(name, 0.0) + (e - s) / 1e6
    return out, lost


def reduce(prof, window_s: float, top: int = 10) -> dict:
    """{busy_s, kernels {name: s}, stages ({stage: s}, unattributed s) or
    None, breakdown {device_ops, idle_gaps}}."""
    dev, host, marks = _events(prof)
    dev.sort(key=lambda d: d[:2])
    busy, end, spans = 0.0, None, []
    for s, e, *_ in dev:
        if end is None or s > end:
            spans.append([s, e])
        else:
            spans[-1][1] = max(spans[-1][1], e)
        end = e if end is None else max(end, e)
    busy = sum(e - s for s, e in spans) / 1e6
    kernels = {}
    for s, e, n, _ in dev:
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
            "stages": stage_seconds(dev, marks),
            "breakdown": {"device_ops": [[n[:80], s] for n, s in ops],
                          "idle_gaps": idle},
            "window_s": window_s}
