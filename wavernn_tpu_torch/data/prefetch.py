"""Background-thread batch prefetching (port of
``wavernn_tpu.data.prefetch``).

The reference feeds its GPU from 2 DataLoader worker processes (reference
utils/dataset.py:54-60). Here a daemon thread runs the numpy collate ahead
of the training step and turns each batch into CPU tensors, pinned when
the consumer trains on CUDA; the consumer copies them to the device with
``non_blocking=True``, so collate and the host-to-device copy overlap the
device's work. On a data-parallel mesh each rank prefetches its own shard
(the batchers' ``shard_index``) onto its own device.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

_DONE = object()


def _to_tensors(batch, pin: bool):
    def conv(x):
        if isinstance(x, np.ndarray) and x.dtype != object:
            t = torch.from_numpy(np.ascontiguousarray(x))
            return t.pin_memory() if pin else t
        return x

    if isinstance(batch, (tuple, list)):
        return type(batch)(conv(x) for x in batch)
    return conv(batch)


def _to_device(batch, device):
    def move(x):
        if isinstance(x, torch.Tensor):
            return x.to(device, non_blocking=True)
        return x

    if isinstance(batch, (tuple, list)):
        return type(batch)(move(x) for x in batch)
    return move(batch)


def prefetch(iterable: Iterable, size: int = 2, device=None) -> Iterator:
    """Iterate ``iterable`` on a daemon thread, ``size`` batches ahead.

    Producer exceptions re-raise at the consumer. Numpy arrays become
    tensors (pinned for a CUDA ``device``); with ``device`` given, the
    consumer receives them on it. Leaving the loop early stops the producer
    and drains the queue."""
    device = None if device is None else torch.device(device)
    pin = device is not None and device.type == "cuda"
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()

    def put(item):
        # a bounded put that gives up once the consumer is gone: the train
        # loop breaks out mid-epoch, and a plain q.put would leave this
        # thread blocked for the life of the process, holding pinned batches
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterable:
                if not put(_to_tensors(batch, pin)):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised at consumer
            put(e)
            return
        put(_DONE)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item if device is None else _to_device(item, device)
    finally:
        stop.set()
        while t.is_alive():  # drain so the producer sees the stop flag
            try:
                q.get_nowait()
            except queue.Empty:
                t.join(timeout=0.05)
