"""The port's backend rule, stated once (the counterpart of
``wavernn_tpu/utils/backend.py``).

Every kernel wrapper of the port picks its path from where its tensors
lie: a CUDA tensor launches the hand-written kernel (or raises), a CPU
tensor runs the kernel's plain PyTorch version; neither falls back to the
other. A device mesh changes nothing: each rank runs the same wrappers on
its own shard. So the training recurrence "auto" resolves to the wrappers
("pallas", the JAX package's name for its kernels) on every device and on
a mesh; "scan", the plain step loops under autograd, is only ever asked
for.
"""
from __future__ import annotations

RECURRENCES = ("auto", "scan", "pallas")


def resolve_recurrence(value: str = "auto", mesh=None) -> str:
    """The training recurrence for ``value``: "auto" -> "pallas" (the
    kernels B5, B6 and B7 through their wrappers: launched on CUDA tensors,
    their plain versions on CPU tensors), with or without ``mesh``;
    "scan" and "pallas" pass through."""
    del mesh   # every rank runs the wrappers on its shard
    if value not in RECURRENCES:
        raise ValueError(f"recurrence must be one of {RECURRENCES}, got "
                         f"{value!r}")
    return "pallas" if value == "auto" else value
