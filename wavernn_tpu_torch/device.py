"""Device selection for the port's entry points."""
from __future__ import annotations

import torch
from torch import nn


def resolve_device(device, *modules: nn.Module) -> torch.device:
    """The torch.device an entry point runs on.

    A CUDA device on a machine without CUDA raises: the entry points never
    carry on on the CPU unless the caller asks for it. Each module given
    must already hold its weights on that device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available "
                "(pass device='cpu' to run the plain PyTorch versions)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    for m in modules:
        p = next(m.parameters())
        if p.device != dev:
            raise ValueError(f"{type(m).__name__} weights are on {p.device}, "
                             f"not {dev}: move the model with .to(device)")
    return dev
