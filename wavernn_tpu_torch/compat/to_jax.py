"""Weight bridge, the other way: the port's WaveRNN state dict -> the JAX
package's flat parameter keys.

The inverse of ``from_jax.wavernn_state_dict``: linear and GRU weights are
transposed back to the JAX layout (in, out), BatchNorm's
weight/bias/running_mean/running_var become scale/bias/mean/var, and
``upsample.up_layers.{2j+1}`` becomes ``up_convs/{j}``. The result is what
``tree_to_flat(params)`` gives in the JAX package, so a checkpoint written
from it loads there (``train/checkpoints.restore_checkpoint``) and back
here through ``from_jax``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

_BN = {"weight": "scale", "bias": "bias", "running_mean": "mean",
       "running_var": "var"}
_RNN = {"weight_ih_l0": ("wi", True), "weight_hh_l0": ("wh", True),
        "bias_ih_l0": ("bi", False), "bias_hh_l0": ("bh", False)}
_LIN = {"weight": ("w", True), "bias": ("b", False)}
_CONV = {"weight": ("w", False), "bias": ("b", False)}


def wavernn_jax_key(name: str) -> Optional[Tuple[str, bool]]:
    """(JAX flat key, transposed?) of one WaveRNN state-dict entry, or None
    for the entries JAX does not keep (``step``, BatchNorm's
    ``num_batches_tracked``)."""
    parts = name.split(".")
    leaf = parts[-1]
    if name == "step" or leaf == "num_batches_tracked":
        return None
    if parts[0] in ("I", "fc1", "fc2", "fc3"):
        key, t = _LIN[leaf]
        return f"{parts[0]}/{key}", t
    if parts[0] in ("rnn1", "rnn2"):
        key, t = _RNN[leaf]
        return f"{parts[0]}/{key}", t
    if parts[:2] == ["upsample", "up_layers"]:
        return f"upsample/up_convs/{(int(parts[2]) - 1) // 2}/w", False
    if parts[:2] == ["upsample", "resnet"]:
        rest = parts[2:-1]
        if rest[0] == "layers":            # layers.{i}.{conv1,batch_norm1,..}
            i, mod = rest[1], rest[2]
            if mod.startswith("batch_norm"):
                return (f"upsample/resnet/blocks/{i}/bn{mod[-1]}/"
                        f"{_BN[leaf]}", False)
            return f"upsample/resnet/blocks/{i}/{mod}/{_CONV[leaf][0]}", False
        if rest[0] == "batch_norm":
            return f"upsample/resnet/bn/{_BN[leaf]}", False
        return f"upsample/resnet/{rest[0]}/{_CONV[leaf][0]}", False
    raise KeyError(f"no JAX parameter for state-dict entry {name!r}")


def to_jax_array(t: torch.Tensor, transpose: bool) -> np.ndarray:
    a = t.detach().to("cpu", torch.float32).numpy()
    return np.ascontiguousarray(a.T if transpose else a)


def from_jax_array(a, transpose: bool) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(np.array(a.T if transpose else a, copy=True,
                                     order="C"))


def jax_flat_from_state_dict(sd) -> Dict[str, np.ndarray]:
    """The JAX flat parameter dict (``tree_to_flat(params)`` keys) of a
    WaveRNN state dict."""
    flat = {}
    for name, t in sd.items():
        hit = wavernn_jax_key(name)
        if hit is not None:
            flat[hit[0]] = to_jax_array(t, hit[1])
    return flat
