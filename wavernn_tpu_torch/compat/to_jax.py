"""Weight bridge, the other way: the port's WaveRNN and Tacotron state
dicts -> the JAX package's flat parameter keys.

The inverse of ``from_jax.wavernn_state_dict`` and
``from_jax.tacotron_state_dict``: linear and GRU/LSTM weights are
transposed back to the JAX layout (in, out), BatchNorm's
weight/bias/running_mean/running_var become scale/bias/mean/var,
``upsample.up_layers.{2j+1}`` becomes ``up_convs/{j}``, a CBHG's
``rnn`` becomes ``rnn_fwd`` and its ``_reverse`` weights ``rnn_bwd``. The
result is what ``tree_to_flat(params)`` gives in the JAX package, so a
checkpoint written from it loads there
(``train/checkpoints.restore_checkpoint``) and back here through
``from_jax``.
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


_CELL = {"weight_ih": ("wi", True), "weight_hh": ("wh", True),
         "bias_ih": ("bi", False), "bias_hh": ("bh", False)}


def _cbhg_key(parts, leaf):
    """Key below a CBHG's prefix of its state-dict entry ``parts``."""
    if parts[0] == "conv1d_bank":
        i, mod = parts[1], parts[2]
        if mod == "bnorm":
            return f"bank/{i}/bn/{_BN[leaf]}", False
        return f"bank/{i}/conv/w", False
    if parts[0].startswith("conv_project"):
        k = parts[0][-1]
        if parts[1] == "bnorm":
            return f"proj{k}/bn/{_BN[leaf]}", False
        return f"proj{k}/conv/w", False
    if parts[0] == "pre_highway":
        return "pre_highway/w", True
    if parts[0] == "highways":
        key, t = _LIN[leaf]
        return f"highways/{parts[1]}/{parts[2]}/{key}", t
    if parts[0] == "rnn":
        base = leaf[:-len("_reverse")] if leaf.endswith("_reverse") else leaf
        key, t = _RNN[base]
        return f"{'rnn_bwd' if leaf.endswith('_reverse') else 'rnn_fwd'}/{key}", t
    raise KeyError(".".join(parts))


def tacotron_jax_key(name: str) -> Optional[Tuple[str, bool]]:
    """(JAX flat key, transposed?) of one Tacotron state-dict entry, or
    None for the entries JAX does not keep (``step``, ``stop_threshold``,
    ``decoder.r``, ``num_batches_tracked``)."""
    parts = name.split(".")
    leaf = parts[-1]
    if name in ("step", "stop_threshold", "decoder.r") \
            or leaf == "num_batches_tracked":
        return None
    if name == "encoder.embedding.weight":
        return "encoder/embedding/table", False
    if parts[:2] in (["encoder", "pre_net"], ["decoder", "prenet"]):
        key, t = _LIN[leaf]
        return f"{parts[0]}/prenet/{parts[2]}/{key}", t
    if parts[:2] == ["encoder", "cbhg"]:
        key, t = _cbhg_key(parts[2:], leaf)
        return f"encoder/cbhg/{key}", t
    if parts[0] == "postnet":
        key, t = _cbhg_key(parts[1:], leaf)
        return f"postnet/{key}", t
    if parts[0] in ("encoder_proj", "post_proj"):
        return f"{parts[0]}/w", True
    if parts[:2] == ["decoder", "attn_net"]:
        if parts[2] == "conv":
            return "decoder/attn/conv/w", False
        key, t = _LIN[leaf]
        return f"decoder/attn/{parts[2]}/{key}", t
    if parts[0] == "decoder" and parts[1] in ("attn_rnn", "res_rnn1",
                                              "res_rnn2"):
        key, t = _CELL[leaf]
        return f"decoder/{parts[1]}/{key}", t
    if parts[0] == "decoder" and parts[1] in ("rnn_input", "mel_proj"):
        key, t = _LIN[leaf]
        return f"decoder/{parts[1]}/{key}", t
    raise KeyError(f"no JAX parameter for state-dict entry {name!r}")


def to_jax_array(t: torch.Tensor, transpose: bool) -> np.ndarray:
    a = t.detach().to("cpu", torch.float32).numpy()
    return np.ascontiguousarray(a.T if transpose else a)


def from_jax_array(a, transpose: bool) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(np.array(a.T if transpose else a, copy=True,
                                     order="C"))


def jax_flat_from_state_dict(sd, key_fn=wavernn_jax_key
                             ) -> Dict[str, np.ndarray]:
    """The JAX flat parameter dict (``tree_to_flat(params)`` keys) of a
    state dict; ``key_fn``: ``wavernn_jax_key`` or ``tacotron_jax_key``."""
    flat = {}
    for name, t in sd.items():
        hit = key_fn(name)
        if hit is not None:
            flat[hit[0]] = to_jax_array(t, hit[1])
    return flat
