"""Weight bridge: JAX-package parameters -> the port's state dict.

The JAX package keeps parameters as nested dicts; flattened with
'/'-joined paths (``train/checkpoints.tree_to_flat``, and the ``params/``
entries of the trainer's ``.npz`` files) they read ``{"rnn1/wi": array,
...}``. ``state_dict_from_jax`` maps such a dict onto the reference
state-dict names the port's modules use (the mapping of
``wavernn_tpu/compat/torch_export.py``, copied): linear weights are
transposed, GRU/LSTM gates keep torch's order, BatchNorm's
scale/bias/mean/var become weight/bias/running_mean/running_var, and
``up_convs[j]`` becomes ``upsample.up_layers.{2j+1}``. Every key must be
used and every needed key present, so the result loads with
``load_state_dict(strict=True)``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import Config


class _Flat:
    """Key lookups that remember what was used."""

    def __init__(self, flat):
        self.flat = {k: np.asarray(v) for k, v in flat.items()}
        self.used = set()

    def __contains__(self, key):
        return key in self.flat

    def __getitem__(self, key):
        if key not in self.flat:
            raise KeyError(f"JAX parameters lack {key!r}")
        self.used.add(key)
        return self.flat[key]

    def check_all_used(self):
        unused = sorted(set(self.flat) - self.used)
        if unused:
            raise KeyError(f"JAX parameters not mapped: {unused}")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def _lin(sd, name, f, src, bias=True):
    sd[f"{name}.weight"] = _t(f[f"{src}/w"].T)
    if bias:
        sd[f"{name}.bias"] = _t(f[f"{src}/b"])


def _conv(sd, name, f, src, bias=False):
    sd[f"{name}.weight"] = _t(f[f"{src}/w"])
    if bias:
        sd[f"{name}.bias"] = _t(f[f"{src}/b"])


def _bn(sd, name, f, src):
    for ours, theirs in (("weight", "scale"), ("bias", "bias"),
                         ("running_mean", "mean"), ("running_var", "var")):
        sd[f"{name}.{ours}"] = _t(f[f"{src}/{theirs}"])
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _rnn(sd, name, f, src, suffix):
    for ours, theirs in (("weight_ih", "wi"), ("weight_hh", "wh")):
        sd[f"{name}.{ours}{suffix}"] = _t(f[f"{src}/{theirs}"].T)
    for ours, theirs in (("bias_ih", "bi"), ("bias_hh", "bh")):
        sd[f"{name}.{ours}{suffix}"] = _t(f[f"{src}/{theirs}"])


def _count(f, prefix):
    n = 0
    while any(k.startswith(f"{prefix}/{n}/") for k in f.flat):
        n += 1
    return n


def wavernn_state_dict(flat, step: int = 0) -> Dict[str, torch.Tensor]:
    f = _Flat(flat)
    sd: Dict[str, torch.Tensor] = {}
    res = "upsample/resnet"
    _conv(sd, "upsample.resnet.conv_in", f, f"{res}/conv_in")
    _bn(sd, "upsample.resnet.batch_norm", f, f"{res}/bn")
    for i in range(_count(f, f"{res}/blocks")):
        blk, ours = f"{res}/blocks/{i}", f"upsample.resnet.layers.{i}"
        _conv(sd, f"{ours}.conv1", f, f"{blk}/conv1")
        _bn(sd, f"{ours}.batch_norm1", f, f"{blk}/bn1")
        _conv(sd, f"{ours}.conv2", f, f"{blk}/conv2")
        _bn(sd, f"{ours}.batch_norm2", f, f"{blk}/bn2")
    _conv(sd, "upsample.resnet.conv_out", f, f"{res}/conv_out", bias=True)
    for j in range(_count(f, "upsample/up_convs")):
        sd[f"upsample.up_layers.{2 * j + 1}.weight"] = _t(
            f[f"upsample/up_convs/{j}/w"])
    _lin(sd, "I", f, "I")
    _rnn(sd, "rnn1", f, "rnn1", "_l0")
    _rnn(sd, "rnn2", f, "rnn2", "_l0")
    for name in ("fc1", "fc2", "fc3"):
        _lin(sd, name, f, name)
    sd["step"] = torch.tensor([step], dtype=torch.long)
    f.check_all_used()
    return sd


def _cbhg(sd, name, f, src):
    for i in range(_count(f, f"{src}/bank")):
        _conv(sd, f"{name}.conv1d_bank.{i}.conv", f, f"{src}/bank/{i}/conv")
        _bn(sd, f"{name}.conv1d_bank.{i}.bnorm", f, f"{src}/bank/{i}/bn")
    for k in (1, 2):
        _conv(sd, f"{name}.conv_project{k}.conv", f, f"{src}/proj{k}/conv")
        _bn(sd, f"{name}.conv_project{k}.bnorm", f, f"{src}/proj{k}/bn")
    if f"{src}/pre_highway/w" in f:
        _lin(sd, f"{name}.pre_highway", f, f"{src}/pre_highway", bias=False)
    for i in range(_count(f, f"{src}/highways")):
        for w in ("W1", "W2"):
            _lin(sd, f"{name}.highways.{i}.{w}", f, f"{src}/highways/{i}/{w}")
    _rnn(sd, f"{name}.rnn", f, f"{src}/rnn_fwd", "_l0")
    _rnn(sd, f"{name}.rnn", f, f"{src}/rnn_bwd", "_l0_reverse")


def tacotron_state_dict(flat, stop_threshold: float, step: int = 0,
                        r: int = 1) -> Dict[str, torch.Tensor]:
    f = _Flat(flat)
    sd: Dict[str, torch.Tensor] = {}
    sd["encoder.embedding.weight"] = _t(f["encoder/embedding/table"])
    for k in ("fc1", "fc2"):
        _lin(sd, f"encoder.pre_net.{k}", f, f"encoder/prenet/{k}")
        _lin(sd, f"decoder.prenet.{k}", f, f"decoder/prenet/{k}")
    _cbhg(sd, "encoder.cbhg", f, "encoder/cbhg")
    _lin(sd, "encoder_proj", f, "encoder_proj", bias=False)
    _conv(sd, "decoder.attn_net.conv", f, "decoder/attn/conv")
    _lin(sd, "decoder.attn_net.L", f, "decoder/attn/L")
    _lin(sd, "decoder.attn_net.W", f, "decoder/attn/W")
    _lin(sd, "decoder.attn_net.v", f, "decoder/attn/v", bias=False)
    for cell in ("attn_rnn", "res_rnn1", "res_rnn2"):
        _rnn(sd, f"decoder.{cell}", f, f"decoder/{cell}", "")
    _lin(sd, "decoder.rnn_input", f, "decoder/rnn_input")
    _lin(sd, "decoder.mel_proj", f, "decoder/mel_proj", bias=False)
    sd["decoder.r"] = torch.tensor(r, dtype=torch.int32)
    _cbhg(sd, "postnet", f, "postnet")
    _lin(sd, "post_proj", f, "post_proj", bias=False)
    sd["step"] = torch.tensor([step], dtype=torch.long)
    sd["stop_threshold"] = torch.tensor(stop_threshold, dtype=torch.float32)
    f.check_all_used()
    return sd


def state_dict_from_jax(flat, cfg: Config, step: int = 0,
                        r: int = 1) -> Dict[str, torch.Tensor]:
    """The port's state dict for a flat JAX parameter dict of either model
    (a WaveRNN has ``rnn1/wi``). Raises on a missing or an unused key."""
    if "rnn1/wi" in flat:
        return wavernn_state_dict(flat, step)
    return tacotron_state_dict(flat, cfg.tts.stop_threshold, step, r)
