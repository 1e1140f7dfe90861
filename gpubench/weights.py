"""The benchmark's weights: made on the device from the run's seed, one
``torch.rand`` call for a whole model, scaled per tensor by the
framework's initialisation rules (read from the reference state dict's
names):

- Tacotron: matrices Xavier-uniform; BatchNorm at identity; highway gate
  biases W1 zero; recurrent biases U(+-1/sqrt(hidden)); other biases
  U(+-1/sqrt(fan_in)).
- WaveRNN: the averaging convs of the upsampler 1/k; BatchNorm at
  identity; both GRUs U(+-1/sqrt(rnn_dims)); everything else
  U(+-1/sqrt(fan_in)).
"""
from __future__ import annotations

import math

import torch


def _fan_in(w) -> int:
    return w.shape[1] * math.prod(w.shape[2:])


def tacotron_rule(name: str, params: dict):
    """('uniform', bound) or ('const', value) of one Tacotron parameter."""
    mod, leaf = name.rsplit(".", 1)
    p = params[name]
    if ".bnorm" in mod:
        return "const", 1.0 if leaf == "weight" else 0.0
    if p.dim() > 1:
        rf = math.prod(p.shape[2:])
        return "uniform", math.sqrt(6.0 / (p.shape[1] * rf + p.shape[0] * rf))
    if mod.endswith(".W1"):
        return "const", 0.0
    if leaf.startswith("bias_"):          # GRU, GRUCell, LSTMCell
        hh = [k for k in params if k.startswith(mod + ".weight_hh")][0]
        return "uniform", 1.0 / math.sqrt(params[hh].shape[1])
    return "uniform", 1.0 / math.sqrt(params[mod + ".weight"].shape[1])


def wavernn_rule(name: str, params: dict):
    """('uniform', bound) or ('const', value) of one WaveRNN parameter."""
    mod, leaf = name.rsplit(".", 1)
    p = params[name]
    if ".up_layers." in name:
        return "const", 1.0 / p.shape[-1]
    if ".batch_norm" in mod:
        return "const", 1.0 if leaf == "weight" else 0.0
    if name.startswith("rnn"):
        return "uniform", 1.0 / math.sqrt(params["rnn1.weight_hh_l0"].shape[1])
    return "uniform", 1.0 / math.sqrt(_fan_in(params[mod + ".weight"]))


@torch.no_grad()
def fill(model: torch.nn.Module, rule, generator: torch.Generator) -> dict:
    """Overwrite every parameter of ``model`` (on the generator's device)
    from one draw of ``generator``; returns a copy of the whole state dict
    (parameters and buffers), the reference's weights."""
    params = dict(model.named_parameters())
    rules = {k: rule(k, params) for k in params}
    total = sum(p.numel() for k, p in params.items()
                if rules[k][0] == "uniform")
    dev = next(iter(params.values())).device
    flat = torch.rand(total, generator=generator, device=dev)
    o = 0
    for k, p in params.items():
        kind, v = rules[k]
        if kind == "const":
            p.fill_(v)
        else:
            n = p.numel()
            p.copy_(flat[o:o + n].view_as(p) * (2 * v) - v)
            o += n
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
