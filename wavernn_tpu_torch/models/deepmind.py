"""The DeepMind coarse/fine WaveRNN for PyTorch (port of
``wavernn_tpu.models.deepmind``; reference models/deepmind_version.py).

One 896-unit GRU-like cell whose hidden state is split into a coarse and a
fine half, two 256-way softmax heads, unconditional generation. The gates
follow the paper's masked-matrix form: one R product a step, split six
ways; the fine sub-step conditions on the coarse value just sampled but
reuses R(hidden) from before the coarse update (deepmind:116-119).

Parameter names are the reference's (``R``, ``O1``-``O4``, ``I_coarse``,
``I_fine``, ``bias_u``, ``bias_r``, ``bias_e``), so a reference state dict
loads with ``load_state_dict(strict=True)``; ``compat/from_jax.
deepmind_state_dict`` maps the JAX package's parameters onto them. The
model has no TPU kernel: it runs as eager PyTorch on the device its
parameters are on (the card unless the caller moves it to the CPU).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn


class DeepMindWaveRNN(nn.Module):
    def __init__(self, hidden_size: int = 896, quantisation: int = 256):
        super().__init__()
        split = hidden_size // 2
        self.hidden_size, self.split = hidden_size, split
        self.R = nn.Linear(hidden_size, 3 * hidden_size, bias=False)
        self.O1 = nn.Linear(split, split)
        self.O2 = nn.Linear(split, quantisation)
        self.O3 = nn.Linear(split, split)
        self.O4 = nn.Linear(split, quantisation)
        self.I_coarse = nn.Linear(2, 3 * split, bias=False)
        self.I_fine = nn.Linear(3, 3 * split, bias=False)
        self.bias_u = nn.Parameter(torch.zeros(hidden_size))
        self.bias_r = nn.Parameter(torch.zeros(hidden_size))
        self.bias_e = nn.Parameter(torch.zeros(hidden_size))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Fresh weights from ``generator``: every Linear U(+-1/sqrt(fan
        in)), weights and biases (the JAX package's ``linear_init``), the
        gate biases zero."""
        for name, p in self.named_parameters():
            if name.startswith("bias_"):
                p.zero_()
                continue
            mod = self.get_submodule(name.rsplit(".", 1)[0])
            bound = 1.0 / math.sqrt(mod.in_features)
            p.copy_(torch.rand(p.shape, generator=generator) * 2 * bound
                    - bound)

    def cell(self, prev_y, prev_hidden, current_coarse):
        """One training step (deepmind:37-72). prev_y (B, 2) the scaled
        previous [coarse, fine]; current_coarse (B, 1). Returns (coarse
        logits, fine logits, the new hidden state)."""
        H, split = self.hidden_size, self.split
        R_h = self.R(prev_hidden)
        R_u, R_r, R_e = R_h[:, :H], R_h[:, H:2 * H], R_h[:, 2 * H:]
        cip = self.I_coarse(prev_y)
        fip = self.I_fine(torch.cat([prev_y, current_coarse], dim=1))
        I_u = torch.cat([cip[:, :split], fip[:, :split]], dim=1)
        I_r = torch.cat([cip[:, split:2 * split], fip[:, split:2 * split]],
                        dim=1)
        I_e = torch.cat([cip[:, 2 * split:], fip[:, 2 * split:]], dim=1)
        u = torch.sigmoid(R_u + I_u + self.bias_u)
        r = torch.sigmoid(R_r + I_r + self.bias_r)
        e = torch.tanh(r * R_e + I_e + self.bias_e)
        hidden = u * prev_hidden + (1.0 - u) * e
        hc, hf = hidden[:, :split], hidden[:, split:]
        out_coarse = self.O2(torch.relu(self.O1(hc)))
        out_fine = self.O4(torch.relu(self.O3(hf)))
        return out_coarse, out_fine, hidden

    def forward_seq(self, coarse, fine):
        """Teacher-forced sequence forward for training: coarse / fine
        (B, T + 1) integer labels in [0, 255]; step t predicts (coarse[t +
        1], fine[t + 1]) from the scaled (coarse[t], fine[t]) and the
        scaled current coarse. Returns (coarse logits, fine logits), each
        (B, T, Q)."""
        scale = lambda x: x.to(self.R.weight.dtype) / 127.5 - 1.0
        c_in, f_in, c_cur = scale(coarse[:, :-1]), scale(fine[:, :-1]), \
            scale(coarse[:, 1:])
        B, T = c_in.shape
        hidden = c_in.new_zeros(B, self.hidden_size)
        ocs, ofs = [], []
        for t in range(T):
            prev_y = torch.stack([c_in[:, t], f_in[:, t]], dim=1)
            oc, of, hidden = self.cell(prev_y, hidden, c_cur[:, t, None])
            ocs.append(oc)
            ofs.append(of)
        return torch.stack(ocs, dim=1), torch.stack(ofs, dim=1)

    @torch.no_grad()
    def generate(self, seq_len: int,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """Unconditional generation (deepmind:75-165): (signal in [-2^15,
        2^15), coarse labels, fine labels), each (seq_len,) float on the
        model's device. Each sample is the argmax of the log-softmax plus
        Gumbel noise -log(-log(u)); ``noise`` injects the uniforms as
        ((seq_len, Q), (seq_len, Q)) (the JAX package's replay argument),
        else they are drawn in (1e-9, 1) from ``generator``."""
        dev = self.R.weight.device
        H, split = self.hidden_size, self.split
        Q = self.O2.out_features
        if noise is None:
            draw = lambda: (torch.rand(seq_len, Q, generator=generator)
                            * (1.0 - 1e-9) + 1e-9)
            noise = (draw(), draw())
        u_c, u_f = (torch.as_tensor(n, dtype=torch.float32).to(dev)
                    for n in noise)
        bu, br, be = self.bias_u, self.bias_r, self.bias_e
        hidden = torch.zeros(1, H, device=dev)
        out_c = torch.zeros((), device=dev)
        out_f = torch.zeros((), device=dev)
        coarse, fine = [], []
        for t in range(seq_len):
            hc, hf = hidden[:, :split], hidden[:, split:]
            prev = torch.stack([out_c / 127.5 - 1.0,
                                out_f / 127.5 - 1.0])[None]
            cip = self.I_coarse(prev)
            R_h = self.R(hidden)
            u = torch.sigmoid(R_h[:, :split] + cip[:, :split] + bu[:split])
            r = torch.sigmoid(R_h[:, 2 * split:3 * split]
                              + cip[:, split:2 * split] + br[:split])
            e = torch.tanh(r * R_h[:, 4 * split:5 * split]
                           + cip[:, 2 * split:] + be[:split])
            hc = u * hc + (1.0 - u) * e
            oc = self.O2(torch.relu(self.O1(hc)))
            g = -torch.log(-torch.log(u_c[t]))
            out_c = torch.argmax(torch.log_softmax(oc[0], -1) + g).float()

            fip = self.I_fine(torch.cat(
                [prev, (out_c / 127.5 - 1.0).reshape(1, 1)], dim=1))
            u = torch.sigmoid(R_h[:, split:2 * split] + fip[:, :split]
                              + bu[split:])
            r = torch.sigmoid(R_h[:, 3 * split:4 * split]
                              + fip[:, split:2 * split] + br[split:])
            e = torch.tanh(r * R_h[:, 5 * split:] + fip[:, 2 * split:]
                           + be[split:])
            hf = u * hf + (1.0 - u) * e
            of = self.O4(torch.relu(self.O3(hf)))
            g = -torch.log(-torch.log(u_f[t]))
            out_f = torch.argmax(torch.log_softmax(of[0], -1) + g).float()

            hidden = torch.cat([hc, hf], dim=1)
            coarse.append(out_c)
            fine.append(out_f)
        coarse, fine = torch.stack(coarse), torch.stack(fine)
        return coarse * 256.0 + fine - 2 ** 15, coarse, fine


def nll_loss(model: DeepMindWaveRNN, coarse, fine):
    """The training loss of the notebooks: the mean negative log-likelihood
    of the next coarse and fine labels under ``forward_seq``."""
    oc, of = model.forward_seq(coarse, fine)
    lc = -torch.log_softmax(oc, -1).gather(
        -1, coarse[:, 1:, None].long()).mean()
    lf = -torch.log_softmax(of, -1).gather(
        -1, fine[:, 1:, None].long()).mean()
    return lc + lf
