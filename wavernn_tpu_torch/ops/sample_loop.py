"""Autoregressive WaveRNN sample loop, plain PyTorch (port of
``wavernn_tpu.ops.sample_loop.generate_scan``; reference
fatchord_version.py:201-241).

The conditioning-side projections run as whole-sequence GEMMs before the
loop; the loop body computes only the state-dependent products. This is
the plain version that the fused sample-loop kernel (ops/cuda_gen.py) is
held against.
"""
from __future__ import annotations

import torch

from ..models.distribution import (
    sample_from_discretized_mix_logistic_with_noise,
    sample_raw_categorical_with_noise,
)
from .layers import gru_gates, linear


def generate_scan(core, mels_up, aux, mode: str, noise):
    """Run the sample loop over upsampled conditioning.

    core: the vocoder's weights keyed by reference state-dict name
    (``WaveRNN.core_weights()``); mels_up (B, T, n_mels), aux (B, T, 4A).
    noise: MOL ``(u_mix (T, B, nr_mix), u_s (T, B))`` uniforms in
    [1e-5, 1-1e-5], or RAW ``u (T, B, n_classes)``.
    Returns samples (B, T) float32 in [-1, 1]."""
    B, T, _ = mels_up.shape
    R = core["rnn1.weight_hh_l0"].shape[1]
    FC = core["fc2.weight"].shape[0]
    A = aux.shape[-1] // 4
    a1, a2, a3, a4 = (aux[..., i * A:(i + 1) * A] for i in range(4))

    I_w, I_b = core["I.weight"], core["I.bias"]
    wi2 = core["rnn2.weight_ih_l0"]
    w1, w2 = core["fc1.weight"], core["fc2.weight"]
    i_cond = linear(torch.cat([mels_up, a1], dim=-1), I_w[:, 1:], I_b)
    gi2_cond = linear(a2, wi2[:, R:])
    f1_cond = linear(a3, w1[:, R:], core["fc1.bias"])
    f2_cond = linear(a4, w2[:, FC:], core["fc2.bias"])

    w_x = I_w[:, 0]
    wi1, wh1 = core["rnn1.weight_ih_l0"], core["rnn1.weight_hh_l0"]
    bi1, bh1 = core["rnn1.bias_ih_l0"], core["rnn1.bias_hh_l0"]
    wi2_x, wh2 = wi2[:, :R], core["rnn2.weight_hh_l0"]
    bi2, bh2 = core["rnn2.bias_ih_l0"], core["rnn2.bias_hh_l0"]
    w1_x, w2_x = w1[:, :R], w2[:, :FC]
    w3, b3 = core["fc3.weight"], core["fc3.bias"]

    h1 = mels_up.new_zeros(B, R)
    h2 = mels_up.new_zeros(B, R)
    x = mels_up.new_zeros(B)
    out = []
    for t in range(T):
        inp = i_cond[:, t] + x[:, None] * w_x
        h1 = gru_gates(linear(inp, wi1, bi1), linear(h1, wh1, bh1), h1)
        xr = inp + h1
        gi2 = linear(xr, wi2_x) + gi2_cond[:, t] + bi2
        h2 = gru_gates(gi2, linear(h2, wh2, bh2), h2)
        x2 = xr + h2
        hf = torch.relu(linear(x2, w1_x) + f1_cond[:, t])
        hf = torch.relu(linear(hf, w2_x) + f2_cond[:, t])
        logits = linear(hf, w3, b3)
        if mode == "MOL":
            x = sample_from_discretized_mix_logistic_with_noise(
                logits, noise[0][t], noise[1][t])
        else:
            x = sample_raw_categorical_with_noise(logits, noise[t])
        out.append(x)
    return torch.stack(out, dim=1)
