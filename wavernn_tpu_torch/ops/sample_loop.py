"""Autoregressive WaveRNN sample loop, plain PyTorch (port of
``wavernn_tpu.ops.sample_loop.generate_scan``; reference
fatchord_version.py:201-241).

The conditioning-side projections run as whole-sequence GEMMs before the
loop; the loop body computes only the state-dependent products. This is
the plain version that both sample-loop kernels (ops/cuda_gen.py: the fused
and the materialized one) are held against.
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
    return generate_scan_with_state(core, mels_up, aux, mode, noise)[0]


def generate_scan_with_state(core, mels_up, aux, mode: str, noise,
                             init_state=None, state_snapshot_at=None,
                             sparse_packed=None):
    """``generate_scan`` with the RNN state in and out (port of
    ``generate_scan_with_state``, wavernn_tpu/ops/sample_loop.py:65-148).

    init_state: optional (h1 (B, R), h2 (B, R), x (B,)) to resume from;
    zeros otherwise. state_snapshot_at: optional step s in [0, T]; the
    returned state is the one entering step s, and with no s (or s = T)
    the state after the last step. sparse_packed: a block-sparse pack of
    these weights (``cuda_gen.pack_sparse``): each per-step product of a
    packed matrix runs over its live blocks only (``cuda_gen.sparse_mm_ref``),
    the conditioning products and fc3 stay dense. Returns (samples (B, T),
    (h1, h2, x))."""
    B, T, _ = mels_up.shape
    if state_snapshot_at is not None and not 0 <= state_snapshot_at <= T:
        raise ValueError(f"state_snapshot_at {state_snapshot_at} outside "
                         f"[0, {T}]")
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
    packed = {} if sparse_packed is None else sparse_packed.entries

    def mm(name, op, w):
        return linear(op, w) if name not in packed else sparse_packed.mm(
            name, op)

    if init_state is None:
        h1, h2, x = (mels_up.new_zeros(B, R), mels_up.new_zeros(B, R),
                     mels_up.new_zeros(B))
    else:
        h1, h2, x = (s.to(mels_up.dtype) for s in init_state)
    snap = None
    out = []
    for t in range(T):
        if t == state_snapshot_at:
            snap = (h1, h2, x)
        inp = i_cond[:, t] + x[:, None] * w_x
        h1 = gru_gates(mm("wi1", inp, wi1) + bi1, mm("wh1", h1, wh1) + bh1,
                       h1)
        xr = inp + h1
        gi2 = mm("wi2x", xr, wi2_x) + gi2_cond[:, t] + bi2
        h2 = gru_gates(gi2, mm("wh2", h2, wh2) + bh2, h2)
        x2 = xr + h2
        hf = torch.relu(mm("w1x", x2, w1_x) + f1_cond[:, t])
        hf = torch.relu(mm("w2x", hf, w2_x) + f2_cond[:, t])
        logits = linear(hf, w3, b3)
        if mode == "MOL":
            x = sample_from_discretized_mix_logistic_with_noise(
                logits, noise[0][t], noise[1][t])
        else:
            x = sample_raw_categorical_with_noise(logits, noise[t])
        out.append(x)
    samples = (torch.stack(out, dim=1) if out
               else mels_up.new_zeros(B, 0))
    return samples, ((h1, h2, x) if snap is None else snap)
