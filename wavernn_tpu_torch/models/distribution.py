"""Sampling from the WaveRNN output head with injected uniforms (port of
``wavernn_tpu.models.distribution``, reference utils/distribution.py).

The random draws are arguments, so a run can be replayed exactly from the
same uniforms.
"""
from __future__ import annotations

import math

import torch

LOG_SCALE_MIN = float(math.log(1e-14))


def sample_from_discretized_mix_logistic_with_noise(y, u_mix, u_sample,
                                                    log_scale_min: float = LOG_SCALE_MIN):
    """MOL sample given uniforms.

    y (..., 3*nr_mix) network output; u_mix (..., nr_mix) uniforms in
    [1e-5, 1-1e-5] for the Gumbel mixture pick; u_sample (...,) for the
    inverse-CDF logistic draw. Returns samples in [-1, 1], shape (...,)."""
    nr_mix = y.shape[-1] // 3
    temp = y[..., :nr_mix] - torch.log(-torch.log(u_mix))
    idx = torch.argmax(temp, dim=-1, keepdim=True)
    means = torch.gather(y[..., nr_mix:2 * nr_mix], -1, idx)[..., 0]
    log_scales = torch.clamp(
        torch.gather(y[..., 2 * nr_mix:3 * nr_mix], -1, idx)[..., 0],
        min=log_scale_min)
    x = means + torch.exp(log_scales) * (torch.log(u_sample)
                                         - torch.log(1.0 - u_sample))
    return torch.clamp(x, -1.0, 1.0)


def sample_raw_categorical_with_noise(logits, u):
    """Gumbel-max draw over the RAW softmax classes given uniforms u (same
    shape as logits); returns the class scaled to [-1, 1]
    (fatchord_version.py:231-237)."""
    n_classes = logits.shape[-1]
    g = -torch.log(-torch.log(u))
    idx = torch.argmax(torch.log_softmax(logits, dim=-1) + g, dim=-1)
    return 2.0 * idx.to(logits.dtype) / (n_classes - 1.0) - 1.0
