"""The WaveRNN output head's mixture-of-logistics loss, and sampling with
injected uniforms (port of ``wavernn_tpu.models.distribution``, reference
utils/distribution.py).

The random draws are arguments, so a run can be replayed exactly from the
same uniforms.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LOG_SCALE_MIN = float(math.log(1e-14))


def discretized_mix_logistic_loss(y_hat, y, num_classes: int = 65536,
                                  log_scale_min: float = LOG_SCALE_MIN,
                                  reduce: bool = True):
    """Negative log-likelihood of y under a discretized logistic mixture.

    y_hat (B, T, 3*nr_mix) raw network output (the natural layout, as the
    JAX package; the reference permutes (B, C, T)); y (B, T) or (B, T, 1)
    targets in [-1, 1]."""
    nr_mix = y_hat.shape[-1] // 3
    if y.dim() == y_hat.dim() - 1:
        y = y[..., None]
    logit_probs = y_hat[..., :nr_mix]
    means = y_hat[..., nr_mix:2 * nr_mix]
    log_scales = torch.clamp(y_hat[..., 2 * nr_mix:], min=log_scale_min)

    centered_y = y - means
    inv_stdv = torch.exp(-log_scales)
    plus_in = inv_stdv * (centered_y + 1.0 / (num_classes - 1))
    cdf_plus = torch.sigmoid(plus_in)
    min_in = inv_stdv * (centered_y - 1.0 / (num_classes - 1))
    cdf_min = torch.sigmoid(min_in)

    log_cdf_plus = plus_in - F.softplus(plus_in)         # log sig(plus_in)
    log_one_minus_cdf_min = -F.softplus(min_in)          # log(1 - sig(min_in))
    cdf_delta = cdf_plus - cdf_min

    mid_in = inv_stdv * centered_y
    log_pdf_mid = mid_in - log_scales - 2.0 * F.softplus(mid_in)

    inner_inner = torch.where(
        cdf_delta > 1e-5, torch.log(torch.clamp(cdf_delta, min=1e-12)),
        log_pdf_mid - math.log((num_classes - 1) / 2.0))
    inner = torch.where(y > 0.999, log_one_minus_cdf_min, inner_inner)
    log_probs = torch.where(y < -0.999, log_cdf_plus, inner)
    log_probs = log_probs + torch.log_softmax(logit_probs, dim=-1)
    if reduce:
        return -torch.mean(torch.logsumexp(log_probs, dim=-1))
    return -torch.logsumexp(log_probs, dim=-1)[..., None]


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
