"""Plain teacher-forced training steps of the WaveRNN vocoder (fatchord/
WaveRNN models/fatchord_version.py ``forward`` and utils/distribution.py
``discretized_mix_logistic_loss``, MOL output): the upsampler with
BatchNorm on the batch's statistics, I, the two GRUs step by step, the FC
stack, the mixture-of-logistics loss; gradients by autograd and Adam
through ``train.steps`` at ``voc_lr`` and ``voc_clip_grad_norm``, in
the precision of the weights and batches it is given (the check's in
float64, the TF32 control's in float32)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .tacotron import batchnorm, gru_seq, linear
from .train import steps as adam_steps

LOG_SCALE_MIN = math.log(1e-14)


def upsample(P, mels, cfg):
    """mels (B, n_mels, frames + 2*pad), the window with its context ->
    (mels_up (B, frames*hop, n_mels), aux (B, frames*hop, res_out)): the
    MelResNet (valid convs, BatchNorm on batch statistics) repeated hop
    times, and the stretch-and-average convs on the mels trimmed by
    pad*hop at both ends."""
    r = "upsample.resnet."
    h = torch.relu(batchnorm(F.conv1d(mels, P[r + "conv_in.weight"]), P,
                             r + "batch_norm", True))
    for i in range(cfg["voc_res_blocks"]):
        b = f"{r}layers.{i}."
        y = torch.relu(batchnorm(F.conv1d(h, P[b + "conv1.weight"]), P,
                                 b + "batch_norm1", True))
        h = h + batchnorm(F.conv1d(y, P[b + "conv2.weight"]), P,
                          b + "batch_norm2", True)
    aux = F.conv1d(h, P[r + "conv_out.weight"], P[r + "conv_out.bias"])
    hop = math.prod(cfg["voc_upsample_factors"])
    aux = aux.repeat_interleave(hop, dim=-1)
    m = mels[:, None]
    for i, s in enumerate(cfg["voc_upsample_factors"]):
        m = m.repeat_interleave(s, dim=-1)
        m = F.conv2d(m, P[f"upsample.up_layers.{2 * i + 1}.weight"],
                     padding=(0, s))
    indent = cfg["voc_pad"] * hop
    m = m[:, 0, :, indent:-indent]
    return m.transpose(1, 2), aux.transpose(1, 2)


def forward(P, x, mels, cfg):
    """Logits (B, T, 30) of the previous samples x (B, T) in [-1, 1]."""
    mels_up, aux = upsample(P, mels, cfg)
    A = cfg["voc_res_out_dims"] // 4
    a1, a2, a3, a4 = (aux[..., i * A:(i + 1) * A] for i in range(4))

    def gru(name, inp):
        return gru_seq(inp, P[f"{name}.weight_ih_l0"],
                       P[f"{name}.weight_hh_l0"], P[f"{name}.bias_ih_l0"],
                       P[f"{name}.bias_hh_l0"])
    h = linear(torch.cat([x[..., None], mels_up, a1], dim=-1), P["I.weight"],
               P["I.bias"])
    h = gru("rnn1", h) + h
    h = gru("rnn2", torch.cat([h, a2], dim=-1)) + h
    h = torch.relu(linear(torch.cat([h, a3], dim=-1), P["fc1.weight"],
                          P["fc1.bias"]))
    h = torch.relu(linear(torch.cat([h, a4], dim=-1), P["fc2.weight"],
                          P["fc2.bias"]))
    return linear(h, P["fc3.weight"], P["fc3.bias"])


def mol_loss(y_hat, y, num_classes: int = 65536):
    """The mean negative log-likelihood of targets y (B, T) in [-1, 1]
    under the discretized mixture of logistics y_hat (B, T, 3 * nr_mix)."""
    nr = y_hat.shape[-1] // 3
    y = y[..., None]
    logit_probs = y_hat[..., :nr]
    means = y_hat[..., nr:2 * nr]
    log_scales = torch.clamp(y_hat[..., 2 * nr:], min=LOG_SCALE_MIN)
    centered = y - means
    inv_stdv = torch.exp(-log_scales)
    plus_in = inv_stdv * (centered + 1.0 / (num_classes - 1))
    min_in = inv_stdv * (centered - 1.0 / (num_classes - 1))
    cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(min_in)
    log_cdf_plus = plus_in - F.softplus(plus_in)
    log_one_minus_cdf_min = -F.softplus(min_in)
    mid_in = inv_stdv * centered
    log_pdf_mid = mid_in - log_scales - 2.0 * F.softplus(mid_in)
    inner_inner = torch.where(
        cdf_delta > 1e-5, torch.log(torch.clamp(cdf_delta, min=1e-12)),
        log_pdf_mid - math.log((num_classes - 1) / 2))
    inner = torch.where(y > 0.999, log_one_minus_cdf_min, inner_inner)
    log_probs = torch.where(y < -0.999, log_cdf_plus, inner)
    log_probs = log_probs + F.log_softmax(logit_probs, dim=-1)
    return -torch.mean(torch.logsumexp(log_probs, dim=-1))


def voc_loss(P, batch, cfg):
    return mol_loss(forward(P, batch["x"], batch["mels"], cfg), batch["y"])


def steps(P0, batches, cfg):
    """The vocoder's Adam steps from P0, one a batch (``train.steps``)."""
    return adam_steps(P0, batches, cfg, loss=voc_loss, prefix="voc")
