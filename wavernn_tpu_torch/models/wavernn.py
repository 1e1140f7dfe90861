"""WaveRNN vocoder (fatchord variant) for PyTorch (port of
``wavernn_tpu.models.wavernn``: the teacher-forced training ``forward`` and
batched generation).

Module and parameter names follow the reference state dict
(models/fatchord_version.py:92-167), so a reference ``.pyt`` loads with
``load_state_dict(strict=True)``. ``forward`` runs the two GRUs as the
recurrence kernel B5 (ops/cuda_gru.py) with the core stack time-major, or
as B5's plain step loop under autograd (``recurrence="scan"``).
Generation (``generate``, ``generate_fast``, ``generate_multi``) runs both
branches of the JAX package's ``_generate_device``: MelResNet at frame
rate, frame-rate folds and the fused sample-loop kernel B1 when the folds
are phase-aligned to mel frames; otherwise the upsampled sample-rate
conditioning, folded or as one unbatched row, through the materialized
kernel B3 (ops/cuda_gen.py); then mu-law decode (RAW), the equal-power
crossfade and the 20-frame tail fade. Each takes ``sparse_packed``
(``ops/cuda_gen.pack_sparse`` of a pruned model's weights), which runs
either kernel's block-sparse arm B9.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..config import DSPConfig, WaveRNNConfig
from ..device import resolve_device
from ..ops import layers as L
from ..ops import polyphase as P
from ..ops.cuda_gen import generate_fused, generate_materialized
from ..ops.cuda_gru import gru_seq_ref, gru_seq_tm
from ..ops import fold
from ..ops.fold import fold_with_overlap, xfade_and_unfold
from ..timing import stage


CORE_NAMES = ("I.weight", "I.bias", "rnn1.weight_ih_l0", "rnn1.weight_hh_l0",
              "rnn1.bias_ih_l0", "rnn1.bias_hh_l0", "rnn2.weight_ih_l0",
              "rnn2.weight_hh_l0", "rnn2.bias_ih_l0", "rnn2.bias_hh_l0",
              "fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias",
              "fc3.weight", "fc3.bias")


class ResBlock(nn.Module):
    def __init__(self, dims: int):
        super().__init__()
        self.conv1 = nn.Conv1d(dims, dims, 1, bias=False)
        self.conv2 = nn.Conv1d(dims, dims, 1, bias=False)
        self.batch_norm1 = nn.BatchNorm1d(dims)
        self.batch_norm2 = nn.BatchNorm1d(dims)

    def forward(self, x, training: bool = False):
        r = x
        x = torch.relu(_bn(self.batch_norm1, L.conv1d(x, self.conv1.weight),
                           training))
        x = _bn(self.batch_norm2, L.conv1d(x, self.conv2.weight), training)
        return x + r


def _bn(bn: nn.BatchNorm1d, x, training: bool = False):
    if training:
        return L.batchnorm_train(x, bn.weight, bn.bias, bn.running_mean,
                                 bn.running_var,
                                 mesh=getattr(bn, "mesh", None))
    return L.batchnorm(x, bn.weight, bn.bias, bn.running_mean, bn.running_var)


class MelResNet(nn.Module):
    def __init__(self, res_blocks: int, in_dims: int, compute_dims: int,
                 res_out_dims: int, pad: int):
        super().__init__()
        self.conv_in = nn.Conv1d(in_dims, compute_dims, 2 * pad + 1,
                                 bias=False)
        self.batch_norm = nn.BatchNorm1d(compute_dims)
        self.layers = nn.ModuleList(ResBlock(compute_dims)
                                    for _ in range(res_blocks))
        self.conv_out = nn.Conv1d(compute_dims, res_out_dims, 1)

    def forward(self, x, training: bool = False):
        """(B, n_mels, T) -> (B, res_out, T - 2*pad). ``training`` uses batch
        statistics and updates the running ones in place."""
        x = torch.relu(_bn(self.batch_norm, L.conv1d(x, self.conv_in.weight),
                           training))
        for layer in self.layers:
            x = layer(x, training)
        return L.conv1d(x, self.conv_out.weight, self.conv_out.bias)


class Stretch2d(nn.Module):
    """Nearest-neighbour repeat along time; holds no weights (it marks the
    even slots of the reference's ``up_layers``)."""

    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale


def _stretch(x, scale: int):
    """Nearest-neighbour repeat along the last axis. expand + reshape, not
    ``repeat_interleave``, which reads its output size back to the host
    and so waits for the device."""
    return x.unsqueeze(-1).expand(*x.shape, scale).reshape(
        *x.shape[:-1], x.shape[-1] * scale)


class UpsampleNetwork(nn.Module):
    def __init__(self, feat_dims: int, upsample_scales, compute_dims: int,
                 res_blocks: int, res_out_dims: int, pad: int):
        super().__init__()
        self.resnet = MelResNet(res_blocks, feat_dims, compute_dims,
                                res_out_dims, pad)
        layers = []
        for scale in upsample_scales:
            k = scale * 2 + 1
            conv = nn.Conv2d(1, 1, kernel_size=(1, k), padding=(0, scale),
                             bias=False)
            layers += [Stretch2d(scale), conv]
        self.up_layers = nn.ModuleList(layers)

    def up_weights(self):
        return [m.weight for m in self.up_layers if isinstance(m, nn.Conv2d)]

    def forward(self, mels, training: bool = False):
        """mels (B, n_mels, T) with the 2*pad context frames ->
        (mels_up (B, (T-2*pad)*hop, n_mels), aux (B, (T-2*pad)*hop, res_out)),
        in float32 (upsample_apply, fatchord_version.py:72-90): MelResNet,
        its nearest-neighbour stretch, and the Stretch2d + Conv2d averaging
        convs on the mels, trimmed by ``indent`` at both ends."""
        scales = [m.scale for m in self.up_layers if isinstance(m, Stretch2d)]
        total = math.prod(scales)
        indent = self.resnet.conv_in.weight.shape[-1] // 2 * total
        aux = _stretch(self.resnet(mels, training), total)
        m = mels[:, None]                                  # (B, 1, C, T)
        for layer in self.up_layers:
            if isinstance(layer, Stretch2d):
                m = _stretch(m, layer.scale)
            else:
                m = torch.nn.functional.conv2d(
                    m, layer.weight, padding=layer.padding)
        m = m[:, 0, :, indent:-indent]
        return m.transpose(1, 2), aux.transpose(1, 2)


class WaveRNN(nn.Module):
    def __init__(self, voc: WaveRNNConfig, dsp: DSPConfig):
        super().__init__()
        self.voc, self.dsp = voc, dsp
        R, FC, A = voc.rnn_dims, voc.fc_dims, voc.aux_dims
        self.upsample = UpsampleNetwork(dsp.num_mels, voc.upsample_factors,
                                        voc.compute_dims, voc.res_blocks,
                                        voc.res_out_dims, voc.pad)
        self.I = nn.Linear(dsp.num_mels + A + 1, R)
        self.rnn1 = nn.GRU(R, R, batch_first=True)
        self.rnn2 = nn.GRU(R + A, R, batch_first=True)
        self.fc1 = nn.Linear(R + A, FC)
        self.fc2 = nn.Linear(FC + A, FC)
        self.fc3 = nn.Linear(FC, voc.n_classes(dsp.bits))
        self.register_buffer("step", torch.zeros(1, dtype=torch.long))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Fresh weights from ``generator`` with the JAX package's init:
        linear/conv U(+-1/sqrt(fan_in)), GRU U(+-1/sqrt(hidden)), the
        averaging convs 1/k (fatchord:78), BatchNorm at identity."""
        for name, p in self.named_parameters():
            if ".up_layers." in name:
                p.fill_(1.0 / p.shape[-1])
                continue
            if ".batch_norm" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
                continue
            if name.startswith("rnn"):
                bound = 1.0 / math.sqrt(self.voc.rnn_dims)
            else:
                mod = self.get_submodule(name.rsplit(".", 1)[0])
                w = mod.weight
                bound = 1.0 / math.sqrt(w.shape[1] * math.prod(w.shape[2:]))
            p.copy_(torch.rand(p.shape, generator=generator) * 2 * bound
                    - bound)
        for m in self.modules():
            if isinstance(m, nn.BatchNorm1d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)

    def core_parameters(self):
        """The core stack's parameters (I, both GRUs, fc1-3) by reference
        state-dict name, attached to autograd."""
        params = dict(self.named_parameters())
        return {k: params[k] for k in CORE_NAMES}

    def core_weights(self):
        """The sample loop's weights by reference state-dict name."""
        return {k: v.detach() for k, v in self.core_parameters().items()}


def forward(model: WaveRNN, x, mels, training: bool = False,
            compute_dtype=None, recurrence: str = "auto"):
    """Teacher-forced forward (fatchord_version.py:131-167): logits
    (B, T, n_classes) in float32.

    x (B, T) previous samples in [-1, 1]; mels (B, n_mels, T_mel), the
    window with its 2*pad context frames. ``training`` runs BatchNorm on
    batch statistics and updates its running statistics in place.
    ``compute_dtype`` (bfloat16) runs the core GRU/FC stack in that dtype:
    the upsampler and BatchNorm stay float32, the core weights and inputs
    are cast on entry and the logits cast back to float32.
    ``recurrence``: the two GRUs run time-major over gi = h @ wi + bi,
    computed as one matrix product outside the recurrence, with one
    (B, T) -> (T, B) flip after I. "auto"/"pallas" run them through
    ``gru_seq_tm`` (the kernel B5 forward and backward on CUDA tensors,
    their plain versions on CPU tensors); "scan" runs B5's plain forward
    ``gru_seq_ref`` under autograd."""
    if recurrence not in ("auto", "pallas", "scan"):
        raise ValueError(f"unknown recurrence {recurrence!r}")
    A = model.voc.aux_dims
    mels_up, aux = model.upsample(mels, training)
    cd = torch.float32 if compute_dtype is None else compute_dtype
    w = {k: v.to(cd) for k, v in model.core_parameters().items()}
    x, mels_up, aux = x.to(cd), mels_up.to(cd), aux.to(cd)
    a1, a2, a3, a4 = (aux[..., i * A:(i + 1) * A] for i in range(4))
    h = torch.cat([x[..., None], mels_up, a1], dim=-1)
    h = L.linear(h, w["I.weight"], w["I.bias"])

    def tm(v):
        return v.transpose(0, 1)

    def rnn(name, inp):
        gi = L.linear(inp, w[f"{name}.weight_ih_l0"], w[f"{name}.bias_ih_l0"])
        wh = w[f"{name}.weight_hh_l0"].t()
        bh = w[f"{name}.bias_hh_l0"]
        h0 = inp.new_zeros(inp.shape[1], wh.shape[0])
        if recurrence == "scan":
            return gru_seq_ref(gi, wh, bh, h0)[0]
        return gru_seq_tm(gi, wh, bh, h0)

    h = tm(h).contiguous()                  # the one (B, T) -> (T, B) flip
    res = h
    h = rnn("rnn1", h) + res
    res = h
    h = rnn("rnn2", torch.cat([h, tm(a2)], dim=-1)) + res
    h = torch.relu(L.linear(torch.cat([h, tm(a3)], dim=-1), w["fc1.weight"],
                            w["fc1.bias"]))
    h = torch.relu(L.linear(torch.cat([h, tm(a4)], dim=-1), w["fc2.weight"],
                            w["fc2.bias"]))
    return tm(L.linear(h, w["fc3.weight"], w["fc3.bias"])).float()


def fused_cond_ok(voc: WaveRNNConfig, dsp: DSPConfig, target: int,
                  overlap: int) -> bool:
    """The fused kernel needs folds phase-aligned to mel frames (true for
    the defaults: target 11000 / overlap 550 / hop 275)."""
    if not (math.prod(voc.upsample_factors) == dsp.hop_length
            and target % dsp.hop_length == 0
            and overlap % dsp.hop_length == 0):
        return False
    geo = P.geometry(voc.upsample_factors, voc.pad)
    return 0 <= -geo.d_lo < geo.K


def _fold_frames(mels_padded_row, aux_fr_row, total_len: int, target: int,
                 overlap: int, geo):
    """One utterance's frame-rate folds: mels_padded_row (n_mels, T + 2*pad),
    aux_fr_row (4A, T) -> (frames (nf_loc, num_folds, C), fold_chunks)."""
    num_folds, stride_f, fold_chunks, _ = P.fold_geometry(
        total_len, target, overlap, geo.hop)
    frames = P.build_folded_frames(mels_padded_row.t(), aux_fr_row.t(),
                                   num_folds, stride_f, fold_chunks, geo.K,
                                   geo.d_lo)
    return frames, fold_chunks


def fused_conditioning(model: WaveRNN, mels_padded, total_len: int,
                       target: int, overlap: int):
    """MelResNet at frame rate, the polyphase table and the frame-rate
    folds: (frames, phi, geometry, fold_chunks)."""
    voc = model.voc
    geo = P.geometry(voc.upsample_factors, voc.pad)
    phi = P.phi_table(model.upsample.up_weights(), voc.upsample_factors, geo)
    aux_fr = model.upsample.resnet(mels_padded)
    frames, fold_chunks = _fold_frames(mels_padded[0], aux_fr[0], total_len,
                                       target, overlap, geo)
    return frames, phi.contiguous(), geo, fold_chunks


def _seed(noise, generator: Optional[torch.Generator]) -> int:
    """The counter hash's seed, drawn from ``generator``; 0 when noise is
    injected (the seed is then unused)."""
    if noise is not None:
        return 0
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator)
               .item())


def _samples(model: WaveRNN, mels, batched: bool, target: int, overlap: int,
             noise, seed: int, timings, dev, sparse_packed=None):
    """The sample loop over one utterance's mels (1, n_mels, T_frames):
    (folds, target + 2*overlap) when ``batched``, else (1, T_frames*hop).

    Folds phase-aligned to mel frames run the fused kernel B1 on frame-rate
    folds (``fused_cond_ok``); otherwise the mels are upsampled to sample
    rate, folded when ``batched``, and run through the materialized kernel
    B3 (_generate_device, wavernn_tpu/models/wavernn.py:283-358, and the
    unbatched branch of generate, :657-683)."""
    voc, dsp = model.voc, model.dsp
    total_len = mels.shape[-1] * dsp.hop_length
    fused = batched and fused_cond_ok(voc, dsp, target, overlap)
    with stage(timings, "vocoder_conditioning", dev):
        mels = torch.nn.functional.pad(mels, (voc.pad, voc.pad))
        if fused:
            frames, phi, geo, fold_chunks = fused_conditioning(
                model, mels, total_len, target, overlap)
        else:
            mels_up, aux = model.upsample(mels)
            if batched:
                mels_up = fold_with_overlap(mels_up, target, overlap)
                aux = fold_with_overlap(aux, target, overlap)
    with stage(timings, "sample_kernel", dev):
        if fused:
            return generate_fused(model.core_weights(), frames, phi, geo.hop,
                                  -geo.d_lo, fold_chunks, voc.mode,
                                  noise=noise, seed=seed,
                                  sparse_packed=sparse_packed)
        return generate_materialized(model.core_weights(), mels_up, aux,
                                     voc.mode, noise=noise, seed=seed,
                                     sparse_packed=sparse_packed)[0]


def mu_law_decode(y, n_classes: int):
    """Expand mu-law samples in [-1, 1] (the RAW vocoder's output)."""
    mu = n_classes - 1
    return torch.sign(y) / mu * ((1 + mu) ** torch.abs(y) - 1)


@torch.no_grad()
def generate(model: WaveRNN, mels, *, batched: bool = True,
             target: Optional[int] = None, overlap: Optional[int] = None,
             mu_law: bool = True, noise=None,
             generator: Optional[torch.Generator] = None, device="cuda",
             timings: Optional[dict] = None, sparse_packed=None):
    """Utterance generation (fatchord_version.py:169-264; the JAX package's
    ``generate``).

    mels: (1, n_mels, T_frames) normalized mel in [0, 1] (tensor or array).
    ``batched`` folds the utterance into ``target`` + 2*``overlap``-sample
    segments generated as one batch and cross-faded back (the fused kernel
    B1 when target and overlap are multiples of hop, the materialized
    kernel B3 otherwise); ``batched=False`` generates one row over the
    whole utterance on B3. noise: injected sampling uniforms for replay
    (see ops/cuda_gen.py), (steps, rows, ...); None draws the kernels'
    counter-hash noise from a seed taken from ``generator``. Returns the
    float64 waveform ((T_frames-1)*hop,) on ``device``, with the
    reference's tail fade-out. On CUDA the sample loop multiplies bfloat16
    weights with float32 accumulation. ``timings``, when given, receives
    the device milliseconds of each stage. ``sparse_packed``:
    ``cuda_gen.pack_sparse(model.core_weights(), ...)`` of a block-pruned
    model, packed once after loading; the sample loop's per-step products
    then read only the live blocks (B9). An empty pack serves dense."""
    dev = resolve_device(device, model)
    voc, dsp = model.voc, model.dsp
    target = voc.target if target is None else target
    overlap = voc.overlap if overlap is None else overlap
    mels = torch.as_tensor(mels, dtype=torch.float32, device=dev)
    wave_len = (mels.shape[-1] - 1) * dsp.hop_length
    samples = _samples(model, mels, batched, target, overlap, noise,
                       _seed(noise, generator), timings, dev, sparse_packed)
    with stage(timings, "crossfade", dev):
        return _post(model, samples.to(torch.float64),
                     overlap if batched else None, wave_len, mu_law, True,
                     full_ramp=False)


@torch.no_grad()
def generate_fast(model: WaveRNN, mels, *, target: Optional[int] = None,
                  overlap: Optional[int] = None, mu_law: bool = True,
                  noise=None, generator: Optional[torch.Generator] = None,
                  device="cuda", tail_fade: bool = True,
                  timings: Optional[dict] = None, sparse_packed=None):
    """The serving path's fold-batched generation (``generate_fast`` and
    ``_generate_device``, wavernn_tpu/models/wavernn.py:283-391): the same
    sample loop as ``generate(batched=True)`` with the mu-law decode and the
    equal-power crossfade in float32 on the device. Returns the float32
    wave ((T_frames-1)*hop,) on the device. ``tail_fade=False`` skips the
    20-frame end fade, for callers that trim a bucket-padded wave and fade
    at its true end. ``sparse_packed`` as in ``generate``."""
    dev = resolve_device(device, model)
    voc, dsp = model.voc, model.dsp
    target = voc.target if target is None else target
    overlap = voc.overlap if overlap is None else overlap
    mels = torch.as_tensor(mels, dtype=torch.float32, device=dev)
    wave_len = (mels.shape[-1] - 1) * dsp.hop_length
    samples = _samples(model, mels, True, target, overlap, noise,
                       _seed(noise, generator), timings, dev, sparse_packed)
    with stage(timings, "crossfade", dev):
        return _post(model, samples, overlap, wave_len, mu_law, tail_fade)


def _post(model: WaveRNN, samples, overlap: Optional[int], wave_len: int,
          mu_law: bool, fade: bool, full_ramp: bool = True):
    """One utterance's samples -> its wave, in the samples' dtype: mu-law
    decode (RAW), the crossfade of its folds (``overlap``; None for one
    unbatched row), the trim to ``wave_len`` and the 20-frame tail fade
    (``fold.tail_fade``: the device paths' ``full_ramp``,
    _multi_post_jit, wavernn_tpu/models/wavernn.py:591-613)."""
    voc, dsp = model.voc, model.dsp
    if mu_law and voc.mode == "RAW":
        samples = mu_law_decode(samples, voc.n_classes(dsp.bits))
    wav = samples[0] if overlap is None else xfade_and_unfold(samples,
                                                              overlap)
    wav = wav[:wave_len]
    if not fade:
        return wav
    return fold.tail_fade(wav, 20 * dsp.hop_length, full_ramp=full_ramp)


@torch.no_grad()
def generate_multi(model: WaveRNN, mels_list, *, target: Optional[int] = None,
                   overlap: Optional[int] = None, mu_law: bool = True,
                   noise=None, generator: Optional[torch.Generator] = None,
                   device="cuda", device_out: bool = False,
                   tail_fade: bool = True, timings: Optional[dict] = None,
                   sparse_packed=None, mesh=None):
    """Vocode a batch of utterances in one sample-loop launch
    (wavernn_tpu/models/wavernn.py:394-541): one zero-padded MelResNet pass
    over the batch, every utterance folded, all folds concatenated on the
    fold axis into one launch (B1, or B3 when target and overlap are not
    hop multiples), then a per-utterance post-pass.

    mels_list: (n_mels, T) or (1, n_mels, T) mels in [0, 1]; noise: as in
    ``generate``, over the combined fold batch. Returns a list of waves:
    float32 tensors on the device with ``device_out`` (mu-law, crossfade
    and fade in float32 there), else float64 numpy arrays crossfaded on the
    device in float64 (``generate``'s precision). ``tail_fade=False`` skips
    the 20-frame end fade. ``sparse_packed`` as in ``generate``.

    ``mesh`` (``parallel/gen_sharded.generate_multi_sharded``, every rank
    calling with the same arguments): every rank builds the whole
    conditioning, launches the sample loop on its slice of the combined
    fold batch, the counter hash's rows set to the slice's so that the
    ranks draw the one-device launch's numbers, and gathers every rank's
    samples before the post-pass; each rank returns every wave."""
    from ..parallel.mesh import FoldShard, same_seed
    dev = resolve_device(device, model)
    voc, dsp = model.voc, model.dsp
    target = voc.target if target is None else target
    overlap = voc.overlap if overlap is None else overlap
    hop, pad = dsp.hop_length, voc.pad
    mels = [torch.as_tensor(m, dtype=torch.float32, device=dev)
            for m in mels_list]
    mels = [m[0] if m.dim() == 3 else m for m in mels]
    n_frames = [m.shape[-1] for m in mels]
    fused = fused_cond_ok(voc, dsp, target, overlap)
    with stage(timings, "vocoder_conditioning", dev):
        # zero-padding to a shared length leaves each utterance's valid
        # region unchanged: every conv sees zeros right of its pad frames
        # either way
        T_max = -(-max(n_frames) // 64) * 64
        batch = torch.stack([torch.nn.functional.pad(m, (0, T_max - n))
                             for m, n in zip(mels, n_frames)])
        mels_b = torch.nn.functional.pad(batch, (pad, pad))
        counts = []
        if fused:
            geo = P.geometry(voc.upsample_factors, pad)
            phi = P.phi_table(model.upsample.up_weights(),
                              voc.upsample_factors, geo).contiguous()
            aux_b = model.upsample.resnet(mels_b)
            frames = []
            for i, n in enumerate(n_frames):
                fr, fold_chunks = _fold_frames(
                    mels_b[i, :, :n + 2 * pad], aux_b[i, :, :n], n * hop,
                    target, overlap, geo)
                frames.append(fr)
                counts.append(fr.shape[1])
            frames = torch.cat(frames, dim=1)
        else:
            mu_b, au_b = model.upsample(mels_b)
            folds_m, folds_a = [], []
            for i, n in enumerate(n_frames):
                folds_m.append(fold_with_overlap(mu_b[i:i + 1, :n * hop],
                                                 target, overlap))
                folds_a.append(fold_with_overlap(au_b[i:i + 1, :n * hop],
                                                 target, overlap))
                counts.append(folds_m[-1].shape[0])
    seed = same_seed(_seed(noise, generator), mesh)
    sh = FoldShard(sum(counts), mesh)
    with stage(timings, "sample_kernel", dev):
        if fused:
            samples = generate_fused(model.core_weights(), sh.take(frames, 1),
                                     phi, geo.hop, -geo.d_lo, fold_chunks,
                                     voc.mode, noise=sh.noise(noise),
                                     seed=seed, sparse_packed=sparse_packed,
                                     **sh.rows())
        else:
            samples = generate_materialized(
                model.core_weights(), sh.take(torch.cat(folds_m), 0),
                sh.take(torch.cat(folds_a), 0), voc.mode,
                noise=sh.noise(noise), seed=seed,
                sparse_packed=sparse_packed, **sh.rows())[0]
        samples = sh.gather(samples)
    outs = []
    with stage(timings, "crossfade", dev):
        for y, n in zip(torch.split(samples, counts), n_frames):
            if device_out:
                outs.append(_post(model, y, overlap, (n - 1) * hop, mu_law,
                                  tail_fade))
            else:
                outs.append(_post(model, y.to(torch.float64), overlap,
                                  (n - 1) * hop, mu_law, tail_fade,
                                  full_ramp=False).cpu().numpy())
    return outs
