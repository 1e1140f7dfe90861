"""Griffin-Lim vocoder (reference utils/dsp.py:105-116; port of
``wavernn_tpu.dsp.griffinlim``).

The reference inverts the mel with librosa's NNLS and runs
librosa.griffinlim on the host. Here the whole inversion stays on the
device: a multiplicative-update NNLS solve for mel -> linear magnitude,
then Griffin-Lim phase recovery with momentum over STFT/ISTFT round trips
(cuFFT on the card), read back once at the end.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DSPConfig
from ..device import resolve_device
from .mel import db_to_amp, denormalize, filterbank_tensor, stft, \
    window_tensor


@lru_cache(maxsize=16)
def _window_sum_square(n_fft: int, hop_length: int, win_length: int,
                       n_frames: int, device: torch.device,
                       dtype: torch.dtype) -> torch.Tensor:
    """The overlap-added squared window, floored at 1e-10, (total,)."""
    w2 = window_tensor(win_length, n_fft, device, dtype) ** 2
    total = n_fft + hop_length * (n_frames - 1)
    wss = F.fold(w2[None, :, None].expand(1, n_fft, n_frames).contiguous(),
                 (1, total), (1, n_fft), stride=(1, hop_length))
    return torch.clamp(wss.reshape(total), min=1e-10)


def istft(D: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
          length: Optional[int] = None) -> torch.Tensor:
    """Inverse STFT with window-sum-square normalisation (istft_jax,
    wavernn_tpu/dsp/griffinlim.py:20-38): (..., F, T) complex ->
    (..., samples) real, on D's device. The frames overlap-add through
    ``F.fold``; the sum is divided by max(wss, 1e-10) and trimmed by
    n_fft//2 at both ends, then to ``length``."""
    real = D.real.dtype
    window = window_tensor(win_length, n_fft, D.device, real)
    frames = torch.fft.irfft(D.transpose(-1, -2), n=n_fft, dim=-1) * window
    lead, n_frames = frames.shape[:-2], frames.shape[-2]
    total = n_fft + hop_length * (n_frames - 1)
    y = F.fold(frames.reshape(-1, n_frames, n_fft).transpose(1, 2),
               (1, total), (1, n_fft), stride=(1, hop_length))
    y = y.reshape(*lead, total) / _window_sum_square(
        n_fft, hop_length, win_length, n_frames, D.device, real)
    y = y[..., n_fft // 2: total - n_fft // 2]
    if length is not None:
        y = y[..., :length]
    return y


def mel_to_stft(amp_mel: torch.Tensor, cfg: DSPConfig,
                n_iter: int = 200) -> torch.Tensor:
    """Invert the mel filterbank by NNLS with multiplicative updates
    (mel_to_stft_jax, wavernn_tpu/dsp/griffinlim.py:41-58): (..., num_mels,
    T) linear-amplitude mel -> (..., 1+n_fft//2, T) >= 0, on amp_mel's
    device. Bᵀ M is the same every iteration and is computed once."""
    B = filterbank_tensor(cfg, amp_mel.device, amp_mel.dtype)
    num = B.T @ amp_mel
    X = torch.clamp(num, min=1e-10)
    for _ in range(n_iter):
        den = B.T @ (B @ X)
        X = torch.clamp(X * num / torch.clamp(den, min=1e-10), min=0.0)
    return X


def griffinlim(S: torch.Tensor, cfg: DSPConfig, n_iter: int = 32,
               length: Optional[int] = None, momentum: float = 0.99,
               generator: Optional[torch.Generator] = None,
               phase_u=None) -> torch.Tensor:
    """Griffin-Lim with momentum (griffinlim_jax,
    wavernn_tpu/dsp/griffinlim.py:61-85; librosa.griffinlim semantics):
    (..., F, T) magnitude -> (..., samples), in float32 / complex64 on S's
    device.

    The initial phase is exp(2πi·u) of a uniform draw u in [0, 1) of
    S.shape: ``phase_u`` injects it (a tensor or array), else it is drawn
    from ``generator`` (on the generator's device), else from a generator
    seeded with 0."""
    S = S.to(torch.float32)
    if phase_u is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        phase_u = torch.rand(S.shape, generator=generator,
                             device=generator.device)
    if not torch.is_tensor(phase_u):
        phase_u = torch.from_numpy(np.array(phase_u, dtype=np.float32))
    u = phase_u.to(device=S.device, dtype=torch.float32)
    angles = torch.polar(torch.ones_like(u), (2.0 * math.pi) * u)
    tprev = torch.zeros_like(angles)
    n_fft, hop, win = cfg.n_fft, cfg.hop_length, cfg.win_length
    beta = momentum / (1 + momentum)
    for _ in range(n_iter):
        inv = istft(S * angles, n_fft, hop, win)
        rebuilt = stft(inv, n_fft, hop, win, device=S.device)
        rebuilt = rebuilt[..., : S.shape[-1]]
        t = rebuilt - beta * tprev
        angles = t / torch.clamp(t.abs(), min=1e-16)
        tprev = rebuilt
    return istft(S * angles, n_fft, hop, win, length=length)


def reconstruct_waveform(mel, cfg: DSPConfig, n_iter: int = 32,
                         device="cuda",
                         generator: Optional[torch.Generator] = None,
                         phase_u=None) -> np.ndarray:
    """Normalised [0, 1] mel (num_mels, T) -> waveform by NNLS and
    Griffin-Lim (reconstruct_waveform, wavernn_tpu/dsp/griffinlim.py:88-94;
    reference dsp.py:105). The amplitude is computed on the host in
    float64 and moved to ``device`` as float32; the wave is read back
    once. ``generator`` / ``phase_u`` as in ``griffinlim``. Returns a
    float32 numpy array."""
    dev = resolve_device(device)
    amp = db_to_amp(denormalize(np.asarray(mel, dtype=np.float64),
                                cfg.min_level_db))
    S = mel_to_stft(torch.as_tensor(amp, dtype=torch.float32, device=dev),
                    cfg)
    wav = griffinlim(S, cfg, n_iter=n_iter, generator=generator,
                     phase_u=phase_u)
    return wav.cpu().numpy()
