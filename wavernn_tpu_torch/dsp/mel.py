"""Spectrogram pipeline: STFT -> mel -> dB -> normalize (port of
``wavernn_tpu.dsp.mel``).

The reference analysis chain (utils/dsp.py:41-81, librosa 0.6.3 semantics):

  * STFT: periodic Hann window of ``win_length`` zero-padded, centred, to
    ``n_fft``; the signal reflect-padded by ``n_fft//2``; rfft per frame.
  * mel filterbank: Slaney scale, Slaney area normalisation (librosa
    ``htk=False, norm=1``), ``fmin``..``sr/2``.
  * amp_to_db: ``20*log10(max(1e-5, x))``; normalised to [0, 1] against
    ``min_level_db``. The reference subtracts ``ref_level_db`` in the
    *linear* spectrogram path only (dsp.py:68), never in the mel path
    (dsp.py:74); both halves here keep that.

The numpy half is the host path of preprocessing, so the port's
datasets are the JAX package's bytes. The torch half (``stft``,
``melspectrogram``) is batched over leading axes and runs on the card
unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..config import DSPConfig
from ..device import resolve_device


# --------------------------------------------------------------------------
# window + filterbank construction (numpy, cached)
# --------------------------------------------------------------------------

def hann_window(win_length: int) -> np.ndarray:
    """Periodic (fftbins=True) Hann window, scipy/librosa convention."""
    n = np.arange(win_length)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    above = f >= min_log_hz
    return np.where(above, min_log_mel
                    + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    mel)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    f = m * f_sp
    above = m >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f)


@lru_cache(maxsize=8)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int,
                   fmin: float, fmax: float | None = None) -> np.ndarray:
    """Slaney-normalised triangular mel filterbank, shape
    (n_mels, 1+n_fft//2), float64 (librosa.filters.mel(sr, n_fft, n_mels,
    fmin))."""
    if fmax is None:
        fmax = sample_rate / 2.0
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax),
                          n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney area normalisation
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float64)


@lru_cache(maxsize=8)
def _padded_window(win_length: int, n_fft: int) -> np.ndarray:
    w = hann_window(win_length)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        w = np.pad(w, (lpad, n_fft - win_length - lpad))
    return w


# --------------------------------------------------------------------------
# numpy reference path (host / preprocess)
# --------------------------------------------------------------------------

def stft_np(y: np.ndarray, n_fft: int, hop_length: int, win_length: int,
            center: bool = True) -> np.ndarray:
    """Complex STFT, shape (1+n_fft//2, n_frames). librosa.stft semantics."""
    y = np.asarray(y, dtype=np.float64)
    if center:
        y = np.pad(y, n_fft // 2, mode="reflect")
    window = _padded_window(win_length, n_fft)
    n_frames = 1 + (len(y) - n_fft) // hop_length
    strides = (y.strides[0] * hop_length, y.strides[0])
    frames = np.lib.stride_tricks.as_strided(y, (n_frames, n_fft), strides)
    return np.fft.rfft(frames * window, axis=-1).T


def istft_np(D: np.ndarray, hop_length: int, win_length: int, n_fft: int,
             length: int | None = None) -> np.ndarray:
    """Inverse STFT with window-sum-square normalisation."""
    window = _padded_window(win_length, n_fft)
    frames = np.fft.irfft(D.T, n=n_fft, axis=-1) * window
    n_frames = frames.shape[0]
    total = n_fft + hop_length * (n_frames - 1)
    y = np.zeros(total)
    wss = np.zeros(total)
    w2 = window ** 2
    for i in range(n_frames):
        s = i * hop_length
        y[s: s + n_fft] += frames[i]
        wss[s: s + n_fft] += w2
    y = y / np.maximum(wss, 1e-10)
    y = y[n_fft // 2: total - n_fft // 2]
    if length is not None:
        y = y[:length]
    return y


def amp_to_db(x):
    return 20.0 * np.log10(np.maximum(1e-5, x))


def db_to_amp(x):
    return np.power(10.0, x * 0.05)


def normalize(S, min_level_db: float = -100.0):
    return np.clip((S - min_level_db) / -min_level_db, 0, 1)


def denormalize(S, min_level_db: float = -100.0):
    return (np.clip(S, 0, 1) * -min_level_db) + min_level_db


def melspectrogram_np(y: np.ndarray, cfg: DSPConfig) -> np.ndarray:
    """Normalised mel spectrogram in [0, 1], shape (num_mels, T), float32
    (dsp.py:72)."""
    D = stft_np(y, cfg.n_fft, cfg.hop_length, cfg.win_length)
    basis = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.num_mels, cfg.fmin)
    S = amp_to_db(basis @ np.abs(D))
    return normalize(S, cfg.min_level_db).astype(np.float32)


def spectrogram_np(y: np.ndarray, cfg: DSPConfig) -> np.ndarray:
    """Normalised linear spectrogram (dsp.py:66)."""
    D = stft_np(y, cfg.n_fft, cfg.hop_length, cfg.win_length)
    S = amp_to_db(np.abs(D)) - cfg.ref_level_db
    return normalize(S, cfg.min_level_db).astype(np.float32)


# --------------------------------------------------------------------------
# torch path (on the device, batched)
# --------------------------------------------------------------------------

@lru_cache(maxsize=16)
def window_tensor(win_length: int, n_fft: int, device: torch.device,
                  dtype: torch.dtype) -> torch.Tensor:
    """``_padded_window`` as a tensor: the periodic Hann of ``win_length``
    centred in ``n_fft`` (lpad = (n_fft - win) // 2)."""
    return torch.as_tensor(_padded_window(win_length, n_fft), dtype=dtype,
                           device=device)


@lru_cache(maxsize=16)
def filterbank_tensor(cfg: DSPConfig, device: torch.device,
                      dtype: torch.dtype) -> torch.Tensor:
    """``mel_filterbank`` of ``cfg`` as a (num_mels, 1+n_fft//2) tensor."""
    return torch.as_tensor(
        mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.num_mels, cfg.fmin),
        dtype=dtype, device=device)


def stft(y, n_fft: int, hop_length: int, win_length: int, device="cuda",
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Batched complex STFT (stft_jax, wavernn_tpu/dsp/mel.py:172-185):
    (..., T) -> (..., 1+n_fft//2, n_frames) on ``device``, in the complex
    type of ``dtype``. ``y`` is a tensor or an array; it is moved to
    ``device`` and cast to ``dtype``."""
    y = torch.as_tensor(y).to(device=resolve_device(device), dtype=dtype)
    lead, T = y.shape[:-1], y.shape[-1]
    D = torch.stft(y.reshape(-1, T), n_fft, hop_length, n_fft,
                   window=window_tensor(win_length, n_fft, y.device, y.dtype),
                   center=True, pad_mode="reflect", return_complex=True)
    return D.reshape(*lead, *D.shape[-2:])


def melspectrogram(y, cfg: DSPConfig, device="cuda",
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Batched normalised mel spectrogram (melspectrogram_jax,
    wavernn_tpu/dsp/mel.py:188-198): (..., T) -> (..., num_mels, frames) in
    [0, 1] on ``device``."""
    D = stft(y, cfg.n_fft, cfg.hop_length, cfg.win_length, device, dtype)
    basis = filterbank_tensor(cfg, D.device, dtype)
    S = torch.einsum("mf,...ft->...mt", basis, D.abs())
    S_db = 20.0 * torch.log10(torch.clamp(S, min=1e-5))
    return torch.clamp((S_db - cfg.min_level_db) / -cfg.min_level_db, 0.0,
                       1.0)
