"""Waveform I/O and quantization (reference utils/dsp.py:8-38,84-103).

Copied from ``wavernn_tpu.dsp.audio``: pure numpy host helpers. No
librosa: wav I/O goes through scipy, and a wav whose sample rate is not the
expected one raises (no resampling).
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
from scipy.io import wavfile


def label_2_float(x, bits):
    """Map integer labels [0, 2**bits-1] -> floats [-1, 1] (dsp.py:8)."""
    return 2 * x / (2 ** bits - 1.0) - 1.0


def float_2_label(x, bits):
    """Map floats [-1, 1] -> clipped labels [0, 2**bits-1] (dsp.py:12)."""
    assert np.abs(x).max() <= 1.0
    x = (x + 1.0) * (2 ** bits - 1) / 2
    return np.clip(x, 0, 2 ** bits - 1)


def load_wav(path, sample_rate: int = 22050) -> np.ndarray:
    """Load a PCM16/PCM32/uint8/float wav as float32 in [-1, 1], downmixed
    to mono (dsp.py:18). A sample rate other than ``sample_rate`` raises."""
    sr, data = wavfile.read(str(path))
    if sr != sample_rate:
        raise ValueError(f"{path}: sample rate {sr} != expected {sample_rate} "
                         "(resampling is not performed)")
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:  # downmix
        data = data.mean(axis=1)
    return data


def save_wav(x, path, sample_rate: int = 22050):
    """Save float waveform in [-1, 1] as PCM16 wav (dsp.py:22)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    x = np.asarray(x, dtype=np.float64)
    pcm = np.clip(x * 2 ** 15, -2 ** 15, 2 ** 15 - 1).astype(np.int16)
    wavfile.write(str(path), sample_rate, pcm)


def decode_mu_law(y, mu, from_labels: bool = True):
    """Inverse mu-law (dsp.py:98), including the reference's use of
    log2(mu) bits when decoding from labels."""
    if from_labels:
        y = label_2_float(y, math.log2(mu))
    mu = mu - 1
    return np.sign(y) / mu * ((1 + mu) ** np.abs(y) - 1)


def split_signal(x):
    """16-bit signal -> (coarse, fine) 8-bit pair (dsp.py:26)."""
    unsigned = x + 2 ** 15
    return unsigned // 256, unsigned % 256


def combine_signal(coarse, fine):
    """(coarse, fine) -> 16-bit signal (dsp.py:33)."""
    return coarse * 256 + fine - 2 ** 15


def encode_16bits(x):
    return np.clip(x * 2 ** 15, -2 ** 15, 2 ** 15 - 1).astype(np.int16)


def encode_mu_law(x, mu):
    """mu-law companding to integer labels [0, mu-1] (dsp.py:92)."""
    mu = mu - 1
    fx = np.sign(x) * np.log(1 + mu * np.abs(x)) / np.log(1 + mu)
    return np.floor((fx + 1) / 2 * mu + 0.5)


def pre_emphasis(x, coeff: float = 0.97):
    """y[n] = x[n] - coeff*x[n-1] (dsp.py:84, scipy lfilter([1,-c],[1],x))."""
    x = np.asarray(x)
    y = np.empty_like(x, dtype=np.float64)
    y[..., 0] = x[..., 0]
    y[..., 1:] = x[..., 1:] - coeff * x[..., :-1]
    return y


def de_emphasis(x, coeff: float = 0.97):
    """IIR inverse of pre_emphasis (dsp.py:88)."""
    from scipy.signal import lfilter
    return lfilter([1], [1, -coeff], x)
