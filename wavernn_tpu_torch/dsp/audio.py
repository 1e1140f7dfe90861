"""Waveform I/O and quantization (reference utils/dsp.py:8-38,92-103).

Copied from ``wavernn_tpu.dsp.audio``: pure numpy host helpers.
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
from scipy.io import wavfile


def label_2_float(x, bits):
    """Map integer labels [0, 2**bits-1] -> floats [-1, 1] (dsp.py:8)."""
    return 2 * x / (2 ** bits - 1.0) - 1.0


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
