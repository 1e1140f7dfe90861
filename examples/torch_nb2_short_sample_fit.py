#!/usr/bin/env python
"""NB2 on the PyTorch package: fit the DeepMind WaveRNN to one SHORT sample
and free-run it (reference notebooks/NB2 - Fit a Short Sample.ipynb: a ~9 s
female-vocal wav, batch 32, seq_len 960 random windows, 1000 steps, 10k
generated samples; the counterpart of ``examples/nb2_short_sample_fit.py``).

    python examples/torch_nb2_short_sample_fit.py [--wav your.wav] [--steps 1000]

Without --wav it trains on a synthetic vocal-like signal (a vibrato
harmonic stack), so the recipe needs no download.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np

from torch_deepmind_fit import fit_and_generate

SR = 22050


def synthetic_vocal(sr, seconds=9.0):
    """A vocal-like stand-in: an f0 glide with vibrato, a decaying harmonic
    stack, soft phrase envelopes."""
    t = np.arange(int(sr * seconds)) / sr
    f0 = 330 * 2 ** (0.3 * np.sin(2 * np.pi * 0.15 * t))     # slow glide
    f0 = f0 * (1 + 0.01 * np.sin(2 * np.pi * 5.5 * t))       # vibrato
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = sum((0.6 ** k) * np.sin((k + 1) * phase) for k in range(6))
    env = 0.55 + 0.45 * np.sin(2 * np.pi * 0.4 * t - np.pi / 2)
    x = x * env / np.max(np.abs(x))
    return (x * 0.8 * 2 ** 15).astype(np.int16)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--wav", default=None)
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--seq_len", type=int, default=960)
    parser.add_argument("--gen_len", type=int, default=10_000)
    parser.add_argument("--hidden", type=int, default=896)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default="outputs/nb2")
    args = parser.parse_args(argv)

    if args.wav:
        from scipy.io import wavfile
        sr, sig = wavfile.read(args.wav)
    else:
        sr, sig = SR, synthetic_vocal(SR)
    return fit_and_generate(
        sig, sr, steps=args.steps, batch=args.batch, seq_len=args.seq_len,
        gen_len=args.gen_len, hidden=args.hidden, device=args.device,
        out_path=Path(args.out) / f"{args.steps // 1000}k_steps.wav")


if __name__ == "__main__":
    main()
