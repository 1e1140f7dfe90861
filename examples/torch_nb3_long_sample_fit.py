#!/usr/bin/env python
"""NB3 on the PyTorch package: fit the DeepMind WaveRNN to one LONG sample
(reference notebooks/NB3 - Fit a 30min Sample.ipynb: a 30-min podcast wav,
batch 128, seq_len 960 random windows, 10k steps, 5 s of generated audio;
the counterpart of ``examples/nb3_long_sample_fit.py``).

    python examples/torch_nb3_long_sample_fit.py [--wav podcast.wav] \
        [--minutes 30] [--steps 10000]

Without --wav it synthesizes a podcast-like signal (speech-band noise
bursts over a low hum) of the requested length.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np

from torch_deepmind_fit import fit_and_generate

SR = 22050


def synthetic_podcast(sr, minutes=2.0, seed=0):
    """A speech-like stand-in: syllabic AM noise through a crude
    resonance, plus room hum."""
    rng = np.random.RandomState(seed)
    n = int(sr * 60 * minutes)
    x = rng.randn(n)
    x = np.convolve(x, [0.25, 0.5, 0.25], mode="same")       # speech-band lp
    x = np.convolve(x, [1.0, -0.95], mode="same")            # de-emphasis
    t = np.arange(n) / sr
    syllables = np.clip(np.sin(2 * np.pi * 3.3 * t)
                        + 0.6 * np.sin(2 * np.pi * 0.37 * t), 0, None)
    x = x * syllables + 0.05 * np.sin(2 * np.pi * 60 * t)
    x = x / np.max(np.abs(x))
    return (x * 0.7 * 2 ** 15).astype(np.int16)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--wav", default=None)
    parser.add_argument("--minutes", type=float, default=2.0,
                        help="synthetic signal length (the notebook's "
                             "podcast is 30)")
    parser.add_argument("--steps", type=int, default=10_000)
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--seq_len", type=int, default=960)
    parser.add_argument("--gen_seconds", type=float, default=5.0)
    parser.add_argument("--hidden", type=int, default=896)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default="outputs/nb3")
    args = parser.parse_args(argv)

    if args.wav:
        from scipy.io import wavfile
        sr, sig = wavfile.read(args.wav)
    else:
        sr, sig = SR, synthetic_podcast(SR, args.minutes)
    return fit_and_generate(
        sig, sr, steps=args.steps, batch=args.batch, seq_len=args.seq_len,
        gen_len=int(sr * args.gen_seconds), hidden=args.hidden,
        device=args.device, log_every=100,
        out_path=Path(args.out) / f"{args.steps // 1000}k_steps.wav")


if __name__ == "__main__":
    main()
