#!/usr/bin/env python
"""NB1 on the PyTorch package: fit the DeepMind coarse/fine WaveRNN to a
sine wave and generate from it (reference notebooks/NB1 - Fit a Sine
Wave.ipynb; the counterpart of ``examples/nb1_sine_fit.py``).

    python examples/torch_nb1_sine_fit.py --steps 300 --out outputs/nb1
    python examples/torch_nb1_sine_fit.py --device cpu --steps 2 --hidden 64
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np

from torch_deepmind_fit import fit_and_generate


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--hidden", type=int, default=896)
    parser.add_argument("--seq_len", type=int, default=960)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--gen_len", type=int, default=10_000)
    parser.add_argument("--sample_rate", type=int, default=24_000)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default="outputs/nb1")
    args = parser.parse_args(argv)

    sr = args.sample_rate
    t = np.arange(sr * 5) / sr
    x = np.sin(2 * np.pi * 220 * t) * 0.8
    return fit_and_generate((x * 2 ** 15).astype(np.int64), sr,
                            steps=args.steps, batch=args.batch,
                            seq_len=args.seq_len, gen_len=args.gen_len,
                            out_path=Path(args.out) / "model_output.wav",
                            hidden=args.hidden, device=args.device)


if __name__ == "__main__":
    main()
