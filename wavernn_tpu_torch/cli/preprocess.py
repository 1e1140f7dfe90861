"""CLI: dataset preprocessing with the PyTorch/CUDA port (reference
preprocess.py; the flag surface of ``wavernn_tpu.cli.preprocess``).

    python -m wavernn_tpu_torch.cli.preprocess --path /data/LJSpeech-1.1/wavs

Writes the dataset under the hparams' ``data_path`` (mel/, quant/,
dataset.pkl, text_dict.pkl from the ``metadata.csv`` beside the wav
directory), the same bytes the JAX package writes. Preprocessing is host
numpy over a process pool; ``--force_cpu`` is accepted and changes nothing.
"""
from __future__ import annotations

import argparse
from multiprocessing import cpu_count

from ..data.preprocess import preprocess
from ..utils.display import simple_table
from .common import load_config, make_workspace


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Preprocessing for WaveRNN and Tacotron (PyTorch)")
    parser.add_argument("--path", "-p", help="dataset wav dir (overrides "
                        "hparams wav_path)")
    parser.add_argument("--extension", "-e", default=".wav")
    parser.add_argument("--num_workers", "-w", type=int,
                        default=max(1, cpu_count() - 1))
    parser.add_argument("--hp_file", default=None)
    parser.add_argument("--force_cpu", "-c", action="store_true",
                        help="accepted for the JAX package's flag surface; "
                             "preprocessing is host work")
    args = parser.parse_args(argv)

    cfg = load_config(args.hp_file)
    ws = make_workspace(cfg)
    simple_table([
        ("Sample Rate", cfg.dsp.sample_rate),
        ("Bit Depth", cfg.dsp.bits),
        ("Mu Law", cfg.dsp.mu_law),
        ("Hop Length", cfg.dsp.hop_length),
        ("CPU Usage", f"{args.num_workers}/{cpu_count()}"),
    ])
    dataset = preprocess(cfg, ws, wav_path=args.path or cfg.wav_path,
                         extension=args.extension,
                         n_workers=args.num_workers)
    if dataset:
        print('Completed. Ready to run "python -m wavernn_tpu_torch.cli.'
              'train_tacotron" or "python -m wavernn_tpu_torch.cli.'
              'train_wavernn".')


if __name__ == "__main__":
    main()
