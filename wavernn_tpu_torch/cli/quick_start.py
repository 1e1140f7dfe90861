"""CLI: text -> wav from trained weights with the PyTorch/CUDA port
(reference quick_start.py).

Loads Tacotron and WaveRNN weights (reference ``.pyt`` checkpoints,
optionally inside the released zips, or the JAX trainer's ``.npz``) and
synthesizes the standard test sentences with fold-batched generation
(target 11000, overlap 550), or unbatched with ``-u``; ``-a`` writes each
sentence's attention beside its wav (``<wav name>.png``).

    python -m wavernn_tpu_torch.cli.quick_start \\
        --voc_weights pretrained/ljspeech.wavernn.mol.800k/latest_weights.pyt \\
        --tts_weights pretrained/ljspeech.tacotron.r2.180k/latest_weights.pyt
"""
from __future__ import annotations

import argparse
import zipfile
from pathlib import Path

import torch

from ..dsp.audio import save_wav
from ..synthesis import tts_to_wav
from ..utils.display import save_attention
from .common import load_config, load_tts_model, load_voc_model


def _maybe_unzip(pretrained_dir: Path):
    """Extract any pretrained zips in place (quick_start.py:12-21)."""
    for z in pretrained_dir.glob("*.zip"):
        out = pretrained_dir / z.stem
        if not out.exists():
            with zipfile.ZipFile(z) as f:
                f.extractall(out)
            print(f"Extracted {z.name}")


def main(argv=None):
    parser = argparse.ArgumentParser(description="TTS quick start (PyTorch)")
    parser.add_argument("--input_text", "-i", default=None)
    parser.add_argument("--batched", "-b", dest="unbatched",
                        action="store_false", help="fold-batched generation "
                        "(the default, like quick_start.py:29)")
    parser.add_argument("--unbatched", "-u", action="store_true")
    # fold-batched unless -u: the two flags share a dest, and argparse would
    # otherwise take --batched's store_false default (True) for it
    parser.set_defaults(unbatched=False)
    parser.add_argument("--save_attention", "-a", action="store_true")
    parser.add_argument("--voc_weights", default=None)
    parser.add_argument("--tts_weights", default=None)
    parser.add_argument("--pretrained_dir", default="pretrained")
    parser.add_argument("--hp_file", default=None)
    parser.add_argument("--out_dir", default="quick_start_output",
                        help="where the wavs go (the port's own flag; the "
                             "JAX package writes to quick_start_output)")
    parser.add_argument("--steps", type=int, default=2000,
                        help="most decoder frames per sentence (the port's "
                             "own flag; the JAX package fixes 2000)")
    parser.add_argument("--force_cpu", "-c", action="store_true",
                        help="run the plain PyTorch versions on the CPU")
    args = parser.parse_args(argv)
    device = "cpu" if args.force_cpu else "cuda"
    batched = not args.unbatched

    cfg = load_config(args.hp_file)
    pre = Path(args.pretrained_dir)
    if pre.exists():
        _maybe_unzip(pre)
    voc_weights = args.voc_weights or next(
        pre.rglob("*wavernn*/latest_weights.pyt"), None)
    tts_weights = args.tts_weights or next(
        pre.rglob("*tacotron*/latest_weights.pyt"), None)
    if voc_weights is None or tts_weights is None:
        raise SystemExit("No pretrained weights found; pass --voc_weights / "
                         "--tts_weights")
    voc, voc_step = load_voc_model(voc_weights, cfg, device)
    tts, tts_step, r = load_tts_model(tts_weights, cfg, device)
    print(f"| WaveRNN {voc_step // 1000}k, Tacotron {tts_step // 1000}k, "
          f"r={r}, " + (f"batched (target {cfg.voc.target}, overlap "
                        f"{cfg.voc.overlap})" if batched else "unbatched"))

    if args.input_text:
        inputs = [args.input_text.strip()]
    else:
        with open("test_sentences/sentences.txt") as f:
            inputs = [line.strip() for line in f if line.strip()]
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for i, text in enumerate(inputs, 1):
        print(f"| Generating {i}/{len(inputs)}: {text[:40]}")
        gen = torch.Generator().manual_seed(i)
        wav, _, attention = tts_to_wav(tts, voc, text, cfg, r,
                                       steps=args.steps, generator=gen,
                                       device=device, batched=batched)
        save_path = out_dir / f"{i}_batched{batched}_{tts_step // 1000}k.wav"
        if args.save_attention:
            save_attention(attention, save_path)
        save_wav(wav, save_path, cfg.dsp.sample_rate)
    print("Done.")


if __name__ == "__main__":
    main()
