#!/usr/bin/env python
"""NB2-NB4 with the conditioned (fatchord) WaveRNN on the PyTorch package:
fit it to a single wav and copy-synthesize it back (reference notebooks
NB2-NB4b, the "alternative model" RAW training path; the counterpart of
``examples/nb4_conditioned_fit.py``). Training runs the GRUs on kernel B5
and generation the sample loop on B1/B3 on the card.

    python examples/torch_nb4_conditioned_fit.py --wav path/to.wav --steps 500
    python examples/torch_nb4_conditioned_fit.py --device cpu --steps 2

Without --wav it trains on a synthetic harmonic signal.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--wav", default=None)
    parser.add_argument("--steps", type=int, default=500)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--seconds", type=float, default=8.0,
                        help="synthetic signal length")
    parser.add_argument("--gen_frames", type=int, default=200)
    parser.add_argument("--rnn_dims", type=int, default=512)
    parser.add_argument("--fc_dims", type=int, default=512)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default="outputs/nb4")
    args = parser.parse_args(argv)

    import torch

    from wavernn_tpu_torch.config import Config, WaveRNNConfig
    from wavernn_tpu_torch.data.dataset import collate_vocoder
    from wavernn_tpu_torch.device import resolve_device
    from wavernn_tpu_torch.dsp.audio import encode_mu_law, load_wav, save_wav
    from wavernn_tpu_torch.dsp.mel import melspectrogram_np
    from wavernn_tpu_torch.models import wavernn as wr
    from wavernn_tpu_torch.train import wavernn_train as wt

    dev = resolve_device(args.device)
    cfg = Config(voc=WaveRNNConfig(mode="RAW", rnn_dims=args.rnn_dims,
                                   fc_dims=args.fc_dims))
    sr = cfg.dsp.sample_rate
    if args.wav:
        y = load_wav(args.wav, sr)
    else:
        t = np.arange(int(sr * args.seconds)) / sr
        y = (0.5 * np.sin(2 * np.pi * 220 * t)
             + 0.25 * np.sin(2 * np.pi * 440 * t)
             + 0.12 * np.sin(2 * np.pi * 880 * t)).astype(np.float32)
    mel = melspectrogram_np(y, cfg.dsp)
    quant = encode_mu_law(y, 2 ** cfg.dsp.bits).astype(np.int64)

    state = wt.create_train_state(cfg.voc, cfg.dsp, lr=1e-3, device=dev)
    rng = np.random.RandomState(0)
    start = time.time()
    for i in range(1, args.steps + 1):
        x, yb, m = collate_vocoder([(mel, quant)] * args.batch, cfg, rng)
        metrics = wt.train_step(
            state, torch.as_tensor(x, device=dev),
            torch.as_tensor(yb, device=dev),
            torch.as_tensor(m, device=dev), cfg.voc)
        if i % 25 == 0 or i == args.steps:
            print(f"step {i}/{args.steps} loss {float(metrics['loss']):.3f} "
                  f"({i / (time.time() - start):.1f} steps/s)")

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    n_frames = min(mel.shape[1], args.gen_frames)
    print("generating...")
    wav = wr.generate(state.model, mel[None, :, :n_frames], batched=True,
                      target=11000, overlap=550, mu_law=True,
                      generator=torch.Generator().manual_seed(1), device=dev)
    wav = wav.cpu().numpy()
    save_wav(wav, out / "copy_synthesis.wav", sr)
    save_wav(y[: len(wav)], out / "target.wav", sr)
    print(f"saved {out}/copy_synthesis.wav")
    return wav


if __name__ == "__main__":
    main()
