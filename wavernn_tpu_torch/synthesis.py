"""Synthesis flows (port of ``wavernn_tpu.synthesis``): copy-synthesis of
held-out items and text -> wav with the WaveRNN vocoder (reference
gen_wavernn.py:11-35, gen_tacotron.py:142-173)."""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .config import Config
from .device import resolve_device
from .dsp.audio import decode_mu_law, label_2_float, save_wav
from .models import tacotron as taco
from .models import wavernn as wr
from .text import text_to_sequence


def tts_to_wav(tts_model: taco.Tacotron, voc_model: wr.WaveRNN, text: str,
               cfg: Config, r: int, steps: int = 2000,
               generator: Optional[torch.Generator] = None, noise=None,
               target: Optional[int] = None, overlap: Optional[int] = None,
               device="cuda", timings: Optional[dict] = None):
    """Full text -> waveform with the fold-batched WaveRNN vocoder.

    The postnet output conditions the vocoder, rescaled [-4, 4] -> [0, 1]
    (gen_tacotron.py:145). ``generator`` seeds the vocoder's sampling
    noise; ``noise`` injects it instead (replay). ``timings``, when given,
    receives CUDA-event records of each stage (see timing.elapsed_ms).
    Returns (wav float64, mel, attention) as numpy arrays."""
    dev = resolve_device(device, tts_model, voc_model)
    x = text_to_sequence(text.strip(), cfg.tts.cleaner_names)
    _, m, attention = taco.generate(tts_model, np.asarray(x), r, steps=steps,
                                    device=dev, timings=timings)
    m = np.clip((m + 4.0) / 8.0, 0.0, 1.0)
    wav = wr.generate(voc_model, m[None],
                      target=cfg.voc.target if target is None else target,
                      overlap=cfg.voc.overlap if overlap is None else overlap,
                      mu_law=cfg.dsp.mu_law, noise=noise, generator=generator,
                      device=dev, timings=timings)
    return wav.cpu().numpy(), m, attention


def gen_testset(voc_model: wr.WaveRNN, test_set, samples: int, target: int,
                overlap: int, save_path, cfg: Config, step: int = 0,
                generator: Optional[torch.Generator] = None, log=print,
                device="cuda"):
    """Copy-synthesis of held-out items (gen_wavernn.py:11-35): saves the
    decoded ground truth next to the model's output, generated through the
    fused, fold-batched ``wavernn.generate`` (the sample-loop kernel on
    CUDA). Returns the paths of the generated wavs."""
    generator = (generator if generator is not None
                 else torch.Generator().manual_seed(0))
    k = step // 1000
    save_path = Path(save_path)
    out = []
    for i in range(min(samples, len(test_set))):
        m, x = test_set[i]
        log(f"| Generating: {i + 1}/{samples}")
        bits = 16 if cfg.voc.mode == "MOL" else cfg.dsp.bits
        if cfg.dsp.mu_law and cfg.voc.mode != "MOL":
            gt = decode_mu_law(x, 2 ** bits, from_labels=True)
        else:
            gt = label_2_float(x.astype(np.float64), bits)
        save_wav(gt, save_path / f"{k}k_steps_{i + 1}_target.wav",
                 cfg.dsp.sample_rate)
        wav = wr.generate(voc_model, m[None], target=target, overlap=overlap,
                          mu_law=cfg.dsp.mu_law, generator=generator,
                          device=device)
        path = (save_path / f"{k}k_steps_{i + 1}_gen_batched_target{target}"
                f"_overlap{overlap}.wav")
        save_wav(wav.cpu().numpy(), path, cfg.dsp.sample_rate)
        out.append(path)
    return out
