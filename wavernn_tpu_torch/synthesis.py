"""Text -> wav synthesis (port of ``wavernn_tpu.synthesis.tts_to_wav``,
the WaveRNN branch; reference gen_tacotron.py:142-173)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import Config
from .device import resolve_device
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
