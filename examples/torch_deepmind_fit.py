"""Shared harness of the single-signal DeepMind WaveRNN recipes on the
PyTorch package (the counterpart of ``examples/deepmind_fit.py``).

The reference notebooks NB2/NB3 split one wav into coarse/fine bytes, train
the dual-softmax WaveRNN on random 960-sample windows (truncated BPTT),
then free-run the model and save the wav. Only the source signal, the
batch size and the step budget differ: this module holds the common loop,
``torch_nb2_short_sample_fit.py`` and ``torch_nb3_long_sample_fit.py`` set
the configurations. Everything runs on the card unless ``device="cpu"``.
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np


def fit_and_generate(signal_i16, sample_rate, *, steps, batch, seq_len,
                     gen_len, out_path, hidden=896, lr=1e-3, log_every=25,
                     seed=0, device="cuda"):
    """Train on random windows of one int16 signal with Adam; save the
    free-run wav. Returns the generated waveform in [-1, 1)."""
    import torch

    from wavernn_tpu_torch.device import resolve_device
    from wavernn_tpu_torch.dsp.audio import save_wav, split_signal
    from wavernn_tpu_torch.models import deepmind as dm

    dev = resolve_device(device)
    coarse, fine = split_signal(np.asarray(signal_i16).astype(np.int64))
    model = dm.DeepMindWaveRNN(hidden)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model = model.to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    rng = np.random.RandomState(seed)

    start = time.time()
    for i in range(1, steps + 1):
        starts = rng.randint(0, len(coarse) - seq_len - 1, batch)
        cb = torch.as_tensor(np.stack([coarse[s:s + seq_len + 1]
                                       for s in starts]), device=dev)
        fb = torch.as_tensor(np.stack([fine[s:s + seq_len + 1]
                                       for s in starts]), device=dev)
        loss = dm.nll_loss(model, cb, fb)
        opt.zero_grad()
        loss.backward()
        opt.step()
        if i % log_every == 0 or i == steps:
            speed = i / (time.time() - start)
            print(f"step {i}/{steps} loss {loss.item():.3f} "
                  f"({speed:.1f} steps/s)")

    print(f"generating {gen_len} samples...")
    sig, _, _ = model.generate(
        gen_len, generator=torch.Generator().manual_seed(seed + 1))
    wav = sig.cpu().numpy() / 2 ** 15
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    save_wav(wav, out_path, sample_rate)
    print(f"saved {out_path}")
    return wav
