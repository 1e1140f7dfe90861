"""Batched-folding long-utterance generation (reference
fatchord_version.py:281-405; port of ``wavernn_tpu.ops.fold``).

One utterance's conditioning is folded into overlapping segments that run
as the batch of the sample loop (each fold warms its state up on
``overlap`` samples of the previous fold's conditioning), then the folds
are equal-power cross-faded back into one waveform.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def num_folds_for(total_len: int, target: int, overlap: int) -> int:
    num_folds = (total_len - overlap) // (target + overlap)
    extended_len = num_folds * (overlap + target) + overlap
    if total_len - extended_len != 0:
        num_folds += 1
    return num_folds


def fold_with_overlap(x, target: int, overlap: int):
    """(1, T, C) -> (num_folds, target + 2*overlap, C); zero-pads the last
    fold (fatchord_version.py:293-340)."""
    _, total_len, _ = x.shape
    num_folds = num_folds_for(total_len, target, overlap)
    length = target + 2 * overlap
    padding = num_folds * (target + overlap) + overlap - total_len
    if padding:
        x = F.pad(x, (0, 0, 0, padding))
    starts = torch.arange(num_folds, device=x.device) * (target + overlap)
    idx = starts[:, None] + torch.arange(length, device=x.device)[None, :]
    return x[0][idx]


def _fades(overlap: int, dtype, device):
    silence_len = overlap // 2
    fade_len = overlap - silence_len
    t = torch.linspace(-1, 1, fade_len, dtype=dtype, device=device)
    fade_in = torch.cat([torch.zeros(silence_len, dtype=dtype, device=device),
                         torch.sqrt(0.5 * (1 + t))])
    fade_out = torch.cat([torch.ones(silence_len, dtype=dtype, device=device),
                          torch.sqrt(0.5 * (1 - t))])
    return fade_in, fade_out


def xfade_and_unfold(y, overlap: int):
    """(num_folds, target + 2*overlap) -> (num_folds*(target+overlap) +
    overlap,) overlap-added with the equal-power crossfade and silence
    warm-up (fatchord_version.py:342-405). Runs on y's device in y's dtype
    (the synthesis path passes float64, the reference's host precision).

    Folds overlap only pairwise when target >= overlap, so the overlap-add
    is slicing: per-fold bodies plus one boundary sum per fold pair."""
    num_folds, length = y.shape
    target = length - 2 * overlap
    fade_in, fade_out = _fades(overlap, y.dtype, y.device)
    y = y.clone()
    y[:, :overlap] *= fade_in
    y[:, -overlap:] *= fade_out
    if target < overlap:
        total_len = num_folds * (target + overlap) + overlap
        starts = torch.arange(num_folds, device=y.device) * (target + overlap)
        idx = starts[:, None] + torch.arange(length, device=y.device)[None]
        out = y.new_zeros(total_len)
        return out.index_add_(0, idx.reshape(-1), y.reshape(-1))
    bodies = y[:, overlap:target + overlap]
    bounds = y[:, target + overlap:].clone()
    bounds[:num_folds - 1] += y[1:, :overlap]
    return torch.cat([y[0, :overlap],
                      torch.cat([bodies, bounds], dim=1).reshape(-1)])


def tail_fade(wav, n_fade: int, full_ramp: bool = False):
    """Linear fade to silence over the last ``n_fade`` samples. A wave
    shorter than that gets a ramp of its own length (the reference's host
    fade) or, with ``full_ramp``, the tail of the ``n_fade``-sample ramp
    (the JAX package's device paths)."""
    n = min(n_fade, wav.shape[0])
    ramp = torch.linspace(1, 0, n_fade if full_ramp else n, dtype=wav.dtype,
                          device=wav.device)
    wav = wav.clone()
    wav[wav.shape[0] - n:] *= ramp[ramp.shape[0] - n:]
    return wav
