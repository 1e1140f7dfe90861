"""Polyphase form of the WaveRNN mel upsampler (port of
``wavernn_tpu.ops.polyphase``).

The reference upsampler (fatchord_version.py:64-89) is a nearest-neighbour
stretch followed by an odd-length averaging conv, once per scale: a
linear, per-channel system whose composite FIR makes every upsampled
sample a K-tap combination of neighbouring mel FRAMES,

    mels_up[s, c] = sum_j phi[j, s % hop] * mel_padded[s // hop + d_lo + j, c]

with ``phi`` a (K, hop) table shared by all channels (K = 5 at the default
scales (5, 5, 11)). The aux stream is a pure frame repeat. The fused
sample-loop kernel consumes conditioning at frame rate through this table.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from .fold import num_folds_for


class PolyGeometry(NamedTuple):
    """Static geometry of the composite upsampling filter."""
    hop: int       # total upsample factor (= product of scales)
    lead: int      # samples the response extends LEFT of its frame's start
    h_len: int     # composite FIR length in samples
    d_lo: int      # lowest frame-tap offset relative to s // hop
    K: int         # number of frame taps
    indent: int    # pad * hop samples trimmed from each side (fatchord:88)


def geometry(upsample_factors: Sequence[int], pad: int) -> PolyGeometry:
    """Support of the composite filter: per stage (stretch x s, then conv
    k=2s+1 with zero-pad s) an impulse's start scales by s and shifts left
    by s, and its length scales by s and widens by 2s."""
    start, length, hop = 0, 1, 1
    for s in upsample_factors:
        start = start * s - s
        length = length * s + 2 * s
        hop *= s
    lead, h_len = -start, length
    indent = pad * hop
    d_lo = math.ceil((indent + lead - (h_len - 1)) / hop)
    d_hi = (hop - 1 + indent + lead) // hop
    return PolyGeometry(hop, lead, h_len, d_lo, d_hi - d_lo + 1, indent)


def composite_response(up_weights, upsample_factors: Sequence[int],
                       geo: PolyGeometry):
    """Impulse response of the stretch+conv stack, (h_len,) float32.

    ``up_weights`` are the averaging convs' weights (any shape holding k
    taps, e.g. the reference Conv2d's (1, 1, 1, k)); they are trainable,
    so the table is rebuilt from the current values."""
    F0 = -(-geo.lead // geo.hop) + 1
    n = F0 + -(-(geo.h_len - geo.lead) // geo.hop) + 2
    dev = up_weights[0].device
    m = torch.zeros(1, 1, n, dtype=torch.float32, device=dev)
    m[0, 0, F0] = 1.0
    for scale, w in zip(upsample_factors, up_weights):
        m = torch.repeat_interleave(m, scale, dim=-1)
        m = F.conv1d(m, w.reshape(1, 1, -1).float(), padding=scale)
    start = geo.hop * F0 - geo.lead
    return m[0, 0, start:start + geo.h_len]


def phi_table(up_weights, upsample_factors: Sequence[int],
              geo: PolyGeometry):
    """(K, hop) per-phase tap weights: phi[j, p] multiplies
    mel_padded[s // hop + d_lo + j] for phase p."""
    h = composite_response(up_weights, upsample_factors, geo)
    dev = h.device
    p = torch.arange(geo.hop, device=dev)[None, :]
    d = (geo.d_lo + torch.arange(geo.K, device=dev))[:, None]
    k_idx = p + geo.indent + geo.lead - geo.hop * d
    valid = (k_idx >= 0) & (k_idx < geo.h_len)
    return torch.where(valid, h[k_idx.clamp(0, geo.h_len - 1)],
                       torch.zeros((), dtype=h.dtype, device=dev))


def reconstruct_from_folded(frames_folded, phi, hop: int, aux_tap: int,
                            fold_chunks: int, n_mels: int):
    """Sample-rate (mels_up, aux_up) from folded frame rows in the
    build_folded_frames layout: chunk c's tap j reads row c + j, the aux
    repeat reads row c + aux_tap.

    frames_folded (nf_loc, B, n_mels + 4*aux) ->
    (mels_up (B, L, n_mels), aux_up (B, L, 4*aux)), L = fold_chunks*hop."""
    mel_fr = frames_folded[..., :n_mels].transpose(0, 1)
    aux_fr = frames_folded[..., n_mels:].transpose(0, 1)
    L = fold_chunks * hop
    s = torch.arange(L, device=frames_folded.device)
    mels_up = torch.zeros(mel_fr.shape[0], L, n_mels,
                          dtype=torch.float32, device=frames_folded.device)
    for j in range(phi.shape[0]):
        w = phi[j][s % hop]
        mels_up = mels_up + w[None, :, None] * mel_fr[:, s // hop + j]
    aux_up = aux_fr[:, s // hop + aux_tap]
    return mels_up, aux_up


def fold_geometry(total_len: int, target: int, overlap: int,
                  hop: int) -> Tuple[int, int, int, int]:
    """Frame-rate fold layout, valid when target and overlap are multiples
    of hop. Returns (num_folds, stride_frames, fold_chunks, fold_len)."""
    if target % hop or overlap % hop:
        raise ValueError("target and overlap must be multiples of hop")
    num_folds = num_folds_for(total_len, target, overlap)
    fold_len = target + 2 * overlap
    return num_folds, (target + overlap) // hop, fold_len // hop, fold_len


def build_folded_frames(mel_frames, aux_frames, num_folds: int,
                        stride_f: int, fold_chunks: int, K: int, d_lo: int):
    """Frame-rate conditioning for every fold.

    mel_frames (Tp, n_mels): PADDED mel frames; aux_frames (T, 4*aux):
    resnet output frames. Returns (nf_loc, num_folds, n_mels + 4*aux)
    time-major, where row f holds frame b*stride_f + f + d_lo of each
    stream (zeros out of range)."""
    nf_loc = fold_chunks + K - 1
    Tp, Ta = mel_frames.shape[0], aux_frames.shape[0]
    dev = mel_frames.device
    g = (torch.arange(num_folds, device=dev)[:, None] * stride_f
         + torch.arange(nf_loc, device=dev)[None, :] + d_lo)
    mel = torch.where(((g >= 0) & (g < Tp))[..., None],
                      mel_frames[g.clamp(0, Tp - 1)], 0.0)
    aux = torch.where(((g >= 0) & (g < Ta))[..., None],
                      aux_frames[g.clamp(0, Ta - 1)], 0.0)
    return torch.cat([mel, aux], dim=-1).transpose(0, 1).contiguous()
