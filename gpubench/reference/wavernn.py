"""Plain WaveRNN (fatchord/WaveRNN models/fatchord_version.py, MOL output):
the upsampler (MelResNet, stretch and averaging convs), folding, the
sample loop, and the judge of a served wave.

The sample loop runs at the configuration's stated precision: every
matrix rounded to bfloat16, the sample-input column of ``I``, the biases
and every sum in float32. Its sampling noise is the framework's counter
hash of (step, fold row, uniform), keyed by one 31-bit draw from the
caller's ``torch.Generator``; the hash is written out here as that rule
states it.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .tacotron import batchnorm

LOG_SCALE_MIN = math.log(1e-14)
_M32 = 0xFFFFFFFF


# ---- the counter-hash noise -----------------------------------------------

def program_seed(generator_seed: int) -> int:
    """The 31-bit key the serving path draws from a CPU torch.Generator
    seeded with ``generator_seed`` (one ``torch.randint`` draw)."""
    g = torch.Generator().manual_seed(generator_seed)
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=g).item())


def _mul32(x, c: int):
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _lowbias32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _lowbias32_int(x: int) -> int:
    x &= _M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def uniforms(keys, rows, B_global, t0: int, t1: int, nu: int, device):
    """(rows, t1 - t0, nu) MOL uniforms in [1e-5, 1 - 1e-5]: element
    (t, b, k) of a launch of ``B_global`` rows hashes the counter
    (t * B_global + b) * nu + k with the key of its seed and keeps 24 bits.
    ``keys``, ``rows`` and ``B_global`` are per-row int64 tensors."""
    t = torch.arange(t0, t1, dtype=torch.int64, device=device)
    k = torch.arange(nu, dtype=torch.int64, device=device)
    ctr = ((t[None, :, None] * B_global[:, None, None] + rows[:, None, None])
           * nu + k[None, None, :]) & _M32
    bits = _lowbias32(ctr ^ keys[:, None, None]) >> 8
    u = bits.to(torch.float32) * (2.0 ** -24)
    u = u * torch.tensor(1.0 - 2e-5, dtype=torch.float32, device=device)
    return u + torch.tensor(1e-5, dtype=torch.float32, device=device)


# ---- weights ---------------------------------------------------------------

def loop_weights(W, cast):
    """The sample loop's operands from the state dict: ``cast`` applied to
    every matrix (the stated precision: a round trip through bfloat16),
    the sample-input column of I and the biases kept float32."""
    R = W["rnn1.weight_hh_l0"].shape[1]
    FC = W["fc2.weight"].shape[0]
    n_mels = W["upsample.resnet.conv_in.weight"].shape[1]
    I_w, wi2 = W["I.weight"], W["rnn2.weight_ih_l0"]
    w1, w2 = W["fc1.weight"], W["fc2.weight"]
    m = {"w_imel": I_w[:, 1:1 + n_mels], "w_ia1": I_w[:, 1 + n_mels:],
         "wi1": W["rnn1.weight_ih_l0"], "wh1": W["rnn1.weight_hh_l0"],
         "wi2x": wi2[:, :R], "wi2a": wi2[:, R:], "wh2": W["rnn2.weight_hh_l0"],
         "w1x": w1[:, :R], "w1a": w1[:, R:], "w2x": w2[:, :FC],
         "w2a": w2[:, FC:], "w3": W["fc3.weight"]}
    out = {k: cast(v.float()) for k, v in m.items()}
    out.update({"w_x": I_w[:, 0].float(), "b_i": W["I.bias"].float(),
                "bi1": W["rnn1.bias_ih_l0"].float(),
                "bh1": W["rnn1.bias_hh_l0"].float(),
                "bi2": W["rnn2.bias_ih_l0"].float(),
                "bh2": W["rnn2.bias_hh_l0"].float(),
                "b1": W["fc1.bias"].float(), "b2": W["fc2.bias"].float(),
                "b3": W["fc3.bias"].float()})
    return out


def bf16_round(w):
    return w.to(torch.bfloat16).to(torch.float32)


def fp8_round(w):
    """The next precision below bfloat16: float8 e4m3 with one scale a
    tensor (its largest magnitude onto e4m3's 448)."""
    s = w.abs().max().clamp_min(1e-30) / 448.0
    return (w / s).to(torch.float8_e4m3fn).to(torch.float32) * s


# ---- conditioning ----------------------------------------------------------

def upsample(W, mel, cfg):
    """mel (1, n_mels, n) in [0, 1] -> (mels_up (n*hop, n_mels), aux
    (n*hop, res_out)), float32: the MelResNet at frame rate on the
    zero-padded mel, repeated ``hop`` times, and the stretch-and-average
    convs on the padded mel, trimmed by pad*hop at both ends."""
    pad = cfg["voc_pad"]
    x = F.pad(mel, (pad, pad))
    r = "upsample.resnet."
    h = F.conv1d(x, W[r + "conv_in.weight"])
    h = torch.relu(batchnorm(h, W, r + "batch_norm", False))
    for i in range(cfg["voc_res_blocks"]):
        b = f"{r}layers.{i}."
        y = torch.relu(batchnorm(F.conv1d(h, W[b + "conv1.weight"]), W,
                                 b + "batch_norm1", False))
        h = h + batchnorm(F.conv1d(y, W[b + "conv2.weight"]), W,
                          b + "batch_norm2", False)
    aux = F.conv1d(h, W[r + "conv_out.weight"], W[r + "conv_out.bias"])
    hop = math.prod(cfg["voc_upsample_factors"])
    aux = aux.repeat_interleave(hop, dim=-1)
    m = x[:, None]
    for i, s in enumerate(cfg["voc_upsample_factors"]):
        m = m.repeat_interleave(s, dim=-1)
        m = F.conv2d(m, W[f"upsample.up_layers.{2 * i + 1}.weight"],
                     padding=(0, s))
    indent = pad * hop
    m = m[:, 0, :, indent:-indent]
    return m[0].t(), aux[0].t()


def fold(x, target: int, overlap: int):
    """(L, C) -> (folds, target + 2*overlap, C), the last fold zero-padded
    (fatchord_version.py:293-340)."""
    L = x.shape[0]
    n = (L - overlap) // (target + overlap)
    if L - (n * (target + overlap) + overlap) != 0:
        n += 1
    pad = n * (target + overlap) + overlap - L
    x = F.pad(x, (0, 0, 0, pad))
    return torch.stack([x[i * (target + overlap):
                          i * (target + overlap) + target + 2 * overlap]
                        for i in range(n)])


# ---- the sample loop -------------------------------------------------------

def _cond(w, mu, au, A):
    """Conditioning products of a block of steps: mu (rows, t, n_mels),
    au (rows, t, 4A)."""
    a1, a2, a3, a4 = (au[..., i * A:(i + 1) * A] for i in range(4))
    return (mu @ w["w_imel"].t() + a1 @ w["w_ia1"].t() + w["b_i"],
            a2 @ w["wi2a"].t() + w["bi2"],
            a3 @ w["w1a"].t() + w["b1"],
            a4 @ w["w2a"].t() + w["b2"])


def _gates(gi, gh, h):
    H = h.shape[-1]
    r = torch.sigmoid(gi[..., :H] + gh[..., :H])
    z = torch.sigmoid(gi[..., H:2 * H] + gh[..., H:2 * H])
    n = torch.tanh(gi[..., 2 * H:] + r * gh[..., 2 * H:])
    return (1.0 - z) * n + z * h


def _mol_candidates(logits, u):
    """Each mixture component's sample and its Gumbel score, under the
    uniforms u (..., nr_mix + 1): (values (..., nr_mix), scores)."""
    nr = logits.shape[-1] // 3
    us = u[..., nr]
    ls = torch.clamp(logits[..., 2 * nr:], min=LOG_SCALE_MIN)
    vals = torch.clamp(logits[..., nr:2 * nr] + torch.exp(ls)
                       * (torch.log(us) - torch.log(1.0 - us))[..., None],
                       -1.0, 1.0)
    return vals, logits[..., :nr] - torch.log(-torch.log(u[..., :nr]))


def _free_steps(w, cond, u, state, t0, t1):
    """Free-running steps [t0, t1): the loop samples its own inputs.
    Returns (samples (rows, t1 - t0), state)."""
    ic, g2c, f1c, f2c = cond
    h1, h2, x = state
    out = []
    for t in range(t0, t1):
        inp = ic[:, t] + x[:, None] * w["w_x"]
        h1 = _gates(inp @ w["wi1"].t() + w["bi1"], h1 @ w["wh1"].t()
                    + w["bh1"], h1)
        xr = inp + h1
        h2 = _gates(xr @ w["wi2x"].t() + g2c[:, t], h2 @ w["wh2"].t()
                    + w["bh2"], h2)
        hf = torch.relu((xr + h2) @ w["w1x"].t() + f1c[:, t])
        hf = torch.relu(hf @ w["w2x"].t() + f2c[:, t])
        vals, scores = _mol_candidates(hf @ w["w3"].t() + w["b3"], u[:, t])
        x = torch.gather(vals, 1, scores.argmax(dim=1, keepdim=True))[:, 0]
        out.append(x)
    return torch.stack(out, dim=1), (h1, h2, x)


def _rows(utts, cfg, device):
    """Every fold of every utterance as a row: conditioning, noise keys,
    the launch row and row count of its fold, and its place in the wave."""
    target, overlap = cfg["voc_target"], cfg["voc_overlap"]
    mus, aus, keys, rows, B_g, owner = [], [], [], [], [], []
    for j, u in enumerate(utts):
        mu, au = upsample(u["W"], u["mel"][None], cfg)
        mu, au = fold(mu, target, overlap), fold(au, target, overlap)
        key = _lowbias32_int(u["seed"])
        for f in range(mu.shape[0]):
            mus.append(mu[f])
            aus.append(au[f])
            keys.append(key)
            rows.append(u["row0"] + f)
            B_g.append(u["rows"])
            owner.append((j, f))
    t = lambda v: torch.tensor(v, dtype=torch.int64, device=device)
    return (torch.stack(mus), torch.stack(aus), t(keys), t(rows), t(B_g),
            owner)


@torch.no_grad()
def generate(utts, cfg, cast, device, chunk: int = 2048):
    """The fold-batched sample loop, free-running, over each utterance's
    mel with weights rounded by ``cast``: each utterance's samples
    (folds, target + 2*overlap). ``utts``: dicts of W (the state dict),
    mel (n_mels, n), seed, row0, rows."""
    mu, au, keys, rows, B_g, owner = _rows(utts, cfg, device)
    w = loop_weights(utts[0]["W"], cast)
    A = cfg["voc_res_out_dims"] // 4
    R = w["wh1"].shape[1]
    n = mu.shape[0]
    state = (mu.new_zeros(n, R), mu.new_zeros(n, R), mu.new_zeros(n))
    T = mu.shape[1]
    out = []
    for t0 in range(0, T, chunk):
        t1 = min(T, t0 + chunk)
        cond = _cond(w, mu[:, t0:t1], au[:, t0:t1], A)
        u = uniforms(keys, rows, B_g, t0, t1, 11, device)
        ys, state = _free_steps(w, cond, u, state, 0, t1 - t0)
        out.append(ys)
    ys = torch.cat(out, dim=1)
    res = [[] for _ in utts]
    for i, (j, _) in enumerate(owner):
        res[j].append(ys[i])
    return [torch.stack(r) for r in res]


def crossfade(y, overlap: int):
    """(folds, target + 2*overlap) -> the overlap-added wave with the
    equal-power crossfade and the silenced warm-up of each fold
    (fatchord_version.py:342-405)."""
    n, length = y.shape
    target = length - 2 * overlap
    silence = overlap // 2
    t = torch.linspace(-1, 1, overlap - silence, dtype=y.dtype,
                       device=y.device)
    flat = torch.ones(silence, dtype=y.dtype, device=y.device)
    fade_in = torch.cat([0.0 * flat, torch.sqrt(0.5 * (1 + t))])
    fade_out = torch.cat([flat, torch.sqrt(0.5 * (1 - t))])
    y = y.clone()
    y[:, :overlap] *= fade_in
    y[:, -overlap:] *= fade_out
    out = y.new_zeros(n * (target + overlap) + overlap)
    for i in range(n):
        s = i * (target + overlap)
        out[s:s + length] += y[i]
    return out


def host_wave(y, T_valid: int, hop: int, overlap: int):
    """A served utterance's wave from its folds: crossfaded, cut to
    (T_valid - 1)*hop samples and faded linearly to 0 over the last 20
    frames, float32 on the host."""
    wav = crossfade(y, overlap)
    n = max(T_valid - 1, 1) * hop
    wav = np.array(wav[:n].cpu().numpy(), dtype=np.float32)
    k = min(20 * hop, n)
    wav[-k:] *= np.linspace(1.0, 0.0, k, dtype=np.float32)
    return wav


@torch.no_grad()
def judge(utts, cfg, margin: int, device, chunk: int = 512):
    """The widest gap of a served sample from the reference, and how many
    samples were compared.

    Each fold is followed step by step from the served samples (teacher
    forcing): its first ``overlap`` steps, which the crossfade silences or
    mixes with the fold before, run free under the same noise, and from
    there every step takes the served sample before it as input. At each
    compared step (past ``overlap + margin``, while the wave holds the
    fold's own sample), the reference's mixture components under the
    step's uniforms give each a sample value and a Gumbel score; the gap
    is the least, over the components, of the score's shortfall from the
    best plus the distance of its value from the served sample. A correct
    program picks the best component (or one within rounding of it) and
    its value. ``utts``: dicts of W, mel (n_mels, n), wave (float32 numpy,
    as served), T_valid, seed, row0, rows."""
    target, overlap = cfg["voc_target"], cfg["voc_overlap"]
    hop = math.prod(cfg["voc_upsample_factors"])
    mu, au, keys, rows, B_g, owner = _rows(utts, cfg, device)
    w = loop_weights(utts[0]["W"], bf16_round)
    A = cfg["voc_res_out_dims"] // 4
    R = w["wh1"].shape[1]
    n, T = mu.shape[0], mu.shape[1]
    # the served samples of each fold, and where they are its own
    served = torch.zeros(n, T, device=device)
    known = torch.zeros(n, T, dtype=torch.bool, device=device)
    for i, (j, f) in enumerate(owner):
        wav = torch.as_tensor(utts[j]["wave"], device=device)
        L = wav.shape[0]
        k = min(20 * hop, L)
        fade = torch.ones(L, device=device)
        fade[L - k:] = torch.linspace(1.0, 0.0, k, device=device)
        lo = f * (target + overlap)
        hi = min(lo + target + overlap + overlap // 2, L)
        if hi <= lo + overlap:
            continue
        seg = slice(lo + overlap, hi)
        ok = fade[seg] >= 1e-3
        served[i, overlap:hi - lo] = torch.where(ok, wav[seg] / fade[seg], 0.0)
        known[i, overlap:hi - lo] = ok
    cond = _cond(w, mu[:, :overlap], au[:, :overlap], A)
    u = uniforms(keys, rows, B_g, 0, overlap, 11, device)
    warm, (h1, h2, _) = _free_steps(
        w, cond, u, (mu.new_zeros(n, R), mu.new_zeros(n, R),
                     mu.new_zeros(n)), 0, overlap)
    x_in = torch.cat([warm[:, -1:], served[:, overlap:-1]], dim=1)
    gap = torch.zeros((), device=device)
    count = torch.zeros((), dtype=torch.int64, device=device)
    t_end = int(known.any(dim=0).nonzero().max()) + 1 if known.any() else 0
    for t0 in range(overlap, t_end, chunk):
        t1 = min(t_end, t0 + chunk)
        ic, g2c, f1c, f2c = _cond(w, mu[:, t0:t1], au[:, t0:t1], A)
        inp = ic + x_in[:, t0 - overlap:t1 - overlap, None] * w["w_x"]
        gi1 = inp @ w["wi1"].t() + w["bi1"]
        hs = []
        for t in range(t1 - t0):
            h1 = _gates(gi1[:, t], h1 @ w["wh1"].t() + w["bh1"], h1)
            hs.append(h1)
        xr = inp + torch.stack(hs, dim=1)
        gi2 = xr @ w["wi2x"].t() + g2c
        hs = []
        for t in range(t1 - t0):
            h2 = _gates(gi2[:, t], h2 @ w["wh2"].t() + w["bh2"], h2)
            hs.append(h2)
        hf = torch.relu((xr + torch.stack(hs, dim=1)) @ w["w1x"].t() + f1c)
        hf = torch.relu(hf @ w["w2x"].t() + f2c)
        vals, scores = _mol_candidates(
            hf @ w["w3"].t() + w["b3"],
            uniforms(keys, rows, B_g, t0, t1, 11, device))
        short = scores.max(dim=-1, keepdim=True).values - scores
        d = (short + (served[:, t0:t1, None] - vals).abs()).min(dim=-1).values
        cmp = known[:, t0:t1].clone()
        cmp[:, :max(0, overlap + margin - t0)] = False
        gap = torch.maximum(gap, torch.where(cmp, d, 0.0).max())
        count += cmp.sum()
    return float(gap), int(count)
