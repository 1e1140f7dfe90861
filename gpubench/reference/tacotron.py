"""Plain Tacotron (fatchord/WaveRNN models/tacotron.py, as the repository's
framework states it): the encoder CBHG, the location-sensitive smooth
attention decoder with its two residual LSTMs, the postnet CBHG, in float32
PyTorch with no kernel, cache or fused operator of the program.

Two uses: free-running inference with the stop rule of the serving path
(``decode``), and the attention-forcing training forward (``af_forward``).
Weights are a dict by the reference state dict's names.

Departures from fatchord's code, which are the framework's own and the
program's: the smooth attention's normaliser skips a row's padded text (a
mask) at inference and has no mask in training; a row that stops keeps
its state frozen and repeats its first frozen-state output (batched
serving); the prenet has no dropout at inference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
# fatchord utils/text/symbols.py: pad, special, punctuation, letters
SYMBOLS = (["_", "-"] + list("!'(),.:;? ")
           + list("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"))
SYMBOL_ID = {s: i for i, s in enumerate(SYMBOLS)}


def text_ids(text: str):
    """Symbol ids of a lower-case text of the benchmark's corpus (letters,
    space and ``.,'-``: english_cleaners leaves such text as it is)."""
    return [SYMBOL_ID[c] for c in text.strip()]


def linear(x, w, b=None):
    y = x @ w.t()
    return y if b is None else y + b


def batchnorm(x, P, pre, train):
    """BatchNorm1d over (B, C, T): batch statistics when ``train`` (biased
    variance), else the running ones."""
    if train:
        mean = x.mean(dim=(0, 2))
        var = x.var(dim=(0, 2), unbiased=False)
    else:
        mean, var = P[pre + ".running_mean"], P[pre + ".running_var"]
    y = (x - mean[None, :, None]) / torch.sqrt(var[None, :, None] + BN_EPS)
    return y * P[pre + ".weight"][None, :, None] + P[pre + ".bias"][None, :,
                                                                      None]


def bn_conv(x, P, pre, relu, train):
    """Conv (no bias, 'same' padding of k // 2), ReLU, BatchNorm."""
    w = P[pre + ".conv.weight"]
    y = F.conv1d(x, w, padding=w.shape[-1] // 2)
    if relu:
        y = torch.relu(y)
    return batchnorm(y, P, pre + ".bnorm", train)


def gru_cell(x, h, w_ih, w_hh, b_ih, b_hh):
    H = h.shape[-1]
    gi, gh = linear(x, w_ih, b_ih), linear(h, w_hh, b_hh)
    r = torch.sigmoid(gi[:, :H] + gh[:, :H])
    z = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
    n = torch.tanh(gi[:, 2 * H:] + r * gh[:, 2 * H:])
    return (1.0 - z) * n + z * h


def gru_seq(x, w_ih, w_hh, b_ih, b_hh, reverse=False):
    """(B, T, I) -> (B, T, H), one torch.nn.GRU direction."""
    H = w_hh.shape[1]
    gi = linear(x, w_ih, b_ih)
    h = x.new_zeros(x.shape[0], H)
    out = [None] * x.shape[1]
    for t in (range(x.shape[1] - 1, -1, -1) if reverse
              else range(x.shape[1])):
        gh = linear(h, w_hh, b_hh)
        g = gi[:, t]
        r = torch.sigmoid(g[:, :H] + gh[:, :H])
        z = torch.sigmoid(g[:, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(g[:, 2 * H:] + r * gh[:, 2 * H:])
        h = (1.0 - z) * n + z * h
        out[t] = h
    return torch.stack(out, dim=1)


def lstm_cell(x, h, c, w_ih, w_hh, b_ih, b_hh):
    L = h.shape[-1]
    g = linear(x, w_ih, b_ih) + linear(h, w_hh, b_hh)
    i, f = torch.sigmoid(g[:, :L]), torch.sigmoid(g[:, L:2 * L])
    gg, o = torch.tanh(g[:, 2 * L:3 * L]), torch.sigmoid(g[:, 3 * L:])
    c = f * c + i * gg
    return o * torch.tanh(c), c


def cbhg(x, P, pre, K, train):
    """(B, C_in, T) -> (B, T, 2C): the conv bank (BatchNorm over every
    output position, the extra one of an even width included, before the
    cut to T), max-pool, two projections, residual, highways, BiGRU."""
    T = x.shape[-1]
    bank = torch.cat([bn_conv(x, P, f"{pre}.conv1d_bank.{k}", True,
                              train)[:, :, :T] for k in range(K)], dim=1)
    h = F.max_pool1d(bank, 2, 1, padding=1)[:, :, :T]
    h = bn_conv(h, P, pre + ".conv_project1", True, train)
    h = bn_conv(h, P, pre + ".conv_project2", False, train)
    h = (h + x).transpose(1, 2)
    if pre + ".pre_highway.weight" in P:
        h = linear(h, P[pre + ".pre_highway.weight"])
    i = 0
    while f"{pre}.highways.{i}.W1.weight" in P:
        hw = f"{pre}.highways.{i}"
        x1 = linear(h, P[hw + ".W1.weight"], P[hw + ".W1.bias"])
        g = torch.sigmoid(linear(h, P[hw + ".W2.weight"], P[hw + ".W2.bias"]))
        h = g * torch.relu(x1) + (1.0 - g) * h
        i += 1
    rnn = [P[f"{pre}.rnn.{k}_l0"] for k in ("weight_ih", "weight_hh",
                                             "bias_ih", "bias_hh")]
    rev = [P[f"{pre}.rnn.{k}_l0_reverse"] for k in ("weight_ih", "weight_hh",
                                                     "bias_ih", "bias_hh")]
    return torch.cat([gru_seq(h, *rnn), gru_seq(h, *rev, reverse=True)],
                     dim=-1)


def encoder(P, ids, K, train=False, masks=(None, None)):
    """(B, T_text) ids -> (encoder outputs (B, T, E), their projection)."""
    x = P["encoder.embedding.weight"][ids]
    x = torch.relu(linear(x, P["encoder.pre_net.fc1.weight"],
                          P["encoder.pre_net.fc1.bias"]))
    if masks[0] is not None:
        x = x * masks[0]
    x = torch.relu(linear(x, P["encoder.pre_net.fc2.weight"],
                          P["encoder.pre_net.fc2.bias"]))
    if masks[1] is not None:
        x = x * masks[1]
    enc = cbhg(x.transpose(1, 2), P, "encoder.cbhg", K, train)
    return enc, linear(enc, P["encoder_proj.weight"])


def zero_state(P, B, T, E, device):
    D = P["decoder.attn_rnn.weight_hh"].shape[1]
    L = P["decoder.res_rnn1.weight_hh"].shape[1]
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return (z(B, D), z(B, L), z(B, L), z(B, L), z(B, L), z(B, E), z(B, T),
            z(B, T))


def decoder_group(P, enc, encp, prev, st, r, n_mels, max_r, aref_g=None,
                  drop=None, zone=None, text_mask=None):
    """One decoder group: (mels (B, n_mels, r), scores (B, T), state).
    ``aref_g`` weights the context in attention forcing (the location
    features still follow the decoder's own scores); ``drop`` the prenet's
    scaled keep-masks, ``zone`` the LSTMs' keep-previous masks."""
    ah, h1, c1, h2, c2, ctx, cum, att = st
    d = "decoder."
    p = torch.relu(linear(prev, P[d + "prenet.fc1.weight"],
                          P[d + "prenet.fc1.bias"]))
    if drop is not None:
        p = p * drop[0]
    p = torch.relu(linear(p, P[d + "prenet.fc2.weight"],
                          P[d + "prenet.fc2.bias"]))
    if drop is not None:
        p = p * drop[1]
    ah = gru_cell(torch.cat([ctx, p], dim=-1), ah,
                  P[d + "attn_rnn.weight_ih"], P[d + "attn_rnn.weight_hh"],
                  P[d + "attn_rnn.bias_ih"], P[d + "attn_rnn.bias_hh"])
    q = linear(ah, P[d + "attn_net.W.weight"], P[d + "attn_net.W.bias"])
    loc = F.conv1d(torch.stack([cum, att], dim=1),
                   P[d + "attn_net.conv.weight"], padding=15)
    loc = linear(loc.transpose(1, 2), P[d + "attn_net.L.weight"],
                 P[d + "attn_net.L.bias"])
    u = linear(torch.tanh(q[:, None, :] + encp + loc),
               P[d + "attn_net.v.weight"])[..., 0]
    sig = torch.sigmoid(u)
    if text_mask is not None:
        sig = sig * text_mask
    s = sig / sig.sum(dim=1, keepdim=True)
    w = s if aref_g is None else aref_g
    ctx = torch.einsum("bt,bte->be", w, enc)
    cum, att = cum + s, s
    x = linear(torch.cat([ctx, ah], dim=1), P[d + "rnn_input.weight"],
               P[d + "rnn_input.bias"])
    h1n, c1 = lstm_cell(x, h1, c1, P[d + "res_rnn1.weight_ih"],
                        P[d + "res_rnn1.weight_hh"], P[d + "res_rnn1.bias_ih"],
                        P[d + "res_rnn1.bias_hh"])
    h1 = h1n if zone is None else zone[0] * h1 + (1.0 - zone[0]) * h1n
    x = x + h1
    h2n, c2 = lstm_cell(x, h2, c2, P[d + "res_rnn2.weight_ih"],
                        P[d + "res_rnn2.weight_hh"], P[d + "res_rnn2.bias_ih"],
                        P[d + "res_rnn2.bias_hh"])
    h2 = h2n if zone is None else zone[1] * h2 + (1.0 - zone[1]) * h2n
    x = x + h2
    mels = linear(x, P[d + "mel_proj.weight"]).reshape(
        x.shape[0], n_mels, max_r)[:, :, :r]
    return mels, s, (ah, h1, c1, h2, c2, ctx, cum, att)


def postnet(P, mel, K, train=False):
    """(B, n_mels, T) decoder mel -> the postnet's (B, n_mels, T)."""
    y = cbhg(mel, P, "postnet", K, train)
    return linear(y, P["post_proj.weight"]).transpose(1, 2)


@torch.no_grad()
def synthesize(P, texts, steps, cfg, device):
    """Free-running inference of a batch of texts, each decoded as alone
    (its own encoder pass; the attention masked to its own text): returns
    (postnet output (B, n_mels, steps), n_valid (B,)) with the stop rule:
    a row stops after the first group past frame 10 whose values all lie
    below the threshold, keeps its state frozen, and its later groups
    repeat the output of that frozen state."""
    r, n_mels, max_r = cfg["tts_r"], cfg["num_mels"], cfg["tts_max_r"]
    K_enc, K_post = cfg["tts_encoder_K"], cfg["tts_postnet_K"]
    encs = [encoder(P, torch.tensor([text_ids(t)], device=device), K_enc)
            for t in texts]
    B, T = len(texts), max(e[0].shape[1] for e in encs)
    E = encs[0][0].shape[-1]
    enc = torch.zeros(B, T, E, device=device)
    encp = torch.zeros(B, T, encs[0][1].shape[-1], device=device)
    mask = torch.zeros(B, T, device=device)
    for b, (e, ep) in enumerate(encs):
        n = e.shape[1]
        enc[b, :n], encp[b, :n], mask[b, :n] = e[0], ep[0], 1.0
    st = zero_state(P, B, T, E, device)
    prev = torch.zeros(B, n_mels, device=device)
    stopped = torch.zeros(B, dtype=torch.bool, device=device)
    n_valid = torch.zeros(B, dtype=torch.long, device=device)
    outs, held = [], None
    thr = cfg["tts_stop_threshold"]
    for g in range(steps // r):
        if held is None:
            mels, _, new = decoder_group(P, enc, encp, prev, st, r, n_mels,
                                         max_r, text_mask=mask)
            if bool(stopped.all()):
                held = mels
            n_valid += (~stopped).long()
            keep = lambda o, n: torch.where(
                stopped.reshape((-1,) + (1,) * (n.dim() - 1)), o, n)
            st = tuple(keep(o, n) for o, n in zip(st, new))
            prev = keep(prev, mels[:, :, -1])
            stopped = stopped | ((mels < thr).flatten(1).all(1)
                                 & (g * r > 10))
        else:
            mels = held
        outs.append(mels)
    mel = torch.cat(outs, dim=2)
    return postnet(P, mel, K_post), n_valid * r


def af_forward(P, ids, m, aref, masks, cfg):
    """The attention-forcing training forward: (decoder mel, postnet
    output, scores (B, G, T)), every dropout and zoneout mask injected."""
    r, n_mels, max_r = cfg["tts_r"], cfg["num_mels"], cfg["tts_max_r"]
    B, _, steps = m.shape
    enc, encp = encoder(P, ids, cfg["tts_encoder_K"], True,
                        (masks["enc_drop1"], masks["enc_drop2"]))
    st = zero_state(P, B, ids.shape[1], enc.shape[-1], m.device)
    prev = m.new_zeros(B, n_mels)
    mels, scores = [], []
    for g in range(steps // r):
        mel_g, s, st = decoder_group(
            P, enc, encp, prev, st, r, n_mels, max_r, aref_g=aref[:, g],
            drop=(masks["dec_drop1"][g], masks["dec_drop2"][g]),
            zone=(masks["zm1"][g], masks["zm2"][g]))
        prev = mel_g[:, :, -1]
        mels.append(mel_g)
        scores.append(s)
    mel = torch.cat(mels, dim=2)
    return mel, postnet(P, mel, cfg["tts_postnet_K"], True), \
        torch.stack(scores, dim=1)
