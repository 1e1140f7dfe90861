"""The benchmark's frozen yardstick: the card's peaks, the least time of a
piece of work, the operations and bytes each kernel's work needs, and the
model FLOPs of a served request or a training step, all computed from
shapes.

The kernel work functions are frozen copies of ``chip_smoke.py``'s
(``b1_work``, ``b2_work``, ``gru_work``, ``b7_work``): each
input read once and each output written once, the operations of the
algorithm at these shapes. Later changes to the program do not move them.
"""
from __future__ import annotations

import math

# H100 SXM published peaks (NVIDIA data sheet): dense bf16 tensor, float32
# outside the tensor cores, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def least_s(flops: float, nbytes: float, peak: float) -> float:
    """The least seconds the card could take: the larger of operations over
    ``peak`` and bytes over the memory bandwidth."""
    return max(flops / peak, nbytes / PEAK_BYTES)


def b1_work(B, T, fold_chunks, R, FC, A, n_mels, NC, K, wbytes):
    """(FLOPs, bytes) the fused sample loop needs for these shapes."""
    per_sample = 2 * (2 * 3 * R * R + 2 * 3 * R * R + FC * R + FC * FC
                      + NC * FC)
    per_chunk = 2 * (K * R * n_mels + R * A + 3 * R * A + 2 * FC * A)
    flops = B * T * per_sample + B * fold_chunks * per_chunk
    n_w = (R * (n_mels + A) + 2 * 3 * R * R + 3 * R * (R + A)
           + FC * (R + A) + FC * (FC + A) + NC * FC)
    n_f32 = R + R + 4 * 3 * R + 2 * FC + NC
    frames = (fold_chunks + K - 1) * B * (n_mels + 4 * A)
    nbytes = n_w * wbytes + 4 * (n_f32 + frames + K * (T // fold_chunks)
                                 + B * T)
    return flops, nbytes


def b2_work(groups, T, E, D, P1, P2, L, F, n_mels, n_out_groups):
    """(FLOPs, bytes) the decode needs for ``groups`` computed groups."""
    per_group = 2 * (P1 * n_mels + P2 * P1 + 3 * D * (E + P2) + 3 * D * D
                     + D * D + T * (32 * 62 + D * 32 + D) + E * T
                     + L * (E + D) + 2 * 2 * 4 * L * L + F * L)
    n_w = (P1 * n_mels + P1 + P2 * P1 + P2 + 3 * D * (E + P2) + 3 * D * D
           + 6 * D + D * D + D + 32 * 62 + D * 32 + D + L * (E + D) + L
           + 2 * (8 * L * L + 4 * L) + F * L)
    nbytes = 4 * (n_w + T * (E + D + 1) + n_out_groups * (F + T) + 1)
    return groups * per_group, nbytes


def gru_work(T, B, H, nbytes, backward):
    """(FLOPs, bytes) of one B5 launch: each input read once and each
    output written once; stream elements of ``nbytes`` bytes."""
    flops = 2 * T * B * H * 3 * H
    if backward:   # sv, ys, dys, wh, h0 in; dgi, dgh, dh0 (f32) out
        streams = T * B * (4 * H + H + H + 3 * H + 3 * H)
        return flops, nbytes * (streams + 3 * H * H + B * H) + 4 * B * H
    # gi, wh, h0 in (bh f32); ys, sv out
    return flops, (nbytes * (T * B * (3 * H + H + 4 * H) + 3 * H * H + B * H)
                   + 4 * 3 * H)


def b7_work(G, B, T, E, D, P1, P2, L, F, NM, backward):
    """(FLOPs, bytes) of one B7 launch: each input read once and each
    output written once (float32). The recurrence is B6's with the prenet
    inside (its two layers a group, and their backward) and the context
    contraction's cotangent going to d(aref)."""
    nt = 62
    w_pre = P1 * NM + P1 + P2 * P1 + P2
    n_w = (3 * D * (E + P2) + 3 * D * D + 6 * D + D * D + D + nt * D + D
           + L * (E + D) + L + 2 * (8 * L * L + 4 * L) + F * L) + w_pre
    streams = G * B * (T + 6 * D + 1 + E + 15 * L + NM + P1 + P2)
    rec = (3 * D * (E + P2) + 3 * D * D + D * D + L * (E + D) + 16 * L * L
           + F * L + P1 * NM + P2 * P1)
    # aref, dm1, dm2, zm1, zm2, enc, encp, weights
    inputs = G * B * (T + P1 + P2 + 2 * L) + B * T * (E + D) + n_w
    if not backward:
        flops = 2 * G * B * (rec + T * (nt * D + D) + T * E)
        return flops, 4 * (inputs + G * B * (F + T) + streams)
    flops = 2 * G * B * (2 * rec + 2 * T * E + T * (3 * nt * D + D))
    # + streams, dmel, dsc, scores in; daref, denc, dencp, gradients out
    return flops, 4 * (inputs + streams + G * B * (F + 3 * T)
                       + B * T * (E + D) + n_w)


# ---- shapes of the configuration -----------------------------------------

def poly_taps(upsample_factors, pad: int) -> int:
    """The mel frames K each upsampled sample combines (the composite
    stretch-and-average filter's support over frames)."""
    start, length, hop = 0, 1, 1
    for s in upsample_factors:
        start = start * s - s
        length = length * s + 2 * s
        hop *= s
    lead, indent = -start, pad * hop
    d_lo = math.ceil((indent + lead - (length - 1)) / hop)
    d_hi = (hop - 1 + indent + lead) // hop
    return d_hi - d_lo + 1


def num_folds(total_len: int, target: int, overlap: int) -> int:
    """Folds of ``target + 2*overlap`` samples that cover ``total_len``
    (fatchord_version.py:293-340)."""
    n = (total_len - overlap) // (target + overlap)
    if total_len - (n * (overlap + target) + overlap) != 0:
        n += 1
    return n


def dims(cfg: dict) -> dict:
    """The widths the work functions read, from a configuration file."""
    e = 2 * cfg["tts_encoder_dims"]
    return dict(R=cfg["voc_rnn_dims"], FC=cfg["voc_fc_dims"],
                A=cfg["voc_res_out_dims"] // 4, n_mels=cfg["num_mels"],
                NC=30 if cfg["voc_mode"] == "MOL" else 2 ** cfg["bits"],
                hop=cfg["hop_length"],
                K=poly_taps(cfg["voc_upsample_factors"], cfg["voc_pad"]),
                E=e, D=cfg["tts_decoder_dims"], P1=256, P2=128,
                L=cfg["tts_lstm_dims"], emb=cfg["tts_embed_dims"],
                C_enc=cfg["tts_encoder_dims"], C_post=cfg["tts_postnet_dims"],
                K_enc=cfg["tts_encoder_K"], K_post=cfg["tts_postnet_K"],
                hw=cfg["tts_num_highways"],
                compute=cfg["voc_compute_dims"],
                res_out=cfg["voc_res_out_dims"],
                res_blocks=cfg["voc_res_blocks"], pad=cfg["voc_pad"])


def b1_call(d: dict, folds: int, target: int, overlap: int, wbytes: int = 2):
    """(FLOPs, bytes) of B1 over ``folds`` folds of ``target + 2*overlap``
    steps."""
    T = target + 2 * overlap
    return b1_work(folds, T, T // d["hop"], d["R"], d["FC"], d["A"],
                   d["n_mels"], d["NC"], d["K"], wbytes)


def b7_step(d: dict, B: int, T_text: int, frames: int, r: int):
    """(forward, backward) (FLOPs, bytes) of B7 at one AF step's shape."""
    args = (frames // r, B, T_text, d["E"], d["D"], d["P1"], d["P2"], d["L"],
            r * d["n_mels"], d["n_mels"])
    return b7_work(*args, backward=False), b7_work(*args, backward=True)


def b5_cbhg_step(d: dict, B: int, T_text: int, frames: int):
    """[(FLOPs, bytes)] of the B5 launches of one training step: each
    CBHG BiGRU direction forward and backward (the encoder's over the text,
    the postnet's over the frames)."""
    out = []
    for T, H in ((T_text, d["C_enc"]), (frames, d["C_post"])):
        for _ in range(2):
            out.append(gru_work(T, B, H, 4, False))
            out.append(gru_work(T, B, H, 4, True))
    return out


def _cbhg_flops(B, T, K, C_in, C, proj, n_hw):
    f = sum(2 * B * T * k * C_in * C for k in range(1, K + 1))
    f += 2 * B * T * 3 * (K * C) * proj[0] + 2 * B * T * 3 * proj[0] * proj[1]
    if proj[1] != C:
        f += 2 * B * T * proj[1] * C
    f += n_hw * 2 * 2 * B * T * C * C
    f += 2 * 2 * B * T * (3 * C * C + 3 * C * C)
    return f


def tacotron_flops(d: dict, B: int, T_text: int, frames: int, r: int):
    """Forward FLOPs of the Tacotron over B rows of ``T_text`` symbols and
    ``frames`` output frames: encoder, ``frames // r`` decoder groups,
    postnet."""
    f = 2 * B * T_text * (d["emb"] * d["P1"] + d["P1"] * d["P2"])
    f += _cbhg_flops(B, T_text, d["K_enc"], d["C_enc"], d["C_enc"],
                     (d["C_enc"], d["C_enc"]), d["hw"])
    f += 2 * B * T_text * d["E"] * d["D"]
    f += B * b2_work(frames // r, T_text, d["E"], d["D"], d["P1"], d["P2"],
                     d["L"], r * d["n_mels"], d["n_mels"], 0)[0]
    f += _cbhg_flops(B, frames, d["K_post"], d["n_mels"], d["C_post"],
                     (256, d["n_mels"]), d["hw"])
    f += 2 * B * frames * 2 * d["C_post"] * d["n_mels"]
    return f


def melresnet_flops(d: dict, frames: int):
    """Forward FLOPs of the vocoder's MelResNet over one utterance."""
    c = d["compute"]
    k = 2 * d["pad"] + 1
    return 2 * frames * (k * d["n_mels"] * c + d["res_blocks"] * 2 * c * c
                         + c * d["res_out"])
