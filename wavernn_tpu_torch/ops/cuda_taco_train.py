"""Tacotron decoder training recurrence, teacher forcing (kernel B6) and
attention forcing (kernel B7): the CUDA kernels' wrappers, the autograd
Functions and the plain PyTorch versions.

Port of ``wavernn_tpu/ops/pallas_taco_train.py``: ``decoder_tf_train``,
``decoder_af_train`` and their operand preparation, ``zoneout_masks``, and
the TPU kernels ``_make_fwd_kernel`` / ``_make_bwd_kernel`` behind the
custom VJPs ``_core`` (af=False) and ``_core_af`` (af=True). The kernels
(``csrc/taco_train.cu``) run all G groups of the batch in one cooperative
launch per direction; the backward launch also forms every weight gradient
of the recurrence with hand-written reduction kernels. ``core_ref`` /
``core_af_ref`` are the plain forwards (the JAX package's twins in the
natural batched layout) and ``core_bwd_ref`` / ``core_af_bwd_ref`` the
plain backwards, hand-written reverse sweeps with the kernels' arithmetic.
``core_free_ref`` is the free-running loop, which has no kernel.

Attention forcing: the context weights are a reference attention aref
(G, B, T) instead of the decoder's scores, and the prenet runs inside the
recurrence on the previous group's last mel frame, with the dropout
keep-masks dm1 (G, B, P1) / dm2 (G, B, P2) scaled by 1 / (1 - rate) (ones
in eval); its weights (``AF_PRENET``) come before ``WEIGHTS``.

The operands keep their natural batched form: pre (G, B, P2) hoisted
prenet outputs, zm1/zm2 (G, B, L) zoneout keep-previous masks (1 keeps the
previous h; zeros are eval mode), enc (B, T, E), encp (B, T, D), and the
weights of ``WEIGHTS`` in torch's (out, in) layouts: the location conv
composed with L as W01 (D, 62) (cumulative taps, then attention taps),
qb = W.b + L.b, the LSTM biases summed, and mel_proj's rows of the r frames
reordered frame-major (F = r * n_mels).

Precision: the weights, the streams and the saved states take the compute
dtype of the operands (float32 or bfloat16; enc's dtype), the biases stay
float32. In bfloat16 the forward rounds to it where the JAX kernel does
(``pallas_taco_train.py:129-236``, the flat twins ``core_ref`` /
``core_af_ref`` at ``:1008-1048`` / ``:1080-1129``): ah, the scores, ctx,
x0, c1, h1, x1, c2, h2, x2, the mel and the AF prenet's p1 and output;
every matrix product takes its operands as stored and accumulates in
float32, and the gate and elementwise math, the cumulative attention, the
normaliser, q and the scores' float32 copy stay float32. The backward reads
the bfloat16 streams and weights and keeps every cotangent in float32 (the
JAX kernel also rounds each cotangent to bfloat16 before its product;
B6's resident body forms d(ctx)'s contraction through a split whose parts
have no common rounding point, so both bodies and the plain versions keep
the cotangents float32). The weight gradients are summed in float32 and
returned in each weight's dtype.

B7 runs on the resident body ``csrc/taco_train_resident.cu``
(``taco_af_res_fwd`` / ``taco_af_res_bwd``; launch plan
``af_resident_plan``), B6 on ``csrc/taco_tf_resident.cu`` (``taco_tf_res_fwd``
/ ``taco_tf_res_bwd``; launch plan ``tf_resident_plan``); the two arms of
``csrc/taco_train.cu`` are their yardsticks, reached only through the
wrappers' private ``_legacy=True``.

On CPU tensors the wrappers run the plain versions; on CUDA tensors they
launch the kernels or raise. Neither falls back to the other.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import _build

CONV_K = 31
CONV_HALF = 15

WEIGHTS = ("awi", "abi", "awh", "abh", "wq", "qb", "W01", "v", "wr", "br",
           "l1wi", "l1wh", "l1b", "l2wi", "l2wh", "l2b", "wm")
# the forward's residual streams, each (G, B, ·): the cumulative before the
# group's update, q, the normaliser, ah, the GRU's [r|z|n|hn], ctx, x0, x1,
# x2, the LSTMs' gate activations [i|f|g|o], c1, h1, c2, h2
STREAMS = ("cum", "q", "div", "ah", "gru", "ctx", "x0", "x1", "x2", "g1",
           "g2", "c1", "h1", "c2", "h2")
# the AF arm's prenet weights (torch layouts: fc1 (P1, n_mels), fc2 (P2,
# P1)) before ``WEIGHTS``, and its extra streams: the previous frame the
# prenet read, its first layer after dropout, its output
AF_PRENET = ("w1", "b1", "w2", "b2")
AF_WEIGHTS = AF_PRENET + WEIGHTS
AF_STREAMS = STREAMS + ("prev", "p1", "pre")


def zoneout_masks(n_groups: int, B: int, L: int, generator: torch.Generator,
                  device, rate: float = 0.1):
    """(zm1, zm2) (G, B, L) float keep-previous masks, 1 with probability
    ``rate`` (``pallas_taco_train.py:1147-1160``: bernoulli(0.1) per
    group and LSTM)."""
    u = torch.rand(2, n_groups, B, L, generator=generator, device=device)
    zm = (u < rate).float()
    return zm[0], zm[1]


def decoder_operands(dec: Dict[str, torch.Tensor], max_r: int, r: int,
                     n_mels: int) -> Tuple[torch.Tensor, ...]:
    """The recurrence's weight operands (``WEIGHTS`` order) from the
    decoder's parameters by state-dict name below ``decoder.``, as
    differentiable functions of them (``pallas_taco_train.py:1230-1259``):
    autograd carries the operands' gradients back to the parameters. The
    matrices keep the parameters' dtype (W01 composed in float32, then
    rounded to it); the biases are summed in it and returned float32, as
    the JAX package's ``[None].astype(F32)``."""
    lw = dec["attn_net.L.weight"]                            # (D, 32)
    D, dt = lw.shape[0], lw.dtype
    acc = _acc_dtype(dt)
    W01 = torch.einsum("cik,dc->dik", dec["attn_net.conv.weight"].to(acc),
                       lw.to(acc)).reshape(D, 2 * CONV_K).to(dt)
    L_ = dec["res_rnn1.weight_hh"].shape[1]
    wm = dec["mel_proj.weight"].reshape(n_mels, max_r, L_)[:, :r]
    b = lambda t: t.to(acc)
    return (dec["attn_rnn.weight_ih"], b(dec["attn_rnn.bias_ih"]),
            dec["attn_rnn.weight_hh"], b(dec["attn_rnn.bias_hh"]),
            dec["attn_net.W.weight"],
            b(dec["attn_net.W.bias"] + dec["attn_net.L.bias"]),
            W01, dec["attn_net.v.weight"][0],
            dec["rnn_input.weight"], b(dec["rnn_input.bias"]),
            dec["res_rnn1.weight_ih"], dec["res_rnn1.weight_hh"],
            b(dec["res_rnn1.bias_ih"] + dec["res_rnn1.bias_hh"]),
            dec["res_rnn2.weight_ih"], dec["res_rnn2.weight_hh"],
            b(dec["res_rnn2.bias_ih"] + dec["res_rnn2.bias_hh"]),
            wm.transpose(0, 1).reshape(r * n_mels, L_))


def af_operands(dec: Dict[str, torch.Tensor], max_r: int, r: int,
                n_mels: int) -> Tuple[torch.Tensor, ...]:
    """The AF recurrence's weight operands (``AF_WEIGHTS`` order): the
    decoder prenet's (biases float32), then ``decoder_operands``."""
    acc = _acc_dtype(dec["prenet.fc1.weight"].dtype)
    return (dec["prenet.fc1.weight"], dec["prenet.fc1.bias"].to(acc),
            dec["prenet.fc2.weight"], dec["prenet.fc2.bias"].to(acc)) \
        + decoder_operands(dec, max_r, r, n_mels)


def _acc_dtype(dt):
    """The accumulation dtype: float32 for float32 and bfloat16 operands;
    float64 stays float64 (the gradient checks)."""
    return torch.promote_types(dt, torch.float32)


# the streams kept in the accumulation dtype at every compute dtype (the
# cumulative, q and the normaliser); the rest take the compute dtype
ACC_STREAMS = ("cum", "q", "div")


def _windows(x):
    """(B, T) -> (B, T, 31): [b, t, k] = x[b, t + k - 15], zero outside."""
    return F.pad(x, (CONV_HALF, CONV_HALF)).unfold(-1, CONV_K, 1)


def _energy_args(cum, att, q, encp, W01):
    """tanh((loc + encp) + q), (B, T, D): the location conv of the
    cumulative and previous attention composed with L."""
    loc = (torch.einsum("btk,dk->btd", _windows(cum), W01[:, :CONV_K])
           + torch.einsum("btk,dk->btd", _windows(att), W01[:, CONV_K:]))
    return torch.tanh(loc + encp + q[:, None])


def _lstm(x, h, c, z, wi, wh, b, rd=lambda t: t):
    L = h.shape[-1]
    g = x @ wi.t() + h @ wh.t() + b
    i, f = torch.sigmoid(g[:, :L]), torch.sigmoid(g[:, L:2 * L])
    gg, o = torch.tanh(g[:, 2 * L:3 * L]), torch.sigmoid(g[:, 3 * L:])
    c = rd(f * c + i * gg)
    h = rd(z * h + (1.0 - z) * (o * torch.tanh(c)))
    return h, c, torch.cat([i, f, gg, o], dim=-1)


def _forward(zm1, zm2, enc, encp, weights, save, pre=None, af=None):
    """The plain group loop of every arm. TF: ``pre`` (G, B, P2), the
    hoisted prenet. AF and free running: ``af`` = (aref, dm1, dm2, w1, b1,
    w2, b2); the prenet runs on the previous group's last mel frame
    (zeros at g = 0) with the scaled dropout keep-masks dm1/dm2, and the
    context weights are aref (G, B, T), or the scores when aref is None.
    The compute dtype is enc's; the math runs in ``_acc_dtype`` of it and
    rounds to it at the module docstring's points (``rd``)."""
    dt = enc.dtype
    acc = _acc_dtype(dt)
    f = lambda t: t.to(acc)
    rd = lambda t: t.to(dt).to(acc)
    (awi, abi, awh, abh, wq, qb, W01, v, wr, br, l1wi, l1wh, l1b, l2wi,
     l2wh, l2b, wm) = (f(w) for w in weights)
    enc, encp = f(enc), f(encp)
    G, B = zm1.shape[:2]
    T, E = enc.shape[1], enc.shape[2]
    D, L = wq.shape[0], wr.shape[0]
    z = lambda *s: enc.new_zeros(s)
    ah, ctx = z(B, D), z(B, E)
    h1, c1, h2, c2 = z(B, L), z(B, L), z(B, L), z(B, L)
    cum, att = z(B, T), z(B, T)
    mels, scs = [], []
    names = STREAMS if af is None else AF_STREAMS
    st = {k: [] for k in names} if save else None
    if af is not None:
        aref, dm1, dm2, w1, b1, w2, b2 = af
        w1, b1, w2, b2 = f(w1), f(b1), f(w2), f(b2)
        prev = z(B, w1.shape[1])
    for g in range(G):
        if af is not None:
            p1 = rd(torch.relu(prev @ w1.t() + b1) * f(dm1[g]))
            pre_g = rd(torch.relu(p1 @ w2.t() + b2) * f(dm2[g]))
            if save:
                st["prev"].append(prev)
                st["p1"].append(p1)
                st["pre"].append(pre_g)
        else:
            pre_g = f(pre[g])
        gi = torch.cat([ctx, pre_g], dim=1) @ awi.t() + abi
        gh = ah @ awh.t() + abh
        r = torch.sigmoid(gi[:, :D] + gh[:, :D])
        zg = torch.sigmoid(gi[:, D:2 * D] + gh[:, D:2 * D])
        hn = gh[:, 2 * D:]
        n = torch.tanh(gi[:, 2 * D:] + r * hn)
        ah = rd((1.0 - zg) * n + zg * ah)
        q = ah @ wq.t() + qb
        sig = torch.sigmoid(_energy_args(cum, att, q, encp, W01) @ v)
        div = sig.sum(dim=1)
        s = rd(sig / torch.where(div > 0, div, torch.ones_like(div))[:, None])
        cw = s if af is None or aref is None else f(aref[g])
        ctx = rd(torch.einsum("bt,bte->be", cw, enc))
        if save:
            st["cum"].append(cum)
            st["q"].append(q)
            st["div"].append(div)
            st["ah"].append(ah)
            st["gru"].append(torch.cat([r, zg, n, hn], dim=-1))
            st["ctx"].append(ctx)
        cum, att = cum + s, s
        x0 = rd(torch.cat([ctx, ah], dim=1) @ wr.t() + br)
        h1, c1, g1 = _lstm(x0, h1, c1, f(zm1[g]), l1wi, l1wh, l1b, rd)
        x1 = rd(x0 + h1)
        h2, c2, g2 = _lstm(x1, h2, c2, f(zm2[g]), l2wi, l2wh, l2b, rd)
        x2 = rd(x1 + h2)
        mel = rd(x2 @ wm.t())
        mels.append(mel)
        scs.append(s)
        if af is not None:
            prev = mel[:, mel.shape[1] - prev.shape[1]:]
        if save:
            for k, val in (("x0", x0), ("x1", x1), ("x2", x2), ("g1", g1),
                           ("g2", g2), ("c1", c1), ("h1", h1), ("c2", c2),
                           ("h2", h2)):
                st[k].append(val)
    streams = ({k: torch.stack(v_).to(acc if k in ACC_STREAMS else dt)
                for k, v_ in st.items()} if save else None)
    return torch.stack(mels).to(dt), torch.stack(scs), streams


def core_ref(pre, zm1, zm2, enc, encp, awi, abi, awh, abh, wq, qb, W01, v,
             wr, br, l1wi, l1wh, l1b, l2wi, l2wh, l2b, wm,
             save: bool = False):
    """Plain TF forward, one group at a time (``pallas_taco_train.py:
    983-1055`` in the batched layout): (mel (G, B, F) in the compute dtype,
    scores (G, B, T) in float32, streams), the streams a dict of ``STREAMS``
    when ``save``, else None. Differentiable by autograd."""
    weights = (awi, abi, awh, abh, wq, qb, W01, v, wr, br, l1wi, l1wh, l1b,
               l2wi, l2wh, l2b, wm)
    return _forward(zm1, zm2, enc, encp, weights, save, pre=pre)


def core_af_ref(aref, dm1, dm2, zm1, zm2, enc, encp, w1, b1, w2, b2,
                *weights, save: bool = False):
    """Plain AF forward (``pallas_taco_train.py:1058-1140`` in the batched
    layout): aref (G, B, T) weights the context; the prenet (w1 (P1,
    n_mels), b1, w2 (P2, P1), b2) runs on the carried last frame of the
    previous group's mel with the scaled dropout keep-masks dm1 (G, B, P1)
    / dm2 (G, B, P2). Returns (mel (G, B, F), scores (G, B, T), streams),
    the streams a dict of ``AF_STREAMS`` when ``save``. Differentiable by
    autograd."""
    return _forward(zm1, zm2, enc, encp, weights, save,
                    af=(aref, dm1, dm2, w1, b1, w2, b2))


def core_free_ref(dm1, dm2, zm1, zm2, enc, encp, w1, b1, w2, b2, *weights):
    """Plain free-running forward: ``core_af_ref`` with the context weighted
    by the decoder's own scores (the JAX package's ``free_running`` branch,
    which has no kernel). Returns (mel (G, B, F), scores (G, B, T))."""
    mel, sc, _ = _forward(zm1, zm2, enc, encp, weights, False,
                          af=(None, dm1, dm2, w1, b1, w2, b2))
    return mel, sc


def _lstm_bwd(dh, dc, gates, c, c_prev, z, wi, wh):
    L = dh.shape[-1]
    i, f = gates[:, :L], gates[:, L:2 * L]
    gg, o = gates[:, 2 * L:3 * L], gates[:, 3 * L:]
    tc = torch.tanh(c)
    dht = (1.0 - z) * dh
    dcn = dc + dht * o * (1.0 - tc * tc)
    dG = torch.cat([dcn * gg * i * (1.0 - i), dcn * c_prev * f * (1.0 - f),
                    dcn * i * (1.0 - gg * gg), dht * tc * o * (1.0 - o)],
                   dim=-1)
    return dG, dG @ wi, z * dh + dG @ wh, dcn * f


def _backward(dmel, dsc, streams, scores, zm1, zm2, enc, encp, weights,
              pre=None, af=None):
    """The plain reverse sweep of both arms (the kernels' spec), group by
    group from the forward's streams: TF with ``pre``; AF with ``af`` =
    (aref, dm1, dm2, w1, b1, w2, b2). Every operand is read in float32
    (``_acc_dtype``) and every cotangent stays in it; the results are
    returned in their operands' dtypes. Returns (d(pre) or d(aref), denc,
    dencp, the weight gradients by name)."""
    out_dt = {k: w.dtype for k, w in zip(WEIGHTS, weights)}
    out_dt.update(enc=enc.dtype, encp=encp.dtype)
    acc_dt = _acc_dtype(enc.dtype)
    f = lambda t: t.to(acc_dt)
    (awi, abi, awh, abh, wq, qb, W01, v, wr, br, l1wi, l1wh, l1b, l2wi,
     l2wh, l2b, wm) = weights = tuple(f(w) for w in weights)
    enc, encp, scores, dmel, zm1, zm2 = (f(t) for t in (enc, encp, scores,
                                                        dmel, zm1, zm2))
    G, B = zm1.shape[:2]
    T, E = enc.shape[1], enc.shape[2]
    D, L = wq.shape[0], wr.shape[0]
    dsc = scores.new_zeros(scores.shape) if dsc is None else f(dsc)
    s_ = {k: f(v_) for k, v_ in streams.items()}
    z = lambda *s: enc.new_zeros(s)
    dah, dctx = z(B, D), z(B, E)
    dh1, dc1, dh2, dc2 = z(B, L), z(B, L), z(B, L), z(B, L)
    dcum, datt = z(B, T), z(B, T)
    acc = {k: torch.zeros_like(w) for k, w in zip(WEIGHTS, weights)}
    denc, dencp = torch.zeros_like(enc), torch.zeros_like(encp)
    conv_w = torch.stack([W01[:, :CONV_K], W01[:, CONV_K:]], dim=1)
    if af is None:
        out_dt["first"] = pre.dtype
        pre = f(pre)
        dfirst = torch.empty_like(pre)                     # d(pre)
    else:
        out_dt["first"] = af[0].dtype
        out_dt.update((k, w.dtype) for k, w in zip(AF_PRENET, af[3:]))
        aref, dm1, dm2, w1, b1, w2, b2 = (f(t) for t in af)
        NM = w1.shape[1]
        dfirst = torch.empty_like(aref)                    # d(aref)
        for k, w in zip(AF_PRENET, (w1, b1, w2, b2)):
            acc[k] = torch.zeros_like(w)
        dprev = z(B, NM)

    def prev(name, g):
        return s_[name][g - 1] if g > 0 else torch.zeros_like(s_[name][0])

    for g in range(G - 1, -1, -1):
        x0, x1, x2 = s_["x0"][g], s_["x1"][g], s_["x2"][g]
        ah, ctx = s_["ah"][g], s_["ctx"][g]
        dmel_g = dmel[g]
        if af is not None:   # the next group's prenet read this last frame
            dmel_g = torch.cat([dmel_g[:, :-NM], dmel_g[:, -NM:] + dprev],
                               dim=1)
        # mel_proj and the two LSTMCells
        dx2 = dmel_g @ wm
        acc["wm"] += dmel_g.t() @ x2
        dG2, dxin2, dh2, dc2 = _lstm_bwd(dh2 + dx2, dc2, s_["g2"][g],
                                         s_["c2"][g], prev("c2", g), zm2[g],
                                         l2wi, l2wh)
        acc["l2wi"] += dG2.t() @ x1
        acc["l2wh"] += dG2.t() @ prev("h2", g)
        acc["l2b"] += dG2.sum(0)
        dx1 = dx2 + dxin2
        dG1, dxin1, dh1, dc1 = _lstm_bwd(dh1 + dx1, dc1, s_["g1"][g],
                                         s_["c1"][g], prev("c1", g), zm1[g],
                                         l1wi, l1wh)
        acc["l1wi"] += dG1.t() @ x0
        acc["l1wh"] += dG1.t() @ prev("h1", g)
        acc["l1b"] += dG1.sum(0)
        dx0 = dx1 + dxin1
        # rnn_input on [ctx | ah]
        dcat = dx0 @ wr
        acc["wr"] += dx0.t() @ torch.cat([ctx, ah], dim=1)
        acc["br"] += dx0.sum(0)
        dctx_t = dctx + dcat[:, :E]
        dah_t = dah + dcat[:, E:]
        # attention: context, cumulative and attention carries, normaliser
        s = scores[g]
        dcontract = torch.einsum("be,bte->bt", dctx_t, enc)
        if af is None:
            ds = dsc[g] + dcum + datt + dcontract
            denc += s[:, :, None] * dctx_t[:, None, :]
        else:
            ds = dsc[g] + dcum + datt
            dfirst[g] = dcontract
            denc += aref[g][:, :, None] * dctx_t[:, None, :]
        cum_p, att_p = s_["cum"][g], prev_scores(scores, g)
        arg = _energy_args(cum_p, att_p, s_["q"][g], encp, W01)
        sig = torch.sigmoid(arg @ v)
        div = s_["div"][g][:, None]
        S = (ds * s).sum(dim=1, keepdim=True)
        dsig = torch.where(div > 0, (ds - S) / div, ds)
        du = dsig * sig * (1.0 - sig)
        acc["v"] += torch.einsum("bt,btd->d", du, arg)
        dp = du[:, :, None] * v * (1.0 - arg * arg)             # (B, T, D)
        dencp += dp
        dq = dp.sum(dim=1)
        acc["W01"] += torch.cat(
            [torch.einsum("btd,btk->dk", dp, _windows(cum_p)),
             torch.einsum("btd,btk->dk", dp, _windows(att_p))], dim=1)
        dlocin = F.conv_transpose1d(dp.transpose(1, 2), conv_w,
                                    padding=CONV_HALF)         # (B, 2, T)
        dcum = dcum + dlocin[:, 0]
        datt = dlocin[:, 1]
        # query projection
        dah_t = dah_t + dq @ wq
        acc["wq"] += dq.t() @ ah
        acc["qb"] += dq.sum(0)
        # the attention GRUCell
        gr = s_["gru"][g]
        r, zg = gr[:, :D], gr[:, D:2 * D]
        n, hn = gr[:, 2 * D:3 * D], gr[:, 3 * D:]
        ah_p = prev("ah", g)
        dpre_n = dah_t * (1.0 - zg) * (1.0 - n * n)
        dpre_r = (dpre_n * hn) * r * (1.0 - r)
        dpre_z = dah_t * (ah_p - n) * zg * (1.0 - zg)
        dgi = torch.cat([dpre_r, dpre_z, dpre_n], dim=-1)
        dgh = torch.cat([dpre_r, dpre_z, dpre_n * r], dim=-1)
        dinp = dgi @ awi
        dctx = dinp[:, :E]
        dah = dah_t * zg + dgh @ awh
        pre_g = pre[g] if af is None else s_["pre"][g]
        acc["awi"] += dgi.t() @ torch.cat([prev("ctx", g), pre_g], dim=1)
        acc["abi"] += dgi.sum(0)
        acc["awh"] += dgh.t() @ ah_p
        acc["abh"] += dgh.sum(0)
        if af is None:
            dfirst[g] = dinp[:, E:]
            continue
        # the prenet (ReLU and dropout; dm1, dm2 >= 0), back to the
        # previous group's last mel frame
        p1 = s_["p1"][g]
        dp2 = dinp[:, E:] * dm2[g] * (pre_g > 0)
        acc["w2"] += dp2.t() @ p1
        acc["b2"] += dp2.sum(0)
        dp1 = (dp2 @ w2) * dm1[g] * (p1 > 0)
        acc["w1"] += dp1.t() @ s_["prev"][g]
        acc["b1"] += dp1.sum(0)
        dprev = dp1 @ w1
    return (dfirst.to(out_dt["first"]), denc.to(out_dt["enc"]),
            dencp.to(out_dt["encp"]),
            {k: g_.to(out_dt[k]) for k, g_ in acc.items()})


def core_bwd_ref(dmel, dsc, streams, scores, pre, zm1, zm2, enc, encp,
                 *weights):
    """Plain TF backward: the reverse sweep of the kernel, group by group,
    from the forward's streams. dmel (G, B, F), dsc (G, B, T) (the scores'
    cotangent, or None). Returns (dpre, denc, dencp, weight gradients in
    ``WEIGHTS`` order)."""
    dpre, denc, dencp, acc = _backward(dmel, dsc, streams, scores, zm1, zm2,
                                       enc, encp, weights, pre=pre)
    return (dpre, denc, dencp) + tuple(acc[k] for k in WEIGHTS)


def core_af_bwd_ref(dmel, dsc, streams, scores, aref, dm1, dm2, zm1, zm2,
                    enc, encp, w1, b1, w2, b2, *weights):
    """Plain AF backward, the B7 kernel's spec (``pallas_taco_train.py:
    440-446, 533-546, 597-628``): the previous-frame cotangent Dprev joins
    the last frame of the group before's dmel, the context contraction goes
    to d(aref) and not into the scores' cotangent, and the prenet's
    backward gives its weight gradients and Dprev. Returns (daref, denc,
    dencp, weight gradients in ``AF_WEIGHTS`` order)."""
    daref, denc, dencp, acc = _backward(
        dmel, dsc, streams, scores, zm1, zm2, enc, encp, weights,
        af=(aref, dm1, dm2, w1, b1, w2, b2))
    return (daref, denc, dencp) + tuple(acc[k] for k in AF_WEIGHTS)


def prev_scores(scores, g):
    """The attention carried into group g: the previous group's scores."""
    return scores[g - 1] if g > 0 else torch.zeros_like(scores[0])


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_FWD_IN = ("pre", "zm1", "zm2", "enc", "encp", "awi", "abi", "awh", "abh",
           "wq", "qb", "w01t", "v", "wr", "br", "l1wi", "l1wh", "l1b", "l2wi",
           "l2wh", "l2b", "wm")
_DIMS = ("G", "B", "T", "E", "D", "P2", "L", "F")


class _FwdArgs(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in _FWD_IN + ("mel", "scores")]
                + [(f"s_{k}", ctypes.c_void_p) for k in STREAMS]
                + [("work", ctypes.c_void_p)]
                + [(f, ctypes.c_int64) for f in _DIMS + ("save", "bc")])


_BWD_IN = ("pre", "zm1", "zm2", "enc", "encp", "scores", "dmel", "dsc", "wqT",
           "w01t", "v", "wmT", "l2wiT", "l2whT", "l1wiT", "l1whT", "wrT",
           "awiT", "awhT")
_COT = ("dgi", "dgh", "dq", "dx0", "dg1", "dg2")
_BWD_OUT = ("dpre", "denc", "dencp", "pw01", "pv", "dawi", "dabi", "dawh",
            "dabh", "dwq", "dqb", "dw01", "dv", "dwr", "dbr", "dl1wi",
            "dl1wh", "dl1b", "dl2wi", "dl2wh", "dl2b", "dwm")


class _BwdArgs(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in _BWD_IN]
                + [(f"s_{k}", ctypes.c_void_p) for k in STREAMS]
                + [(f"c_{k}", ctypes.c_void_p) for k in _COT]
                + [(f, ctypes.c_void_p) for f in _BWD_OUT]
                + [("work", ctypes.c_void_p)]
                + [(f, ctypes.c_int64) for f in _DIMS + ("bc",)])


class _AfFwdArgs(ctypes.Structure):   # AfFwdArgs in csrc/taco_train.cu
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "aref", "dm1", "dm2", "w1", "b1", "w2", "b2", "s_prev", "s_p1",
        "s_pre")] + [("P1", ctypes.c_int64), ("NM", ctypes.c_int64)])


class _AfBwdArgs(ctypes.Structure):   # AfBwdArgs
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "aref", "dm1", "dm2", "w1T", "w2T", "s_prev", "s_p1", "dmel",
        "c_dp1", "c_dp2", "daref", "dw1", "db1", "dw2", "db2")]
        + [("P1", ctypes.c_int64), ("NM", ctypes.c_int64)])


def _lib():
    lib = _build.load("taco_train")
    if not getattr(lib, "_typed", False):
        P, I64 = ctypes.c_void_p, ctypes.c_int64
        for fn, args, res in (
                (lib.wr_taco_tf_fwd, [P, P], ctypes.c_int),
                (lib.wr_taco_tf_bwd, [P, P], ctypes.c_int),
                (lib.wr_taco_af_fwd, [P, P, P], ctypes.c_int),
                (lib.wr_taco_af_bwd, [P, P, P], ctypes.c_int),
                (lib.wr_taco_tf_fwd_work_floats, [P], I64),
                (lib.wr_taco_tf_bwd_work_floats, [P], I64),
                (lib.wr_taco_tf_fwd_rows, [P], I64),
                (lib.wr_taco_tf_bwd_rows, [P], I64),
                (lib.wr_taco_af_fwd_rows, [P, P], I64),
                (lib.wr_taco_af_bwd_rows, [P, P], I64)):
            fn.argtypes, fn.restype = args, res
        lib._typed = True
    return lib


# ---------------------------------------------------------------------------
# the resident B7 body (csrc/taco_train_resident.cu)
# ---------------------------------------------------------------------------

def _up4(n: int) -> int:
    return (n + 3) // 4 * 4


RES_THREADS = 256
RES_WARPS = RES_THREADS // 32
TC = 16                  # text positions an attention item covers
NTAP = 2 * CONV_K        # the location weight's taps (cumulative, attention)
RES_RB = 8               # batch rows a staged pass holds at most
WINP = 48                # an item's window, padded
# the attention scratch (floats): the forward's windows, sums and the
# normaliser's partials; the backward's also the conv's input cotangents,
# the taps' products P (16 x 62) and dp (16 x D)
ATT_FWD_FLOATS = 2 * WINP + RES_WARPS * TC + TC + 16


def att_bwd_floats(D: int, nc: int) -> int:
    return (4 * WINP + RES_WARPS * TC + 2 * TC + 16 + TC * NTAP + _up4(nc)
            + TC * D)


def att_tf_bwd_floats(D: int, E: int, nc: int) -> int:
    """The TF backward's attention scratch: B7's, or phase A's (the
    contraction's partials, then the item's rnn_input part of d(ctx) and
    d(gi) of the group after), whichever is larger."""
    return max(att_bwd_floats(D, nc), 32 + _up4(E) + 3 * D)


GEMM_TILE_FLOATS = 2 * 16 * 64   # the TF body's products: one k-pass's tiles


H100_SMEM = 232448       # shared memory a block can opt into on the H100
RES_FIELDS = ("nblk", "tp", "kc", "smem_bytes", "off_w01t", "off_att",
              "off_x", "off_l1", "off_l2", "off_gw", "off_pv", "res_l1",
              "res_l2", "upb_l", "nc", "ipb", "gw_global", "ctx_smem",
              "epi_tt", "epi_gc")


# the profiling instantiation's labels (FProf / BProf in the source): each
# stage's own work, its attention items (between its arrival at the barrier
# and its wait there), and the wait
RES_PROF_FWD = ("prologue", "gru", "gru_wait", "query_rnn_input",
                "query_rnn_input_wait", "lstm1", "lstm1_att", "lstm1_wait",
                "lstm2", "lstm2_att", "lstm2_wait", "mel", "mel_att",
                "mel_wait", "prenet1", "prenet1_att", "prenet1_wait",
                "prenet2", "prenet2_att", "prenet2_wait", "epilogue")
RES_PROF_BWD = ("prologue", "s1_mel_lstm2", "s1_att", "s1_wait", "s2_lstm1",
                "s2_wait", "s3_dx0", "s3_att", "s3_wait",
                "s4_rnn_input_query_gru", "s4_att", "s4_wait", "s7_dpre",
                "s7_att", "s7_wait", "s8_dp1_dctx_dah", "s8_att", "s8_wait",
                "s9_dprev", "s9_wait", "epilogue")


# the TF body's labels (TFProf / TBProf in csrc/taco_tf_resident.cu): in
# each of a group's three intervals the attention chain's work, the mel
# chain's, then the wait at the barrier
RES_PROF_TF_FWD = ("prologue", "gru", "rnn_input", "gru_wait", "query",
                   "lstm1", "query_wait", "items", "lstm2", "items_wait",
                   "epilogue")
RES_PROF_TF_BWD = ("prologue", "gru_bwd", "mel_lstm2_lstm1", "gru_wait",
                   "phase_a", "mel_dx0", "phase_a_wait", "phase_b_dq",
                   "mel_rnn_input", "phase_b_wait", "epilogue")
# and, from counter 16 on, the split of block 0's attention items
# (TFItemProf / TBItemProf): inside "items", "phase_a" and "phase_b_dq"
RES_PROF_TF_FWD_ITEMS = ("windows", "energies", "partials_arrival",
                         "last_item_reduction")
RES_PROF_TF_BWD_ITEMS = ("a_load", "a_contraction", "a_ds",
                         "b_sum_windows", "b_energies", "b_dp_dencp",
                         "b_w01_grad", "b_conv_cotangents",
                         "b_contrib_arrival", "b_last_item_dq")


class _ResPlan(ctypes.Structure):   # ResPlan in csrc/taco_train_resident.cu
    _fields_ = [(f, ctypes.c_int64) for f in RES_FIELDS]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def af_resident_stages(dims) -> Dict[str, Dict[str, int]]:
    """Output units of every matrix stage of the resident body, by
    direction: unit j of a stage belongs to block j mod grid."""
    D, E, L, F = dims["D"], dims["E"], dims["L"], dims["F"]
    P1, P2, NM = dims["P1"], dims["P2"], dims["NM"]
    return {"fwd": {"prenet1": P1, "prenet2": P2, "gru": D,
                    "query_rnn_input": D + L, "lstm1": L, "lstm2": L,
                    "mel": F},
            "bwd": {"s1_mel_lstm2": L, "s2_lstm1": L, "s3_dx0": L,
                    "s4_rnn_input_query_gru": E + D, "s7_dpre": P2,
                    "s8_dp1_dctx_dah": P1 + E + D, "s9_dprev": NM}}


def _resident_plan(dims, sms, smem_bytes, att_fwd, att_bwd, kid, esize=4):
    """The plan both resident bodies share: (fwd fields, the end of the
    forward's regions in floats, bwd fields). ``esize``: the bytes of the
    weights' storage type (4 float32, 2 bfloat16): the location weight and
    the resident LSTM rows take that many bytes an entry."""
    G, B, T, E, D = (dims[k] for k in ("G", "B", "T", "E", "D"))
    L = dims["L"]
    cap = smem_bytes // 4
    nc = _cdiv(T, TC)
    tiles = min(4, _cdiv(B, RES_RB))
    base = dict(nblk=sms, nc=nc, ipb=_cdiv(B * nc, sms),
                upb_l=_cdiv(L, sms), res_l1=0, res_l2=0, off_l1=0, off_l2=0,
                off_gw=0, off_pv=0, gw_global=0, ctx_smem=0, epi_tt=0,
                epi_gc=0)
    w01t = _up4(_cdiv(NTAP * D * esize, 4))

    def chunk(plan, room):
        """tp and kc for a chunk in ``room`` floats at off_x."""
        for tp in range(tiles, 0, -1):
            kc = room // (RES_RB * tp)
            kc = kc // 128 * 128 if kc >= 128 else 0
            if kc:
                plan.update(tp=tp, kc=kc)
                return plan["off_x"] + RES_RB * tp * kc
        raise ValueError(f"no resident {kid} plan fits {dims} in "
                         f"{smem_bytes} bytes of shared memory")

    least = RES_RB * 128            # the smallest chunk: one tile, 128 columns
    # forward: the chunk's least, then the LSTMs' rows, then a wider chunk
    fwd = dict(base, off_w01t=4, off_att=4 + w01t)
    fwd["off_x"] = fwd["off_att"] + _up4(att_fwd)
    end = fwd["off_x"] + RES_RB * tiles * 128
    lstm = fwd["upb_l"] * 4 * 2 * L * esize // 4
    # (a row's bulk copy moves a multiple of 16 bytes)
    for k in ("l1", "l2"):
        if end + lstm <= cap and L * esize % 16 == 0:
            fwd[f"res_{k}"], fwd[f"off_{k}"] = 1, end
            end += lstm
    # the resident rows sit after the chunk: move them behind its final size
    room = cap - end + RES_RB * tiles * 128
    stop = chunk(fwd, room)
    shift = stop - (fwd["off_x"] + RES_RB * tiles * 128)
    for k in ("l1", "l2"):
        if fwd[f"res_{k}"]:
            fwd[f"off_{k}"] += shift
    end += shift

    # backward
    bwd = dict(base, off_w01t=4, off_att=4 + w01t)
    bwd["off_pv"] = bwd["off_att"] + _up4(att_bwd)
    fixed = bwd["off_pv"] + _up4(D)
    gw = _up4(NTAP * D)             # the location weight's float32 gradient
    if cap - fixed - gw >= least:
        bwd["off_gw"] = fixed
        fixed += gw
    else:
        bwd["gw_global"] = 1
    bwd["off_x"] = fixed
    bend = chunk(bwd, cap - fixed)
    E4 = E // 4
    bwd["epi_tt"] = tt = max(1, min(TC, 8 * RES_THREADS // E4))
    gc = min(G, (cap - 4 - tt * E) // (E + tt))
    if gc < 1:
        raise ValueError(f"no resident {kid} plan fits {dims} in "
                         f"{smem_bytes} bytes of shared memory")
    bwd["epi_gc"] = gc
    bwd["smem_bytes"] = 4 * max(bend, 4 + tt * E + gc * (E + tt))
    return fwd, end, bwd


def af_resident_plan(dims, sms: int = 132, smem_bytes: int = H100_SMEM,
                     esize: int = 4) -> Dict[str, Dict[str, int]]:
    """The resident B7 body's launch plan for ``dims`` (G, B, T, E, D, P1,
    P2, L, F, NM) on ``sms`` SMs with ``smem_bytes`` of shared memory a
    block: ``{"fwd": fields, "bwd": fields}``, each the ``ResPlan`` the
    kernel reads (``RES_FIELDS``; offsets in floats).

    One block per SM; unit j of a stage on block j mod grid
    (``af_resident_stages``). Attention items of 16 text positions of one
    utterance, item i on block i mod grid (``af_resident_items``). Shared
    memory holds the location weight, the attention scratch and a staged
    chunk of the stage inputs (``tp`` tiles of 8 batch rows by ``kc``
    columns, at least 128 columns); in the forward then the rows of the
    block's LSTM1 and LSTM2 units, each where it still fits (else the stage
    reads them through L2), the rest widening the chunk; in the backward
    the block's location-weight gradient, or, where that leaves no chunk,
    its slice of the partials in device memory. The forward's context
    product stages an utterance's enc when it fits (else reads it through
    L2); the backward's contraction takes ``epi_tt`` positions a task and
    ``epi_gc`` groups a chunk. Raises only where not even a chunk of one
    tile fits, which the original body does not fit either. ``esize``:
    the weights' bytes an entry (2 for the bfloat16 instantiation, whose
    location weight and resident rows take half the room)."""
    T, E, D = dims["T"], dims["E"], dims["D"]
    nc = _cdiv(T, TC)
    fwd, end, bwd = _resident_plan(dims, sms, smem_bytes,
                                   ATT_FWD_FLOATS + nc,
                                   att_bwd_floats(D, nc), "B7", esize)
    if 4 + T * E <= smem_bytes // 4:
        fwd["ctx_smem"] = 1
        end = max(end, 4 + T * E)
    fwd["smem_bytes"] = 4 * end
    return {"fwd": fwd, "bwd": bwd}


def tf_resident_stages(dims) -> Dict[str, Dict[str, int]]:
    """Output units of every matrix stage of the resident B6 body, by
    direction: unit j of a stage belongs to block j mod grid."""
    D, E, L = dims["D"], dims["E"], dims["L"]
    return {"fwd": {"gru": D, "rnn_input": L, "query": D, "lstm1": L,
                    "lstm2": L},
            "bwd": {"gru_bwd": D, "mel_lstm2_lstm1": L, "mel_dx0": L,
                    "mel_rnn_input": E + D}}


def tf_resident_plan(dims, sms: int = 132, smem_bytes: int = H100_SMEM,
                     esize: int = 4) -> Dict[str, Dict[str, int]]:
    """The resident B6 body's launch plan for ``dims`` (G, B, T, E, D, P2,
    L, F): ``{"fwd": fields, "bwd": fields}`` in the B7 body's ``ResPlan``
    (``RES_FIELDS``; offsets in floats), laid out as ``af_resident_plan``
    lays it out (``tf_resident_stages``; the items of
    ``af_resident_items``), with the TF arm's attention scratch, no context
    product in the forward's prologue, and room at the front for the
    products' tiles (``GEMM_TILE_FLOATS``) before the first group and after
    the last. A shape whose LSTM rows or location-weight gradient do not
    fit reads them from device memory; raises only where not even a chunk
    of one tile fits. ``esize`` as in ``af_resident_plan``."""
    T, E, D = dims["T"], dims["E"], dims["D"]
    nc = _cdiv(T, TC)
    fwd, end, bwd = _resident_plan(dims, sms, smem_bytes,
                                   ATT_FWD_FLOATS + nc,
                                   att_tf_bwd_floats(D, E, nc), "B6", esize)
    fwd["smem_bytes"] = 4 * max(end, 4 + GEMM_TILE_FLOATS)
    bwd["smem_bytes"] = max(bwd["smem_bytes"], 4 * (4 + GEMM_TILE_FLOATS))
    for p in (fwd, bwd):
        if p["smem_bytes"] > smem_bytes:
            raise ValueError(f"no resident B6 plan fits {dims} in "
                             f"{smem_bytes} bytes of shared memory")
    return {"fwd": fwd, "bwd": bwd}


def af_resident_units(plan, units: int, block: int):
    """The output units of a ``units``-wide stage that ``block`` owns, in
    its order (the kernel's: k, k + grid, ...)."""
    return list(range(block, units, plan["fwd"]["nblk"]))


def af_resident_regions(plan, direction: str, dims, tf: bool = False,
                        esize: int = 4) -> Dict[str, Tuple[int, int]]:
    """The shared-memory regions of one direction's plan that the main loop
    uses: name -> (offset, floats). The prologue's enc staging and the
    backward's contraction reuse the whole space after the loop; ``tf``:
    the B6 body's plan (its backward's attention scratch); ``esize`` the
    plan's (the weights' bytes an entry)."""
    p = plan[direction]
    D, L, nc = dims["D"], dims["L"], p["nc"]
    att = (ATT_FWD_FLOATS + nc if direction == "fwd"
           else att_tf_bwd_floats(D, dims["E"], nc) if tf
           else att_bwd_floats(D, nc))
    regions = {"mbarrier": (0, 4),
               "w01t": (p["off_w01t"], _cdiv(NTAP * D * esize, 4)),
               "attention": (p["off_att"], att),
               "chunk": (p["off_x"], RES_RB * p["tp"] * p["kc"])}
    if direction == "fwd":
        for k in ("l1", "l2"):
            if p[f"res_{k}"]:
                regions[f"lstm{k[1]}"] = (p[f"off_{k}"],
                                          p["upb_l"] * 4 * 2 * L * esize // 4)
    else:
        regions["v_grad"] = (p["off_pv"], D)
        if not p["gw_global"]:
            regions["w01_grad"] = (p["off_gw"], NTAP * D)
    return regions


def af_resident_items(plan, B: int, T: int, block: int):
    """The attention items of ``block`` in its order: (utterance, first
    position, end position)."""
    p = plan["fwd"]
    nblk, nc = p["nblk"], p["nc"]
    return [(it // nc, it % nc * TC, min(T, (it % nc + 1) * TC))
            for it in range(block, B * nc, nblk)]


def _res_lib():
    lib = _build.load("taco_train_resident")
    if not getattr(lib, "_typed", False):
        P, I64 = ctypes.c_void_p, ctypes.c_int64
        for fn, args, res in (
                (lib.wr_taco_af_res_fwd, [P, P, P, P, P], ctypes.c_int),
                (lib.wr_taco_af_res_bwd, [P, P, P, P, P], ctypes.c_int),
                (lib.wr_taco_af_res_fwd_work_floats, [P, P], I64),
                (lib.wr_taco_af_res_bwd_work_floats, [P, P], I64),
                (lib.wr_taco_af_res_fwd_bf16, [P, P, P, P], ctypes.c_int),
                (lib.wr_taco_af_res_bwd_bf16, [P, P, P, P], ctypes.c_int),
                (lib.wr_taco_af_res_fwd_bf16_work_floats, [P, P, P], I64)):
            fn.argtypes, fn.restype = args, res
        lib._typed = True
    return lib


def _tf_lib():
    lib = _build.load("taco_tf_resident")
    if not getattr(lib, "_typed", False):
        P, I64 = ctypes.c_void_p, ctypes.c_int64
        for fn, args, res in (
                (lib.wr_taco_tf_res_fwd, [P, P, P, P], ctypes.c_int),
                (lib.wr_taco_tf_res_bwd, [P, P, P, P], ctypes.c_int),
                (lib.wr_taco_tf_res_fwd_work_floats, [P, P], I64),
                (lib.wr_taco_tf_res_bwd_work_floats, [P, P], I64),
                (lib.wr_taco_tf_res_fwd_bf16, [P, P, P], ctypes.c_int),
                (lib.wr_taco_tf_res_bwd_bf16, [P, P, P], ctypes.c_int),
                (lib.wr_taco_tf_res_fwd_bf16_work_floats, [P, P], I64)):
            fn.argtypes, fn.restype = args, res
        lib._typed = True
    return lib


def _device_plan(dims, dev, tf: bool = False, esize: int = 4):
    props = torch.cuda.get_device_properties(dev)
    return (tf_resident_plan if tf else af_resident_plan)(
        dims, props.multi_processor_count,
        getattr(props, "shared_memory_per_block_optin", H100_SMEM), esize)


def _dims(G, B, enc, weights) -> Dict[str, int]:
    d = dict(G=G, B=B, P2=weights[0].shape[1] - enc.shape[2], T=enc.shape[1],
             E=enc.shape[2], D=weights[4].shape[0], L=weights[8].shape[0],
             F=weights[16].shape[0])
    if any(d[k] % 4 for k in ("E", "D", "P2", "L", "F")):
        raise ValueError(f"the B6/B7 kernels need E, D, P2, L and F "
                         f"divisible by 4, got {d}")
    return d


# the float32 operands at every compute dtype: the biases
BIASES = ("abi", "abh", "qb", "br", "l1b", "l2b", "b1", "b2")
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _operand_dtype(name, dt):
    return torch.float32 if name in BIASES else dt


def _check_weights(weights, d, dev, dt=torch.float32):
    D, E, P2, L, Fm = d["D"], d["E"], d["P2"], d["L"], d["F"]
    shapes = ((3 * D, E + P2), (3 * D,), (3 * D, D), (3 * D,), (D, D), (D,),
              (D, 2 * CONV_K), (D,), (L, E + D), (L,), (4 * L, L),
              (4 * L, L), (4 * L,), (4 * L, L), (4 * L, L), (4 * L,),
              (Fm, L))
    for name, w, shape in zip(WEIGHTS, weights, shapes):
        _build.check_operand(w, name, _operand_dtype(name, dt), shape, dev)


def _compute_dtype(enc, legacy, prof):
    """The kernels' compute dtype, enc's: float32, or bfloat16 on the
    resident bodies' bf16 instantiations (the original body and the
    profiling instantiation take float32 only)."""
    dt = enc.dtype
    if dt not in _KERNEL_DTYPES:
        raise TypeError(f"the B6/B7 kernels take float32 or bfloat16 "
                        f"operands, got {dt}")
    if dt == torch.bfloat16 and (legacy or prof is not None):
        raise ValueError("the original B6/B7 body (csrc/taco_train.cu) and "
                         "the profiling instantiation take float32 "
                         "operands only")
    return dt


def _prep_af(af, d, dev, dt=torch.float32):
    """The AF operands, checked and contiguous: (aref, dm1, dm2, w1, b1, w2,
    b2, P1, n_mels)."""
    aref, dm1, dm2, w1, b1, w2, b2 = (t.detach().contiguous() for t in af)
    P1, NM = w1.shape
    G, B, T, P2, Fm = d["G"], d["B"], d["T"], d["P2"], d["F"]
    if P1 % 4 or NM % 4 or Fm % NM:
        raise ValueError(f"the B7 kernels need P1 and n_mels divisible by 4 "
                         f"and F = r * n_mels, got P1 {P1}, n_mels {NM}, "
                         f"F {Fm}")
    for t, name, shape in ((aref, "aref", (G, B, T)), (dm1, "dm1", (G, B, P1)),
                           (dm2, "dm2", (G, B, P2)), (w1, "w1", (P1, NM)),
                           (b1, "b1", (P1,)), (w2, "w2", (P2, P1)),
                           (b2, "b2", (P2,))):
        _build.check_operand(t, name, _operand_dtype(name, dt), shape, dev)
    return aref, dm1, dm2, w1, b1, w2, b2, P1, NM


def _run(err, kid, what):
    if err:
        raise RuntimeError(f"{kid} {what} kernel launch failed: CUDA error "
                           f"{err}")


def _rows(bc, kid, what):
    if bc < 1:
        raise ValueError(f"no {kid} {what} launch fits these shapes in "
                         "shared memory")
    return bc


def _fwd_cuda(zm1, zm2, enc, encp, weights, save, pre=None, af=None,
              legacy=False, prof=None):
    """The forward kernel of either arm (TF: ``pre``; AF: ``af`` as in
    ``_forward``), on its resident body unless ``legacy`` (``prof`` a
    device int64 tensor of 64 counters for the resident body's profiling
    instantiation): (mel, scores, streams or None)."""
    dev = enc.device
    f32 = torch.float32
    kid = "B6" if af is None else "B7"
    dt = _compute_dtype(enc, legacy, prof)
    bf = dt == torch.bfloat16
    zm1, zm2, enc, encp = (t.contiguous() for t in (zm1, zm2, enc, encp))
    weights = tuple(w.detach().contiguous() for w in weights)
    d = _dims(zm1.shape[0], zm1.shape[1], enc, weights)
    G, B, T, E, D, P2, L, Fm = (d[k] for k in _DIMS)
    for t, name, shape in ((zm1, "zm1", (G, B, L)), (zm2, "zm2", (G, B, L)),
                           (enc, "enc", (B, T, E)), (encp, "encp", (B, T, D))):
        _build.check_operand(t, name, dt, shape, dev)
    _check_weights(weights, d, dev, dt)
    if af is None:
        pre = pre.contiguous()
        _build.check_operand(pre, "pre", dt, (G, B, P2), dev)
    else:
        aref, dm1, dm2, w1, b1, w2, b2, P1, NM = _prep_af(af, d, dev, dt)
        extra = {k: torch.empty(G, B, n, dtype=dt, device=dev)
                 for k, n in (("prev", NM), ("p1", P1), ("pre", P2))}
        pre = extra["pre"]
    w = dict(zip(WEIGHTS, weights))
    w01t = w["W01"].t().contiguous()
    mel = torch.empty(G, B, Fm, dtype=dt, device=dev)
    scores = torch.empty(G, B, T, dtype=f32, device=dev)
    widths = dict(cum=T, q=D, div=1, ah=D, gru=4 * D, ctx=E, x0=L, x1=L,
                  x2=L, g1=4 * L, g2=4 * L, c1=L, h1=L, c2=L, h2=L)
    streams = ({k: torch.empty(G, B, widths[k], device=dev,
                               dtype=f32 if k in ACC_STREAMS else dt)
                for k in STREAMS} if save else None)
    ptrs = dict(pre=pre, zm1=zm1, zm2=zm2, enc=enc, encp=encp, w01t=w01t,
                mel=mel, scores=scores,
                **{k: w[k] for k in WEIGHTS if k != "W01"})
    args = _FwdArgs(**{k: v.data_ptr() for k, v in ptrs.items()}, **d,
                    save=int(save))
    if save:
        for k, t in streams.items():
            setattr(args, f"s_{k}", t.data_ptr())
    if af is not None:
        xargs = _AfFwdArgs(
            **{k: t.data_ptr() for k, t in (
                ("aref", aref), ("dm1", dm1), ("dm2", dm2), ("w1", w1),
                ("b1", b1), ("w2", w2), ("b2", b2))},
            **{f"s_{k}": t.data_ptr() for k, t in extra.items()},
            P1=P1, NM=NM)
    stream = torch.cuda.current_stream(dev).cuda_stream
    pptr = None if prof is None else prof.data_ptr()
    esize = dt.itemsize
    if af is not None and not legacy:
        lib = _res_lib()
        plan = _ResPlan(**_device_plan(dict(d, P1=P1, NM=NM), dev,
                                       esize=esize)["fwd"])
        if bf:
            nw = lib.wr_taco_af_res_fwd_bf16_work_floats(
                ctypes.byref(args), ctypes.byref(xargs), ctypes.byref(plan))
        else:
            nw = lib.wr_taco_af_res_fwd_work_floats(ctypes.byref(args),
                                                    ctypes.byref(plan))
        work = torch.zeros(nw, dtype=f32, device=dev)
        args.work = work.data_ptr()
        with torch.cuda.device(dev):
            if bf:
                err = lib.wr_taco_af_res_fwd_bf16(
                    ctypes.byref(args), ctypes.byref(xargs),
                    ctypes.byref(plan), stream)
            else:
                err = lib.wr_taco_af_res_fwd(
                    ctypes.byref(args), ctypes.byref(xargs),
                    ctypes.byref(plan), pptr, stream)
            _run(err, kid, "forward")
        _count(decoder_af, "fwd", resident=True, bf16=bf)
    elif not legacy:
        lib = _tf_lib()
        plan = _ResPlan(**_device_plan(d, dev, tf=True, esize=esize)["fwd"])
        nw = (lib.wr_taco_tf_res_fwd_bf16_work_floats if bf
              else lib.wr_taco_tf_res_fwd_work_floats)(ctypes.byref(args),
                                                       ctypes.byref(plan))
        work = torch.zeros(nw, dtype=f32, device=dev)
        args.work = work.data_ptr()
        with torch.cuda.device(dev):
            if bf:
                err = lib.wr_taco_tf_res_fwd_bf16(
                    ctypes.byref(args), ctypes.byref(plan), stream)
            else:
                err = lib.wr_taco_tf_res_fwd(ctypes.byref(args),
                                             ctypes.byref(plan), pptr, stream)
            _run(err, kid, "forward")
        _count(decoder_tf, "fwd", resident=True, bf16=bf)
    else:
        lib = _lib()
        if af is None:
            args.bc = _rows(lib.wr_taco_tf_fwd_rows(ctypes.byref(args)), kid,
                            "forward")
        else:
            args.bc = _rows(lib.wr_taco_af_fwd_rows(ctypes.byref(args),
                                                    ctypes.byref(xargs)),
                            kid, "forward")
        work = torch.zeros(lib.wr_taco_tf_fwd_work_floats(
            ctypes.byref(args)), dtype=f32, device=dev)
        args.work = work.data_ptr()
        with torch.cuda.device(dev):
            if af is None:
                _run(lib.wr_taco_tf_fwd(ctypes.byref(args), stream), kid,
                     "forward")
                _count(decoder_tf, "fwd", resident=False)
            else:
                _run(lib.wr_taco_af_fwd(ctypes.byref(args),
                                        ctypes.byref(xargs), stream), kid,
                     "forward")
                _count(decoder_af, "fwd", resident=False)
    if save:
        streams["div"] = streams["div"][..., 0]
        if af is not None:
            streams.update(extra)
    return mel, scores, streams


def _bwd_cuda(dmel, dsc, streams, scores, zm1, zm2, enc, encp, weights,
              pre=None, af=None, legacy=False, prof=None):
    """The backward kernel of either arm and its weight-gradient
    reductions (on its resident body unless ``legacy``; ``prof`` as in
    ``_fwd_cuda``): (d(pre) or d(aref), denc, dencp, weight gradients by
    name)."""
    dev = enc.device
    f32 = torch.float32
    kid = "B6" if af is None else "B7"
    dt = _compute_dtype(enc, legacy, prof)
    bf = dt == torch.bfloat16
    # the autograd Functions save their inputs as given: a shard's masks
    # sliced on the batch axis are strided, and the kernel reads rows
    zm1, zm2, enc, encp = (t.contiguous() for t in (zm1, zm2, enc, encp))
    weights = tuple(w.detach().contiguous() for w in weights)
    d = _dims(zm1.shape[0], zm1.shape[1], enc, weights)
    G, B, T, E, D, P2, L, Fm = (d[k] for k in _DIMS)
    for t, name, shape in ((zm1, "zm1", (G, B, L)), (zm2, "zm2", (G, B, L)),
                           (enc, "enc", (B, T, E)), (encp, "encp", (B, T, D))):
        _build.check_operand(t, name, dt, shape, dev)
    if af is None:
        pre = pre.contiguous()
        _build.check_operand(pre, "pre", dt, (G, B, P2), dev)
    # the cotangents are float32 (a bfloat16 output's arrives bfloat16);
    # AF: the kernel adds each group's previous-frame cotangent into its
    # own copy of dmel, which the mel_proj gradient then reads
    dmel = dmel.to(f32)
    dmel = dmel.contiguous() if af is None else dmel.clone(
        memory_format=torch.contiguous_format)
    dsc = (torch.zeros_like(scores) if dsc is None
           else dsc.to(f32).contiguous())
    for t, name, shape in ((dmel, "dmel", (G, B, Fm)),
                           (dsc, "dsc", (G, B, T)),
                           (scores, "scores", (G, B, T))):
        _build.check_operand(t, name, f32, shape, dev)
    _check_weights(weights, d, dev, dt)
    if af is not None:
        aref, dm1, dm2, w1, b1, w2, b2, P1, NM = _prep_af(af, d, dev, dt)
        pre = streams["pre"]
    w = dict(zip(WEIGHTS, weights))
    tr = lambda t: t.t().contiguous()
    ptrs = dict(pre=pre, zm1=zm1, zm2=zm2, enc=enc, encp=encp,
                scores=scores, dmel=dmel, dsc=dsc, wqT=tr(w["wq"]),
                w01t=tr(w["W01"]), v=w["v"], wmT=tr(w["wm"]),
                l2wiT=tr(w["l2wi"]), l2whT=tr(w["l2wh"]),
                l1wiT=tr(w["l1wi"]), l1whT=tr(w["l1wh"]), wrT=tr(w["wr"]),
                awiT=tr(w["awi"]), awhT=tr(w["awh"]))
    streams = dict(streams, div=streams["div"][..., None])
    for k in STREAMS:
        ptrs[f"s_{k}"] = streams[k].contiguous()
        _build.check_operand(ptrs[f"s_{k}"], f"stream {k}",
                             f32 if k in ACC_STREAMS else dt,
                             streams[k].shape, dev)
    cw = dict(dgi=3 * D, dgh=3 * D, dq=D, dx0=L, dg1=4 * L, dg2=4 * L)
    for k in _COT:
        ptrs[f"c_{k}"] = torch.empty(G, B, cw[k], dtype=f32, device=dev)
    resident = not legacy
    if resident and af is None:
        plan = _device_plan(d, dev, tf=True, esize=dt.itemsize)["bwd"]
    elif resident:
        plan = _device_plan(dict(d, P1=af[3].shape[0], NM=af[3].shape[1]),
                            dev, esize=dt.itemsize)["bwd"]
    # the location-weight and v partials: one per utterance (the original
    # body), one per block of the grid (the resident body); every gradient
    # is formed in float32 and returned in its operand's dtype
    parts = plan["nblk"] if resident else B
    f32_like = lambda t: torch.empty(t.shape, dtype=f32, device=dev)
    outs = dict(denc=torch.zeros(enc.shape, dtype=f32, device=dev),
                dencp=torch.zeros(encp.shape, dtype=f32, device=dev),
                pw01=torch.zeros(parts, 2 * CONV_K, D, dtype=f32, device=dev),
                pv=torch.zeros(parts, D, dtype=f32, device=dev))
    if af is None:
        outs["dpre"] = f32_like(pre)
    for k, wt in zip(WEIGHTS, weights):
        outs["dw01" if k == "W01" else f"d{k}"] = f32_like(wt)
    ptrs.update(outs)
    args = _BwdArgs(**{k: v.data_ptr() for k, v in ptrs.items()}, **d)
    lib = (_lib() if not resident else _res_lib() if af is not None
           else _tf_lib())
    if af is None:
        if not resident:
            args.bc = _rows(lib.wr_taco_tf_bwd_rows(ctypes.byref(args)), kid,
                            "backward")
    else:
        af_outs = dict(daref=f32_like(aref), dw1=f32_like(w1),
                       db1=f32_like(b1), dw2=f32_like(w2), db2=f32_like(b2),
                       c_dp1=torch.empty(G, B, P1, dtype=f32, device=dev),
                       c_dp2=torch.empty(G, B, P2, dtype=f32, device=dev))
        af_ins = dict(aref=aref, dm1=dm1, dm2=dm2, w1T=tr(w1), w2T=tr(w2),
                      s_prev=streams["prev"].contiguous(),
                      s_p1=streams["p1"].contiguous(), dmel=dmel)
        xargs = _AfBwdArgs(**{k: t.data_ptr() for k, t in
                              {**af_ins, **af_outs}.items()}, P1=P1, NM=NM)
        if not resident:
            args.bc = _rows(lib.wr_taco_af_bwd_rows(ctypes.byref(args),
                                                    ctypes.byref(xargs)),
                            kid, "backward")
    stream = torch.cuda.current_stream(dev).cuda_stream
    pptr = None if prof is None else prof.data_ptr()
    if resident and af is not None:
        cplan = _ResPlan(**plan)
        work = torch.zeros(lib.wr_taco_af_res_bwd_work_floats(
            ctypes.byref(args), ctypes.byref(cplan)), dtype=f32, device=dev)
        args.work = work.data_ptr()
        with torch.cuda.device(dev):
            if bf:
                err = lib.wr_taco_af_res_bwd_bf16(
                    ctypes.byref(args), ctypes.byref(xargs),
                    ctypes.byref(cplan), stream)
            else:
                err = lib.wr_taco_af_res_bwd(
                    ctypes.byref(args), ctypes.byref(xargs),
                    ctypes.byref(cplan), pptr, stream)
            _run(err, kid, "backward")
        _count(decoder_af, "bwd", resident=True, bf16=bf)
    elif resident:
        cplan = _ResPlan(**plan)
        work = torch.zeros(lib.wr_taco_tf_res_bwd_work_floats(
            ctypes.byref(args), ctypes.byref(cplan)), dtype=f32, device=dev)
        args.work = work.data_ptr()
        with torch.cuda.device(dev):
            if bf:
                err = lib.wr_taco_tf_res_bwd_bf16(
                    ctypes.byref(args), ctypes.byref(cplan), stream)
            else:
                err = lib.wr_taco_tf_res_bwd(ctypes.byref(args),
                                             ctypes.byref(cplan), pptr,
                                             stream)
            _run(err, kid, "backward")
        _count(decoder_tf, "bwd", resident=True, bf16=bf)
    else:
        work = torch.zeros(lib.wr_taco_tf_bwd_work_floats(
            ctypes.byref(args)), dtype=f32, device=dev)
        args.work = work.data_ptr()
        with torch.cuda.device(dev):
            if af is None:
                _run(lib.wr_taco_tf_bwd(ctypes.byref(args), stream), kid,
                     "backward")
                _count(decoder_tf, "bwd", resident=False)
            else:
                _run(lib.wr_taco_af_bwd(ctypes.byref(args),
                                        ctypes.byref(xargs), stream), kid,
                     "backward")
                _count(decoder_af, "bwd", resident=False)
    grads = {k: outs["dw01" if k == "W01" else f"d{k}"].to(w.dtype)
             for k, w in zip(WEIGHTS, weights)}
    denc, dencp = outs["denc"].to(enc.dtype), outs["dencp"].to(encp.dtype)
    if af is None:
        return outs["dpre"].to(pre.dtype), denc, dencp, grads
    grads.update((k, af_outs[f"d{k}"].to(t.dtype))
                 for k, t in zip(AF_PRENET, (w1, b1, w2, b2)))
    return af_outs["daref"].to(aref.dtype), denc, dencp, grads


def decoder_tf_fwd(pre, zm1, zm2, enc, encp, weights, save: bool,
                   _legacy: bool = False, _profile=None):
    """Forward over all groups: (mel (G, B, F), scores (G, B, T), streams
    or None). CPU: ``core_ref``; CUDA: the B6 forward kernel on the
    resident body, or, with the private ``_legacy``, on the original body
    (the yardstick). ``_profile``: a device int64 tensor of 64 counters;
    the resident body's profiling instantiation adds each stage's cycles on
    block 0 to it."""
    if pre.device.type == "cpu":
        return core_ref(pre, zm1, zm2, enc, encp, *weights, save=save)
    if pre.device.type != "cuda":
        raise ValueError(f"no B6 kernel for {pre.device}")
    return _fwd_cuda(zm1, zm2, enc, encp, weights, save, pre=pre,
                     legacy=_legacy, prof=_profile)


def decoder_tf_bwd(dmel, dsc, streams, scores, pre, zm1, zm2, enc, encp,
                   weights, _legacy: bool = False, _profile=None):
    """Backward over all groups: (dpre, denc, dencp, weight gradients in
    ``WEIGHTS`` order). CPU: ``core_bwd_ref``; CUDA: the B6 backward kernel
    (the resident body, or the original with ``_legacy``) and its
    weight-gradient reductions. Either backward takes either forward's
    streams."""
    if pre.device.type == "cpu":
        return core_bwd_ref(dmel, dsc, streams, scores, pre, zm1, zm2, enc,
                            encp, *weights)
    if pre.device.type != "cuda":
        raise ValueError(f"no B6 kernel for {pre.device}")
    dpre, denc, dencp, grads = _bwd_cuda(dmel, dsc, streams, scores, zm1,
                                         zm2, enc, encp, weights, pre=pre,
                                         legacy=_legacy, prof=_profile)
    return (dpre, denc, dencp) + tuple(grads[k] for k in WEIGHTS)


class _DecoderTF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, legacy, pre, zm1, zm2, enc, encp, *weights):
        mel, scores, streams = decoder_tf_fwd(pre, zm1, zm2, enc, encp,
                                              weights, save=True,
                                              _legacy=legacy)
        ctx.legacy = legacy
        ctx.save_for_backward(pre, zm1, zm2, enc, encp, scores, *weights,
                              *(streams[k] for k in STREAMS))
        return mel, scores

    @staticmethod
    def backward(ctx, dmel, dsc):
        saved = ctx.saved_tensors
        pre, zm1, zm2, enc, encp, scores = saved[:6]
        weights = saved[6:6 + len(WEIGHTS)]
        streams = dict(zip(STREAMS, saved[6 + len(WEIGHTS):]))
        dpre, denc, dencp, *dw = decoder_tf_bwd(
            dmel, dsc, streams, scores, pre, zm1, zm2, enc, encp, weights,
            _legacy=ctx.legacy)
        return (None, dpre, None, None, denc, dencp, *dw)


def decoder_tf(pre, zm1, zm2, enc, encp, weights, _legacy: bool = False):
    """The recurrence as kernels (B6), differentiable in pre, enc, encp and
    every weight: (mel (G, B, F), scores (G, B, T)). Without autograd (no
    input needs a gradient, or grad mode off: the eval-mode GTA and
    attention export, the AF-online teacher) the forward writes no
    streams. The private ``_legacy`` runs the original body (the
    yardstick)."""
    tensors = (pre, enc, encp) + tuple(weights)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _DecoderTF.apply(_legacy, pre, zm1, zm2, enc, encp, *weights)
    mel, scores, _ = decoder_tf_fwd(pre, zm1, zm2, enc, encp, weights,
                                    save=False, _legacy=_legacy)
    return mel, scores


# launches of B6 on either body, and on the resident and the original body
decoder_tf.fwd_launches = 0
decoder_tf.bwd_launches = 0
decoder_tf.resident_fwd_launches = 0
decoder_tf.resident_bwd_launches = 0
decoder_tf.legacy_fwd_launches = 0
decoder_tf.legacy_bwd_launches = 0
# of them on the resident body's bf16 instantiation
decoder_tf.bf16_fwd_launches = 0
decoder_tf.bf16_bwd_launches = 0


def decoder_af_fwd(aref, dm1, dm2, zm1, zm2, enc, encp, weights, save: bool,
                   _legacy: bool = False, _profile=None):
    """AF forward over all groups (weights in ``AF_WEIGHTS`` order): (mel
    (G, B, F), scores (G, B, T), streams (``AF_STREAMS``) or None). CPU:
    ``core_af_ref``; CUDA: the B7 forward kernel on the resident body, or,
    with the private ``_legacy``, on the original body (the yardstick).
    ``_profile``: a device int64 tensor of 64 counters; the resident body's
    profiling instantiation adds each stage's cycles on block 0 to it."""
    if enc.device.type == "cpu":
        return core_af_ref(aref, dm1, dm2, zm1, zm2, enc, encp, *weights,
                           save=save)
    if enc.device.type != "cuda":
        raise ValueError(f"no B7 kernel for {enc.device}")
    return _fwd_cuda(zm1, zm2, enc, encp, weights[4:], save,
                     af=(aref, dm1, dm2) + tuple(weights[:4]),
                     legacy=_legacy, prof=_profile)


def decoder_af_bwd(dmel, dsc, streams, scores, aref, dm1, dm2, zm1, zm2, enc,
                   encp, weights, _legacy: bool = False, _profile=None):
    """AF backward over all groups: (daref, denc, dencp, weight gradients
    in ``AF_WEIGHTS`` order). CPU: ``core_af_bwd_ref``; CUDA: the B7
    backward kernel (the resident body, or the original with ``_legacy``)
    and its weight-gradient reductions. Either backward takes either
    forward's streams."""
    if enc.device.type == "cpu":
        return core_af_bwd_ref(dmel, dsc, streams, scores, aref, dm1, dm2,
                               zm1, zm2, enc, encp, *weights)
    if enc.device.type != "cuda":
        raise ValueError(f"no B7 kernel for {enc.device}")
    daref, denc, dencp, grads = _bwd_cuda(
        dmel, dsc, streams, scores, zm1, zm2, enc, encp, weights[4:],
        af=(aref, dm1, dm2) + tuple(weights[:4]), legacy=_legacy,
        prof=_profile)
    return (daref, denc, dencp) + tuple(grads[k] for k in AF_WEIGHTS)


class _DecoderAF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, legacy, aref, dm1, dm2, zm1, zm2, enc, encp, *weights):
        mel, scores, streams = decoder_af_fwd(aref, dm1, dm2, zm1, zm2, enc,
                                              encp, weights, save=True,
                                              _legacy=legacy)
        ctx.legacy = legacy
        ctx.save_for_backward(aref, dm1, dm2, zm1, zm2, enc, encp, scores,
                              *weights, *(streams[k] for k in AF_STREAMS))
        return mel, scores

    @staticmethod
    def backward(ctx, dmel, dsc):
        saved = ctx.saved_tensors
        aref, dm1, dm2, zm1, zm2, enc, encp, scores = saved[:8]
        weights = saved[8:8 + len(AF_WEIGHTS)]
        streams = dict(zip(AF_STREAMS, saved[8 + len(AF_WEIGHTS):]))
        daref, denc, dencp, *dw = decoder_af_bwd(
            dmel, dsc, streams, scores, aref, dm1, dm2, zm1, zm2, enc, encp,
            weights, _legacy=ctx.legacy)
        return (None, daref, None, None, None, None, denc, dencp, *dw)


def decoder_af(aref, dm1, dm2, zm1, zm2, enc, encp, weights,
               _legacy: bool = False):
    """The AF recurrence as kernels (B7), differentiable in aref, enc, encp
    and every weight (``AF_WEIGHTS`` order): (mel (G, B, F), scores (G, B,
    T)). Without autograd the forward writes only the prenet's streams.
    The private ``_legacy`` runs the original body (the yardstick)."""
    tensors = (aref, enc, encp) + tuple(weights)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _DecoderAF.apply(_legacy, aref, dm1, dm2, zm1, zm2, enc, encp,
                                *weights)
    mel, scores, _ = decoder_af_fwd(aref, dm1, dm2, zm1, zm2, enc, encp,
                                    weights, save=False, _legacy=_legacy)
    return mel, scores


def _count(wrapper, direction: str, resident: bool, bf16: bool = False):
    """One B6 (``decoder_tf``) or B7 (``decoder_af``) launch: its total, its
    body's own count, and the bf16 instantiation's."""
    body = "resident" if resident else "legacy"
    names = [f"{direction}_launches", f"{body}_{direction}_launches"]
    if bf16:
        names.append(f"bf16_{direction}_launches")
    for name in names:
        setattr(wrapper, name, getattr(wrapper, name) + 1)


# launches of B7 on either body, and on the resident and the original body
decoder_af.fwd_launches = 0
decoder_af.bwd_launches = 0
decoder_af.resident_fwd_launches = 0
decoder_af.resident_bwd_launches = 0
decoder_af.legacy_fwd_launches = 0
decoder_af.legacy_bwd_launches = 0
decoder_af.bf16_fwd_launches = 0
decoder_af.bf16_bwd_launches = 0


def decoder_tf_train(dec, encoder_seq, encoder_seq_proj, pre_all, zm1, zm2,
                     max_r: int, r: int, n_mels: int, impl: str = "kernel"):
    """The teacher-forcing decoder recurrence (``pallas_taco_train.py:
    1163-1197``). dec: the decoder's parameters by state-dict name below
    ``decoder.``; encoder_seq (B, T, E), encoder_seq_proj (B, T, D),
    pre_all (G, B, P2), zm1/zm2 (G, B, L). impl "kernel": ``decoder_tf``
    (B6 on CUDA tensors, its plain versions on CPU tensors); "scan": the
    plain forward under autograd.
    Returns (mel_groups (G, B, n_mels, r), attn_scores (G, B, T))."""
    weights = decoder_operands(dec, max_r, r, n_mels)
    zm1, zm2 = zm1.to(pre_all.dtype), zm2.to(pre_all.dtype)
    if impl == "scan":
        mel, sc, _ = core_ref(pre_all, zm1, zm2, encoder_seq,
                              encoder_seq_proj, *weights)
    else:
        mel, sc = decoder_tf(pre_all, zm1, zm2, encoder_seq,
                             encoder_seq_proj, weights)
    G, B = mel.shape[:2]
    return mel.reshape(G, B, r, n_mels).transpose(2, 3), sc


def decoder_af_train(dec, encoder_seq, encoder_seq_proj, attn_ref, dm1, dm2,
                     zm1, zm2, max_r: int, r: int, n_mels: int,
                     impl: str = "kernel"):
    """The attention-forcing decoder recurrence (``pallas_taco_train.py:
    1299-1346``). attn_ref (B, G, T) the reference attention; dm1/dm2
    (G, B, P1/P2) the decoder prenet's scaled dropout keep-masks (ones in
    eval); zm1/zm2 (G, B, L) zoneout masks (zeros in eval). impl "kernel":
    ``decoder_af`` (B7 on CUDA tensors, its plain versions on CPU
    tensors); "scan": the plain forward under autograd.
    Returns (mel_groups (G, B, n_mels, r), attn_scores (G, B, T))."""
    weights = af_operands(dec, max_r, r, n_mels)
    dt = encoder_seq.dtype
    aref = attn_ref.to(dt).transpose(0, 1).contiguous()
    dm1, dm2, zm1, zm2 = (t.to(dt) for t in (dm1, dm2, zm1, zm2))
    if impl == "scan":
        mel, sc, _ = core_af_ref(aref, dm1, dm2, zm1, zm2, encoder_seq,
                                 encoder_seq_proj, *weights)
    else:
        mel, sc = decoder_af(aref, dm1, dm2, zm1, zm2, encoder_seq,
                             encoder_seq_proj, weights)
    G, B = mel.shape[:2]
    return mel.reshape(G, B, r, n_mels).transpose(2, 3), sc
