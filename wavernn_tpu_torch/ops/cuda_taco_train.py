"""Tacotron teacher-forcing decoder training recurrence (kernel B6): the
CUDA kernels' wrappers, the autograd Function and the plain PyTorch
versions.

Port of ``wavernn_tpu/ops/pallas_taco_train.py``: ``decoder_tf_train`` and
its operand preparation, ``zoneout_masks``, and the TPU kernels
``_make_fwd_kernel(af=False)`` / ``_make_bwd_kernel(af=False)`` behind the
custom VJP ``_core``. The kernels (``csrc/taco_train.cu``) run all G groups
of the batch in one cooperative launch per direction; the backward launch
also forms every weight gradient of the recurrence with hand-written
reduction kernels. ``core_ref`` is the plain forward (the JAX package's
``core_ref`` in the natural batched layout) and ``core_bwd_ref`` the plain
backward, a hand-written reverse sweep with the kernels' arithmetic.

The operands keep their natural batched form: pre (G, B, P2) hoisted
prenet outputs, zm1/zm2 (G, B, L) zoneout keep-previous masks (1 keeps the
previous h; zeros are eval mode), enc (B, T, E), encp (B, T, D), and the
weights of ``WEIGHTS`` in torch's (out, in) layouts: the location conv
composed with L as W01 (D, 62) (cumulative taps, then attention taps),
qb = W.b + L.b, the LSTM biases summed, and mel_proj's rows of the r frames
reordered frame-major (F = r * n_mels). float32 only.

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
    autograd carries the operands' gradients back to the parameters."""
    lw = dec["attn_net.L.weight"]                            # (D, 32)
    D = lw.shape[0]
    W01 = torch.einsum("cik,dc->dik", dec["attn_net.conv.weight"],
                       lw).reshape(D, 2 * CONV_K)
    L_ = dec["res_rnn1.weight_hh"].shape[1]
    wm = dec["mel_proj.weight"].reshape(n_mels, max_r, L_)[:, :r]
    return (dec["attn_rnn.weight_ih"], dec["attn_rnn.bias_ih"],
            dec["attn_rnn.weight_hh"], dec["attn_rnn.bias_hh"],
            dec["attn_net.W.weight"],
            dec["attn_net.W.bias"] + dec["attn_net.L.bias"],
            W01, dec["attn_net.v.weight"][0],
            dec["rnn_input.weight"], dec["rnn_input.bias"],
            dec["res_rnn1.weight_ih"], dec["res_rnn1.weight_hh"],
            dec["res_rnn1.bias_ih"] + dec["res_rnn1.bias_hh"],
            dec["res_rnn2.weight_ih"], dec["res_rnn2.weight_hh"],
            dec["res_rnn2.bias_ih"] + dec["res_rnn2.bias_hh"],
            wm.transpose(0, 1).reshape(r * n_mels, L_))


def _windows(x):
    """(B, T) -> (B, T, 31): [b, t, k] = x[b, t + k - 15], zero outside."""
    return F.pad(x, (CONV_HALF, CONV_HALF)).unfold(-1, CONV_K, 1)


def _energy_args(cum, att, q, encp, W01):
    """tanh((loc + encp) + q), (B, T, D): the location conv of the
    cumulative and previous attention composed with L."""
    loc = (torch.einsum("btk,dk->btd", _windows(cum), W01[:, :CONV_K])
           + torch.einsum("btk,dk->btd", _windows(att), W01[:, CONV_K:]))
    return torch.tanh(loc + encp + q[:, None])


def _lstm(x, h, c, z, wi, wh, b):
    L = h.shape[-1]
    g = x @ wi.t() + h @ wh.t() + b
    i, f = torch.sigmoid(g[:, :L]), torch.sigmoid(g[:, L:2 * L])
    gg, o = torch.tanh(g[:, 2 * L:3 * L]), torch.sigmoid(g[:, 3 * L:])
    c = f * c + i * gg
    h = z * h + (1.0 - z) * (o * torch.tanh(c))
    return h, c, torch.cat([i, f, gg, o], dim=-1)


def core_ref(pre, zm1, zm2, enc, encp, awi, abi, awh, abh, wq, qb, W01, v,
             wr, br, l1wi, l1wh, l1b, l2wi, l2wh, l2b, wm,
             save: bool = False):
    """Plain forward, one group at a time (``pallas_taco_train.py:983-1055``
    in the batched layout): (mel (G, B, F), scores (G, B, T), streams), the
    streams a dict of ``STREAMS`` when ``save``, else None. Differentiable
    by autograd."""
    G, B, _ = pre.shape
    T, E = enc.shape[1], enc.shape[2]
    D, L = wq.shape[0], wr.shape[0]
    z = lambda *s: pre.new_zeros(s)
    ah, ctx = z(B, D), z(B, E)
    h1, c1, h2, c2 = z(B, L), z(B, L), z(B, L), z(B, L)
    cum, att = z(B, T), z(B, T)
    mels, scs = [], []
    st = {k: [] for k in STREAMS} if save else None
    for g in range(G):
        gi = torch.cat([ctx, pre[g]], dim=1) @ awi.t() + abi
        gh = ah @ awh.t() + abh
        r = torch.sigmoid(gi[:, :D] + gh[:, :D])
        zg = torch.sigmoid(gi[:, D:2 * D] + gh[:, D:2 * D])
        hn = gh[:, 2 * D:]
        n = torch.tanh(gi[:, 2 * D:] + r * hn)
        ah = (1.0 - zg) * n + zg * ah
        q = ah @ wq.t() + qb
        sig = torch.sigmoid(_energy_args(cum, att, q, encp, W01) @ v)
        div = sig.sum(dim=1)
        s = sig / torch.where(div > 0, div, torch.ones_like(div))[:, None]
        ctx = torch.einsum("bt,bte->be", s, enc)
        if save:
            st["cum"].append(cum)
            st["q"].append(q)
            st["div"].append(div)
            st["ah"].append(ah)
            st["gru"].append(torch.cat([r, zg, n, hn], dim=-1))
            st["ctx"].append(ctx)
        cum, att = cum + s, s
        x0 = torch.cat([ctx, ah], dim=1) @ wr.t() + br
        h1, c1, g1 = _lstm(x0, h1, c1, zm1[g], l1wi, l1wh, l1b)
        x1 = x0 + h1
        h2, c2, g2 = _lstm(x1, h2, c2, zm2[g], l2wi, l2wh, l2b)
        x2 = x1 + h2
        mels.append(x2 @ wm.t())
        scs.append(s)
        if save:
            for k, val in (("x0", x0), ("x1", x1), ("x2", x2), ("g1", g1),
                           ("g2", g2), ("c1", c1), ("h1", h1), ("c2", c2),
                           ("h2", h2)):
                st[k].append(val)
    streams = {k: torch.stack(v_) for k, v_ in st.items()} if save else None
    return torch.stack(mels), torch.stack(scs), streams


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


def core_bwd_ref(dmel, dsc, streams, scores, pre, zm1, zm2, enc, encp,
                 awi, abi, awh, abh, wq, qb, W01, v, wr, br, l1wi, l1wh, l1b,
                 l2wi, l2wh, l2b, wm):
    """Plain backward: the reverse sweep of the kernel, group by group, from
    the forward's streams. dmel (G, B, F), dsc (G, B, T) (the scores'
    cotangent, or None). Returns (dpre, denc, dencp, weight gradients in
    ``WEIGHTS`` order)."""
    G, B, P2 = pre.shape
    T, E = enc.shape[1], enc.shape[2]
    D, L = wq.shape[0], wr.shape[0]
    if dsc is None:
        dsc = scores.new_zeros(scores.shape)
    s_ = streams
    z = lambda *s: pre.new_zeros(s)
    dah, dctx = z(B, D), z(B, E)
    dh1, dc1, dh2, dc2 = z(B, L), z(B, L), z(B, L), z(B, L)
    dcum, datt = z(B, T), z(B, T)
    acc = {k: torch.zeros_like(w) for k, w in zip(WEIGHTS, (
        awi, abi, awh, abh, wq, qb, W01, v, wr, br, l1wi, l1wh, l1b, l2wi,
        l2wh, l2b, wm))}
    dpre = torch.empty_like(pre)
    denc, dencp = torch.zeros_like(enc), torch.zeros_like(encp)
    conv_w = torch.stack([W01[:, :CONV_K], W01[:, CONV_K:]], dim=1)

    def prev(name, g):
        return s_[name][g - 1] if g > 0 else torch.zeros_like(s_[name][0])

    for g in range(G - 1, -1, -1):
        x0, x1, x2 = s_["x0"][g], s_["x1"][g], s_["x2"][g]
        ah, ctx = s_["ah"][g], s_["ctx"][g]
        # mel_proj and the two LSTMCells
        dx2 = dmel[g] @ wm
        acc["wm"] += dmel[g].t() @ x2
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
        ds = dsc[g] + dcum + datt + torch.einsum("be,bte->bt", dctx_t, enc)
        denc += s[:, :, None] * dctx_t[:, None, :]
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
        dpre[g] = dinp[:, E:]
        dah = dah_t * zg + dgh @ awh
        acc["awi"] += dgi.t() @ torch.cat([prev("ctx", g), pre[g]], dim=1)
        acc["abi"] += dgi.sum(0)
        acc["awh"] += dgh.t() @ ah_p
        acc["abh"] += dgh.sum(0)
    return (dpre, denc, dencp) + tuple(acc[k] for k in WEIGHTS)


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


def _lib():
    lib = _build.load("taco_train")
    if not getattr(lib, "_typed", False):
        for fn in (lib.wr_taco_tf_fwd, lib.wr_taco_tf_bwd):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for fn in (lib.wr_taco_tf_fwd_work_floats,
                   lib.wr_taco_tf_bwd_work_floats, lib.wr_taco_tf_fwd_rows,
                   lib.wr_taco_tf_bwd_rows):
            fn.argtypes = [ctypes.c_void_p]
            fn.restype = ctypes.c_int64
        lib._typed = True
    return lib


def _dims(pre, enc, weights) -> Dict[str, int]:
    G, B, P2 = pre.shape
    d = dict(G=G, B=B, P2=P2, T=enc.shape[1], E=enc.shape[2],
             D=weights[4].shape[0], L=weights[8].shape[0],
             F=weights[16].shape[0])
    if any(d[k] % 4 for k in ("E", "D", "P2", "L", "F")):
        raise ValueError(f"the B6 kernels need E, D, P2, L and F divisible "
                         f"by 4, got {d}")
    return d


def _check_weights(weights, d, dev):
    D, E, P2, L, Fm = d["D"], d["E"], d["P2"], d["L"], d["F"]
    shapes = ((3 * D, E + P2), (3 * D,), (3 * D, D), (3 * D,), (D, D), (D,),
              (D, 2 * CONV_K), (D,), (L, E + D), (L,), (4 * L, L),
              (4 * L, L), (4 * L,), (4 * L, L), (4 * L, L), (4 * L,),
              (Fm, L))
    for name, w, shape in zip(WEIGHTS, weights, shapes):
        _build.check_operand(w, name, torch.float32, shape, dev)


def _run(fn, args, dev, what):
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"B6 {what} kernel launch failed: CUDA error {err}")


def _rows(fn, args, what):
    bc = fn(ctypes.byref(args))
    if bc < 1:
        raise ValueError(f"no B6 {what} launch fits these shapes in shared "
                         "memory")
    return bc


def decoder_tf_fwd(pre, zm1, zm2, enc, encp, weights, save: bool):
    """Forward over all groups: (mel (G, B, F), scores (G, B, T), streams
    or None). CPU: ``core_ref``; CUDA: the forward kernel."""
    if pre.device.type == "cpu":
        return core_ref(pre, zm1, zm2, enc, encp, *weights, save=save)
    if pre.device.type != "cuda":
        raise ValueError(f"no B6 kernel for {pre.device}")
    dev = pre.device
    f32 = torch.float32
    pre, zm1, zm2, enc, encp = (t.contiguous() for t in
                                (pre, zm1, zm2, enc, encp))
    weights = tuple(w.detach().contiguous() for w in weights)
    d = _dims(pre, enc, weights)
    G, B, T, E, D, P2, L, Fm = (d[k] for k in _DIMS)
    for t, name, shape in ((pre, "pre", (G, B, P2)), (zm1, "zm1", (G, B, L)),
                           (zm2, "zm2", (G, B, L)), (enc, "enc", (B, T, E)),
                           (encp, "encp", (B, T, D))):
        _build.check_operand(t, name, f32, shape, dev)
    _check_weights(weights, d, dev)
    w = dict(zip(WEIGHTS, weights))
    w01t = w["W01"].t().contiguous()
    mel = torch.empty(G, B, Fm, dtype=f32, device=dev)
    scores = torch.empty(G, B, T, dtype=f32, device=dev)
    widths = dict(cum=T, q=D, div=1, ah=D, gru=4 * D, ctx=E, x0=L, x1=L,
                  x2=L, g1=4 * L, g2=4 * L, c1=L, h1=L, c2=L, h2=L)
    streams = ({k: torch.empty(G, B, widths[k], dtype=f32, device=dev)
                for k in STREAMS} if save else None)
    ptrs = dict(pre=pre, zm1=zm1, zm2=zm2, enc=enc, encp=encp, w01t=w01t,
                mel=mel, scores=scores,
                **{k: w[k] for k in WEIGHTS if k != "W01"})
    args = _FwdArgs(**{k: v.data_ptr() for k, v in ptrs.items()}, **d,
                    save=int(save))
    if save:
        for k, t in streams.items():
            setattr(args, f"s_{k}", t.data_ptr())
    lib = _lib()
    args.bc = _rows(lib.wr_taco_tf_fwd_rows, args, "forward")
    work = torch.zeros(lib.wr_taco_tf_fwd_work_floats(ctypes.byref(args)),
                       dtype=f32, device=dev)
    args.work = work.data_ptr()
    _run(lib.wr_taco_tf_fwd, args, dev, "forward")
    decoder_tf.fwd_launches += 1
    if save:
        streams["div"] = streams["div"][..., 0]
    return mel, scores, streams


def decoder_tf_bwd(dmel, dsc, streams, scores, pre, zm1, zm2, enc, encp,
                   weights):
    """Backward over all groups: (dpre, denc, dencp, weight gradients in
    ``WEIGHTS`` order). CPU: ``core_bwd_ref``; CUDA: the backward kernel
    and its weight-gradient reductions."""
    if pre.device.type == "cpu":
        return core_bwd_ref(dmel, dsc, streams, scores, pre, zm1, zm2, enc,
                            encp, *weights)
    if pre.device.type != "cuda":
        raise ValueError(f"no B6 kernel for {pre.device}")
    dev = pre.device
    f32 = torch.float32
    weights = tuple(w.detach().contiguous() for w in weights)
    d = _dims(pre, enc, weights)
    G, B, T, E, D, P2, L, Fm = (d[k] for k in _DIMS)
    dmel = dmel.contiguous()
    dsc = (torch.zeros_like(scores) if dsc is None else dsc.contiguous())
    for t, name, shape in ((dmel, "dmel", (G, B, Fm)),
                           (dsc, "dsc", (G, B, T)),
                           (scores, "scores", (G, B, T))):
        _build.check_operand(t, name, f32, shape, dev)
    _check_weights(weights, d, dev)
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
    cw = dict(dgi=3 * D, dgh=3 * D, dq=D, dx0=L, dg1=4 * L, dg2=4 * L)
    for k in _COT:
        ptrs[f"c_{k}"] = torch.empty(G, B, cw[k], dtype=f32, device=dev)
    outs = dict(dpre=torch.empty_like(pre), denc=torch.zeros_like(enc),
                dencp=torch.zeros_like(encp),
                pw01=torch.zeros(B, 2 * CONV_K, D, dtype=f32, device=dev),
                pv=torch.zeros(B, D, dtype=f32, device=dev))
    for k, wt in zip(WEIGHTS, weights):
        outs["dw01" if k == "W01" else f"d{k}"] = torch.empty_like(wt)
    ptrs.update(outs)
    args = _BwdArgs(**{k: v.data_ptr() for k, v in ptrs.items()}, **d)
    lib = _lib()
    args.bc = _rows(lib.wr_taco_tf_bwd_rows, args, "backward")
    work = torch.zeros(lib.wr_taco_tf_bwd_work_floats(ctypes.byref(args)),
                       dtype=f32, device=dev)
    args.work = work.data_ptr()
    _run(lib.wr_taco_tf_bwd, args, dev, "backward")
    decoder_tf.bwd_launches += 1
    grads = tuple(outs["dw01" if k == "W01" else f"d{k}"] for k in WEIGHTS)
    return (outs["dpre"], outs["denc"], outs["dencp"]) + grads


class _DecoderTF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pre, zm1, zm2, enc, encp, *weights):
        mel, scores, streams = decoder_tf_fwd(pre, zm1, zm2, enc, encp,
                                              weights, save=True)
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
            dmel, dsc, streams, scores, pre, zm1, zm2, enc, encp, weights)
        return (dpre, None, None, denc, dencp, *dw)


def decoder_tf(pre, zm1, zm2, enc, encp, weights):
    """The recurrence as kernels, differentiable in pre, enc, encp and
    every weight: (mel (G, B, F), scores (G, B, T)). Without autograd (no
    input needs a gradient, or grad mode off: the eval-mode GTA and
    attention export) the forward writes no streams."""
    tensors = (pre, enc, encp) + tuple(weights)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _DecoderTF.apply(pre, zm1, zm2, enc, encp, *weights)
    mel, scores, _ = decoder_tf_fwd(pre, zm1, zm2, enc, encp, weights,
                                    save=False)
    return mel, scores


decoder_tf.fwd_launches = 0
decoder_tf.bwd_launches = 0


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
