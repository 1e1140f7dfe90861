"""Tacotron free-running decode: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``wavernn_tpu/ops/pallas_taco.py::decode_pallas`` (the
``_make_kernel`` TPU kernel). The kernel (``csrc/taco_decode.cu``) runs all
``steps // r`` decoder groups of one utterance in one cooperative launch,
including the stop test, the state freeze and the replay of the frozen
group. ``decode_ref`` is the same function in plain PyTorch, one
``models.tacotron.decoder_step`` per group.

``decode`` runs the plain version for CPU tensors and launches the kernel
for CUDA tensors; it never falls back from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build


def decode_ref(dec, encoder_seq, encoder_seq_proj, text_mask, r: int,
               steps: int, n_mels: int, max_r: int, stop_threshold: float):
    """Plain free-running decode of one utterance.

    dec: decoder weights by state-dict name (``Tacotron.decoder_weights``);
    encoder_seq (1, T, E), encoder_seq_proj (1, T, D), text_mask (T,).
    A group stops the utterance when all its values are below
    ``stop_threshold`` and g*r > 10; later groups keep the state frozen, so
    they all emit the output of the first frozen-state step.
    Returns (mel (1, n_mels, steps), attn (1, steps // r, T),
    n_valid (1,) int32: the groups up to and including the trigger)."""
    from ..models.tacotron import decoder_step, init_decoder_state

    n_groups = steps // r
    T = encoder_seq.shape[1]
    state = init_decoder_state(dec, 1, T, n_mels, encoder_seq.device)
    mask = text_mask[None]
    stopped, held = False, None
    mels_out, attn_out, n_valid = [], [], 0
    for g in range(n_groups):
        if held is None:
            mels, scores, new_state = decoder_step(
                dec, encoder_seq, encoder_seq_proj, state.prev_frame, state,
                r, n_mels, max_r, mask)
            if stopped:
                held = (mels, scores)   # the frozen state's output, for good
            else:
                n_valid += 1
                stopped = bool((mels < stop_threshold).all()) and g * r > 10
                state = new_state
        else:
            mels, scores = held
        mels_out.append(mels)
        attn_out.append(scores)
    mel = torch.stack(mels_out, dim=2).reshape(1, n_mels, n_groups * r)
    attn = torch.stack(attn_out, dim=1)
    return mel, attn, torch.tensor([n_valid], dtype=torch.int32,
                                   device=encoder_seq.device)


_FIELDS = ("w1p", "b1p", "w2p", "b2p", "awi", "abi", "awh", "abh", "wq", "qb",
           "conv", "lw", "v", "wr", "br", "l1wi", "l1wh", "l1b", "l2wi",
           "l2wh", "l2b", "wm")


def kernel_weights(dec, r: int, n_mels: int, max_r: int):
    """The kernel's float32 weight operands. mel_proj keeps the rows of the
    r frames, reordered frame-major (reference reshape (n_mels, max_r) then
    [:, :r], tacotron.py:267-268); the LSTM biases are summed."""
    L_ = dec["res_rnn1.weight_hh"].shape[1]
    wm = dec["mel_proj.weight"].reshape(n_mels, max_r, L_)[:, :r]
    parts = {
        "w1p": dec["prenet.fc1.weight"], "b1p": dec["prenet.fc1.bias"],
        "w2p": dec["prenet.fc2.weight"], "b2p": dec["prenet.fc2.bias"],
        "awi": dec["attn_rnn.weight_ih"], "abi": dec["attn_rnn.bias_ih"],
        "awh": dec["attn_rnn.weight_hh"], "abh": dec["attn_rnn.bias_hh"],
        "wq": dec["attn_net.W.weight"],
        "qb": dec["attn_net.W.bias"] + dec["attn_net.L.bias"],
        "conv": dec["attn_net.conv.weight"], "lw": dec["attn_net.L.weight"],
        "v": dec["attn_net.v.weight"][0],
        "wr": dec["rnn_input.weight"], "br": dec["rnn_input.bias"],
        "l1wi": dec["res_rnn1.weight_ih"], "l1wh": dec["res_rnn1.weight_hh"],
        "l1b": dec["res_rnn1.bias_ih"] + dec["res_rnn1.bias_hh"],
        "l2wi": dec["res_rnn2.weight_ih"], "l2wh": dec["res_rnn2.weight_hh"],
        "l2b": dec["res_rnn2.bias_ih"] + dec["res_rnn2.bias_hh"],
        "wm": wm.transpose(0, 1).reshape(r * n_mels, L_),
    }
    return {k: v.detach().to(torch.float32).contiguous()
            for k, v in parts.items()}


class _DecodeArgs(ctypes.Structure):
    _fields_ = ([("enc", ctypes.c_void_p), ("encp", ctypes.c_void_p),
                 ("mask", ctypes.c_void_p)]
                + [(f, ctypes.c_void_p) for f in _FIELDS]
                + [("mel_out", ctypes.c_void_p), ("att_out", ctypes.c_void_p),
                   ("n_valid", ctypes.c_void_p), ("work", ctypes.c_void_p)]
                + [(f, ctypes.c_int64) for f in
                   ("T", "E", "D", "P1", "P2", "L", "n_mels", "r",
                    "n_groups")]
                + [("stop_threshold", ctypes.c_double)])


def _lib():
    lib = _build.load("taco_decode")
    if not getattr(lib, "_typed", False):
        lib.wr_taco_decode.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.wr_taco_decode.restype = ctypes.c_int
        lib.wr_taco_decode_work_floats.argtypes = [ctypes.c_void_p]
        lib.wr_taco_decode_work_floats.restype = ctypes.c_int64
        lib._typed = True
    return lib


def decode(dec, encoder_seq, encoder_seq_proj, text_mask, r: int, steps: int,
           n_mels: int, max_r: int, stop_threshold: float):
    """Free-running decode of one utterance, ``decode_ref``'s contract.

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    operands prepared once per weight set and r (``_build.prepared``)."""
    if encoder_seq.device.type == "cpu":
        return decode_ref(dec, encoder_seq, encoder_seq_proj, text_mask, r,
                          steps, n_mels, max_r, stop_threshold)
    if encoder_seq.device.type != "cuda":
        raise ValueError(f"no decode kernel for {encoder_seq.device}")
    dev = encoder_seq.device
    _, T, E = encoder_seq.shape
    D = dec["attn_rnn.weight_hh"].shape[1]
    P1 = dec["prenet.fc1.weight"].shape[0]
    P2 = dec["prenet.fc2.weight"].shape[0]
    L_ = dec["res_rnn1.weight_hh"].shape[1]
    n_groups = steps // r
    if any(n % 4 for n in (E, D, P1, P2, L_, n_mels)) or D % 32:
        raise ValueError("the decode kernel needs every width divisible by "
                         "4 and decoder_dims by 32")
    if not 1 <= r <= max_r:
        raise ValueError(f"r={r} outside [1, max_r={max_r}]")
    enc = encoder_seq[0].contiguous()
    encp = encoder_seq_proj[0].contiguous()
    f32 = torch.float32
    _build.check_operand(enc, "encoder_seq", f32, (T, E), dev)
    _build.check_operand(encp, "encoder_seq_proj", f32, (T, D), dev)
    _build.check_operand(text_mask, "text_mask", f32, (T,), dev)
    w = _build.prepared("taco_decode", dec, (r, n_mels, max_r),
                        lambda: kernel_weights(dec, r, n_mels, max_r))
    for k in _FIELDS:
        _build.check_operand(w[k], k, f32, w[k].shape, dev)
    F = r * n_mels
    mel_out = torch.empty(n_groups, F, dtype=torch.float32, device=dev)
    att_out = torch.empty(n_groups, T, dtype=torch.float32, device=dev)
    n_valid = torch.empty(1, dtype=torch.int32, device=dev)
    args = _DecodeArgs(
        enc=enc.data_ptr(), encp=encp.data_ptr(), mask=text_mask.data_ptr(),
        mel_out=mel_out.data_ptr(), att_out=att_out.data_ptr(),
        n_valid=n_valid.data_ptr(), T=T, E=E, D=D, P1=P1, P2=P2, L=L_,
        n_mels=n_mels, r=r, n_groups=n_groups,
        stop_threshold=float(stop_threshold),
        **{k: w[k].data_ptr() for k in _FIELDS})
    lib = _lib()
    work = torch.zeros(lib.wr_taco_decode_work_floats(ctypes.byref(args)),
                       dtype=torch.float32, device=dev)
    args.work = work.data_ptr()
    with torch.cuda.device(dev):
        err = lib.wr_taco_decode(ctypes.byref(args),
                                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"decode kernel launch failed: CUDA error {err}")
    decode.launches += 1
    mel = mel_out.reshape(n_groups, r, n_mels).permute(2, 0, 1)
    mel = mel.reshape(1, n_mels, n_groups * r)
    return mel, att_out[None], n_valid


decode.launches = 0
