"""Tacotron free-running decode: the CUDA kernels' wrappers and their plain
PyTorch versions.

Two kernels of ``csrc/taco_decode.cu`` run all ``steps // r`` decoder
groups in one cooperative launch, including the stop test, the state
freeze and the replay of the frozen group:

- B2, ``decode``: one utterance; port of
  ``wavernn_tpu/ops/pallas_taco.py::decode_pallas`` (``_make_kernel``).
- B8, ``decode_batch``: B utterances of right-padded text with a text mask
  and a stop and freeze per row; port of ``decode_pallas_batch``
  (``_make_batch_kernel``, B <= 8) and ``decode_pallas_stacked``
  (``_make_stacked_kernel``, B > 8), one kernel for every B.

``decode_batch_ref`` is the plain version of both, one
``models.tacotron.decoder_step`` per group; ``decode_ref`` is its one-row
case. Each wrapper runs the plain version for CPU tensors and launches its
kernel for CUDA tensors; it never falls back from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build


def decode_ref(dec, encoder_seq, encoder_seq_proj, text_mask, r: int,
               steps: int, n_mels: int, max_r: int, stop_threshold: float):
    """Plain free-running decode of one utterance: ``decode_batch_ref`` of
    one row. encoder_seq (1, T, E), encoder_seq_proj (1, T, D), text_mask
    (T,). Returns (mel (1, n_mels, steps), attn (1, steps // r, T),
    n_valid (1,) int32)."""
    return decode_batch_ref(dec, encoder_seq, encoder_seq_proj,
                            text_mask[None], r, steps, n_mels, max_r,
                            stop_threshold)


def decode_batch_ref(dec, encoder_seq, encoder_seq_proj, text_mask, r: int,
                     steps: int, n_mels: int, max_r: int,
                     stop_threshold: float):
    """Plain free-running decode of B utterances of right-padded text.

    dec: decoder weights by state-dict name (``Tacotron.decoder_weights``);
    encoder_seq (B, T, E), encoder_seq_proj (B, T, D), text_mask (B, T): 1 on
    a row's text, 0 on its padding (the smooth attention's normalisation
    skips the padding). A group stops its row when all the row's values are
    below ``stop_threshold`` and g*r > 10; the row's state then stays
    frozen, so its later groups all emit the output of its first
    frozen-state step. Once every row has stopped, that group repeats.
    Returns (mel (B, n_mels, steps), attn (B, steps // r, T), n_valid (B,)
    int32: each row's groups up to and including its trigger)."""
    from ..models.tacotron import DecoderState, decoder_step, \
        init_decoder_state

    n_groups = steps // r
    B, T, _ = encoder_seq.shape
    dev = encoder_seq.device
    state = init_decoder_state(dec, B, T, n_mels, dev)
    stopped = torch.zeros(B, dtype=torch.bool, device=dev)
    n_valid = torch.zeros(B, dtype=torch.int32, device=dev)
    held = None
    mels_out, attn_out = [], []
    for g in range(n_groups):
        if held is None:
            mels, scores, new = decoder_step(
                dec, encoder_seq, encoder_seq_proj, state.prev_frame, state,
                r, n_mels, max_r, text_mask)
            if bool(stopped.all()):
                held = (mels, scores)   # every row's frozen output, for good
            n_valid += (~stopped).int()
            state = DecoderState(*(
                torch.where(stopped.reshape((-1,) + (1,) * (n.dim() - 1)),
                            o, n) for o, n in zip(state, new)))
            stopped = stopped | ((mels < stop_threshold).flatten(1).all(1)
                                 & (g * r > 10))
        else:
            mels, scores = held
        mels_out.append(mels)
        attn_out.append(scores)
    mel = torch.stack(mels_out, dim=2).reshape(B, n_mels, n_groups * r)
    return mel, torch.stack(attn_out, dim=1), n_valid


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


def _args_struct(name: str, ints):
    return type(name, (ctypes.Structure,), {"_fields_": (
        [("enc", ctypes.c_void_p), ("encp", ctypes.c_void_p),
         ("mask", ctypes.c_void_p)]
        + [(f, ctypes.c_void_p) for f in _FIELDS]
        + [("mel_out", ctypes.c_void_p), ("att_out", ctypes.c_void_p),
           ("n_valid", ctypes.c_void_p), ("work", ctypes.c_void_p)]
        + [(f, ctypes.c_int64) for f in ints]
        + [("stop_threshold", ctypes.c_double)])})


# DecodeArgs (B2) and BatchArgs (B8) of csrc/taco_decode.cu, field for field
_DecodeArgs = _args_struct("_DecodeArgs", ("T", "E", "D", "P1", "P2", "L",
                                           "n_mels", "r", "n_groups"))
_BatchArgs = _args_struct("_BatchArgs", ("B", "T", "E", "D", "P1", "P2", "L",
                                         "n_mels", "r", "n_groups"))


def _lib():
    lib = _build.load("taco_decode")
    if not getattr(lib, "_typed", False):
        for fn in (lib.wr_taco_decode, lib.wr_taco_decode_batch):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for fn in (lib.wr_taco_decode_work_floats,
                   lib.wr_taco_decode_batch_work_floats,
                   lib.wr_taco_decode_batch_shared_bytes):
            fn.argtypes = [ctypes.c_void_p]
            fn.restype = ctypes.c_int64
        lib._typed = True
    return lib


def _check_widths(dec, E: int, r: int, n_mels: int, max_r: int):
    """The decoder widths both kernels take: (D, P1, P2, L)."""
    D = dec["attn_rnn.weight_hh"].shape[1]
    P1 = dec["prenet.fc1.weight"].shape[0]
    P2 = dec["prenet.fc2.weight"].shape[0]
    L_ = dec["res_rnn1.weight_hh"].shape[1]
    if any(n % 4 for n in (E, D, P1, P2, L_, n_mels)) or D % 32:
        raise ValueError("the decode kernel needs every width divisible by "
                         "4 and decoder_dims by 32")
    if not 1 <= r <= max_r:
        raise ValueError(f"r={r} outside [1, max_r={max_r}]")
    return D, P1, P2, L_


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
    D, P1, P2, L_ = _check_widths(dec, E, r, n_mels, max_r)
    n_groups = steps // r
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
    _launch(lib.wr_taco_decode, args, dev, "decode")
    decode.launches += 1
    mel = mel_out.reshape(n_groups, r, n_mels).permute(2, 0, 1)
    mel = mel.reshape(1, n_mels, n_groups * r)
    return mel, att_out[None], n_valid


decode.launches = 0


def _launch(fn, args, dev, what: str):
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


# the most shared memory the batched kernel's launch may ask for: a batch
# whose rows' (T_text + decoder_dims) planes would need more is split into
# launches that fit (the H100's 227 KB a block, less headroom)
SHARED_LIMIT = 200 * 1024


def decode_batch(dec, encoder_seq, encoder_seq_proj, text_mask, r: int,
                 steps: int, n_mels: int, max_r: int, stop_threshold: float):
    """Free-running decode of B utterances, ``decode_batch_ref``'s contract.

    CPU tensors run the plain version; CUDA tensors launch the batched
    kernel. Its shared memory and workspace grow with B * T_text: a batch
    past ``SHARED_LIMIT`` runs as consecutive launches of as many rows as
    fit, each the same function of its rows."""
    if encoder_seq.device.type == "cpu":
        return decode_batch_ref(dec, encoder_seq, encoder_seq_proj,
                                text_mask, r, steps, n_mels, max_r,
                                stop_threshold)
    if encoder_seq.device.type != "cuda":
        raise ValueError(f"no decode kernel for {encoder_seq.device}")
    dev = encoder_seq.device
    B, T, E = encoder_seq.shape
    D, P1, P2, L_ = _check_widths(dec, E, r, n_mels, max_r)
    n_groups = steps // r
    f32 = torch.float32
    enc = encoder_seq.contiguous()
    encp = encoder_seq_proj.contiguous()
    mask = text_mask.to(f32).contiguous()
    _build.check_operand(enc, "encoder_seq", f32, (B, T, E), dev)
    _build.check_operand(encp, "encoder_seq_proj", f32, (B, T, D), dev)
    _build.check_operand(mask, "text_mask", f32, (B, T), dev)
    w = _build.prepared("taco_decode", dec, (r, n_mels, max_r),
                        lambda: kernel_weights(dec, r, n_mels, max_r))
    for k in _FIELDS:
        _build.check_operand(w[k], k, f32, w[k].shape, dev)
    rows = batch_rows(B, T, D)
    if rows < 1:
        raise ValueError(f"T_text {T} needs more shared memory than one "
                         "launch may ask for")
    F = r * n_mels
    mel_out = torch.empty(B, n_groups, F, dtype=f32, device=dev)
    att_out = torch.empty(B, n_groups, T, dtype=f32, device=dev)
    n_valid = torch.empty(B, dtype=torch.int32, device=dev)
    lib = _lib()
    for b0 in range(0, B, rows):
        b1 = min(B, b0 + rows)
        args = _BatchArgs(
            enc=enc[b0].data_ptr(), encp=encp[b0].data_ptr(),
            mask=mask[b0].data_ptr(), mel_out=mel_out[b0].data_ptr(),
            att_out=att_out[b0].data_ptr(), n_valid=n_valid[b0:].data_ptr(),
            B=b1 - b0, T=T, E=E, D=D, P1=P1, P2=P2, L=L_, n_mels=n_mels, r=r,
            n_groups=n_groups, stop_threshold=float(stop_threshold),
            **{k: w[k].data_ptr() for k in _FIELDS})
        work = torch.zeros(lib.wr_taco_decode_batch_work_floats(
            ctypes.byref(args)), dtype=f32, device=dev)
        args.work = work.data_ptr()
        _launch(lib.wr_taco_decode_batch, args, dev, "batched decode")
        decode_batch.launches += 1
    mel = mel_out.reshape(B, n_groups, r, n_mels).permute(0, 3, 1, 2)
    return mel.reshape(B, n_mels, n_groups * r), att_out, n_valid


decode_batch.launches = 0


def batch_rows(B: int, T: int, D: int) -> int:
    """The most rows of a batch one launch of the batched kernel takes
    (its shared memory, ``batch_shared_bytes`` in the source, within
    ``SHARED_LIMIT``)."""
    fixed = 4 * (32 * 2 * 31 + 32 * D + D)
    per_row = 4 * (D + 2 * T + 1) + 4 * 5
    return min(B, (SHARED_LIMIT - fixed) // per_row)
